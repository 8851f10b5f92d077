"""BAD: raw pad to the natural batch size (RS002)."""
import torch.nn.functional as F


def form_batch(rows):
    return F.pad(rows, (0, 32 - len(rows)))
