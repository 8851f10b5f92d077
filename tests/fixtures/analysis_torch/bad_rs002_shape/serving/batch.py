"""BAD: a device shape taken from a Python value (RS002)."""
import torch


def form_batch(rows, device):
    out = torch.zeros(len(rows), dtype=torch.int64, device=device)
    out[:] = torch.as_tensor(rows, device=device)
    return out
