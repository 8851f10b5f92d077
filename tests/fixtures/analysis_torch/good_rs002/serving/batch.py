"""GOOD: batch shapes come from the bucket ladder."""
import torch
import torch.nn.functional as F

from . import buckets as bk


def form_batch(rows, ladder, device):
    bucket = bk.bucket_for(len(rows), ladder)
    out = torch.zeros(bucket, dtype=torch.int64, device=device)
    out[: len(rows)] = torch.as_tensor(rows, device=device)
    return out


def pad_batch(rows, ladder):
    bucket = bk.bucket_for(len(rows), ladder)
    return F.pad(rows, (0, bucket - len(rows)))
