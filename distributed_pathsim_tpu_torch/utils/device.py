"""Device resolution: the port runs on CUDA unless the caller asks for
the CPU, and never carries on quietly on the host."""

from __future__ import annotations

import torch


class DeviceUnavailable(RuntimeError):
    """CUDA was asked for (explicitly or by default) and no CUDA device
    exists."""


def resolve_device(device=None) -> torch.device:
    """``None`` means CUDA. Raises :class:`DeviceUnavailable` when the
    resolved device is CUDA and torch sees no CUDA device."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise DeviceUnavailable(
            "no CUDA device is available; pass device='cpu' "
            "(CLI: --platform cpu) to run on the host"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}; use 'cuda' or 'cpu'")
    return dev
