"""Device resolution for the port's entry points.

Every entry point (``Session``, ``MCSAPlanner``) takes ``device=None``,
which means the card.  There is no fallback: asking for CUDA on a
machine without it raises, so a run that was meant for the GPU can never
silently measure the CPU.  Callers that want the plain PyTorch path pass
``device="cpu"`` (the CPU tests do).
"""
from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` -> ``cuda``; anything else through ``torch.device``.
    Raises when the resolved device is CUDA and CUDA is unavailable."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {dev} requested (None resolves to 'cuda') but "
            "torch.cuda.is_available() is False; pass device='cpu' for "
            "the plain PyTorch path")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}: 'cuda' or 'cpu'")
    return dev
