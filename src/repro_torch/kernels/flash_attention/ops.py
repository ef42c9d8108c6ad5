"""Public flash attention in the model layout: dispatch on the tensor's
device.

A CUDA tensor goes to the hand-written kernel
(:func:`.kernel.flash_attention_cuda`) or raises; a CPU tensor goes to
the plain PyTorch version (:mod:`.ref`).  There is no other route and no
fallback.  Both refuse causal attention with Sq != Skv."""
from __future__ import annotations

import torch

from .kernel import check_shapes, flash_attention_cuda
from .ref import attention_ref


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0) -> torch.Tensor:
    """q (B, Sq, Hq, hd); k/v (B, Skv, Hkv, hd) -> (B, Sq, Hq, hd)."""
    if q.device.type == "cuda":
        return flash_attention_cuda(q, k, v, causal=causal, window=window)
    if q.device.type == "cpu":
        check_shapes(q, k, v, causal, window)
        return attention_ref(q, k, v, causal=causal, window=window)
    raise ValueError(f"flash attention: unsupported device {q.device}")
