"""Int8 block quantization of gradients, for the cross-pod all-reduce.

The port of the JAX package's ``repro/runtime/compression.py``:
``quantize_int8`` / ``dequantize_int8`` with one float32 scale per
block of 256 values.  ``compressed_pod_mean`` (the error-feedback mean
over a ``pod`` mesh axis) waits for the mesh."""
from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

BLOCK = 256


def quantize_int8(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: any shape -> (codes int8 (nblocks, 256), scales (nblocks,)
    float32): ``max|block| / 127`` floored at 1e-12, codes rounded half to
    even and clipped to [-127, 127], the flattened x zero-padded to whole
    blocks.  The division by 127 is a true float32 division on either
    device (a tensor divisor: CUDA divides by a Python scalar through its
    reciprocal)."""
    flat = x.float().reshape(-1)
    flat = F.pad(flat, (0, (-flat.numel()) % BLOCK))
    blocks = flat.reshape(-1, BLOCK)
    d = torch.full((), 127.0, dtype=torch.float32, device=blocks.device)
    scale = torch.clamp(blocks.abs().amax(dim=1, keepdim=True) / d,
                        min=1e-12)
    q = torch.clamp(torch.round(blocks / scale), -127, 127)
    return q.to(torch.int8), scale[:, 0]


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor, shape,
                    dtype=torch.float32) -> torch.Tensor:
    """The inverse of :func:`quantize_int8`, cut back to ``shape``."""
    out = (q.float() * scale[:, None]).reshape(-1)
    size = 1
    for s in shape:
        size *= s
    return out[:size].reshape(shape).to(dtype)


def compressed_pod_mean(env, grads, errors):
    """The int8, error-feedback mean of gradients over a ``pod`` mesh
    axis: it needs the mesh."""
    raise NotImplementedError("compressed_pod_mean waits for ROADMAP item "
                              "8 (the mesh)")
