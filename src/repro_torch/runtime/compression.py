"""Int8 block quantization of gradients, for the cross-pod all-reduce.

The port of the JAX package's ``repro/runtime/compression.py``:
``quantize_int8`` / ``dequantize_int8`` with one float32 scale per
block of 256 values, and ``compressed_pod_mean``, the error-feedback
mean over a ``pod`` mesh axis:

    q = quantize_int8(g_local + error)
    g_hat = mean over pods of dequantize(every pod's q)   # int8 on the wire
    error' = (g_local + error) - dequantize(q)
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from repro_torch._tree import leaves, unflatten

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
    """Mean gradients across the pod axis with int8 + error feedback.

    grads/errors: trees of this rank's pod-local gradients and its
    float32 error carried from the last call.  Each rank's codes and
    scales go to every pod rank (one ``all_gather`` each), and the mean
    is summed in pod order, as the reference sums its all-gather.
    Returns (mean_grads, new_errors); the identity when the mesh has no
    ``pod`` axis."""
    if env is None or not env.is_spmd or "pod" not in env.shape:
        return grads, errors
    npods = env.shape["pod"]

    def leaf_fn(g, e):
        shape, dtype = g.shape, g.dtype
        corrected = g.float() + e
        q, scale = quantize_int8(corrected)
        new_e = corrected - dequantize_int8(q, scale, shape)
        total = torch.zeros(shape, dtype=torch.float32, device=g.device)
        for qp, sp in zip(env.gather_parts(q, "pod"),
                          env.gather_parts(scale, "pod")):
            total = total + dequantize_int8(qp, sp, shape)
        return (total / npods).to(dtype), new_e

    out = [leaf_fn(g, e) for g, e in zip(leaves(grads), leaves(errors))]
    return (unflatten(grads, [o[0] for o in out]),
            unflatten(grads, [o[1] for o in out]))
