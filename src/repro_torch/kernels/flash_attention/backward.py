"""ctypes wrapper of the CUDA flash-attention backward
(``csrc/flash_attention_bwd.cu``).

The library is built by :mod:`repro_torch.kernels._build` at the first
launch, never at import.  :func:`flash_attention_bwd_cuda` checks its
inputs, allocates dq, dk, dv and the (B, Hq, Sq) float32 LSE and D
scratch with ``torch.empty``, launches the three kernels on the current
stream without synchronising, and raises if a launch was refused.
``LAUNCHES["flash_attention_bwd"]`` counts each successful call (its
three launches once), nowhere else.
"""
from __future__ import annotations

import ctypes
import functools
from pathlib import Path

import torch

from repro_torch.kernels import _build
from .kernel import check_shapes

SOURCE = Path(__file__).resolve().parent / "csrc" / "flash_attention_bwd.cu"
LIB_NAME = "mcsa_flash_attention_bwd"
FLAGS = _build.NVCC_FLAGS

#: successful calls since the last reset (callers may zero it)
LAUNCHES = {"flash_attention_bwd": 0}

DTYPES = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIMS = (32, 64, 128)
#: where the shapes this kernel refuses are queued
DEFERRED = ("ROADMAP item 7c (the backward kernels' redesign: wgmma, TMA "
            "and head_dim 256)")


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    """Build (first call) and load the attention backward library."""
    lib = _build.load(LIB_NAME, SOURCE, FLAGS)
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.mcsa_attention_bwd_launch.argtypes = [
        p, p, p, p, p, p, p, p, p, p, i, i, i, i, i, i, ctypes.c_float, i, i,
        i, p]
    lib.mcsa_attention_bwd_launch.restype = ctypes.c_int
    lib.mcsa_cuda_error_string.argtypes = [ctypes.c_int]
    lib.mcsa_cuda_error_string.restype = ctypes.c_char_p
    return lib


def flash_attention_bwd_cuda(q: torch.Tensor, k: torch.Tensor,
                             v: torch.Tensor, out: torch.Tensor,
                             dout: torch.Tensor, *, causal: bool = True,
                             window: int = 0) -> tuple:
    """q, out, dout (B, Sq, Hq, hd), k/v (B, Skv, Hkv, hd), one dtype
    (float32 or bfloat16), contiguous and 16-byte aligned, on one CUDA
    device, ``out`` the forward's output for (q, k, v) -> (dq, dk, dv) in
    that dtype.  hd 32, 64 or 128; any other raises."""
    for name, t in (("q", q), ("k", k), ("v", v), ("out", out),
                    ("dout", dout)):
        if not torch.is_tensor(t):
            raise TypeError(f"{name}: expected a tensor")
        if t.device.type != "cuda" or t.device != q.device:
            raise ValueError(f"{name}: on {t.device}, expected q's CUDA "
                             f"device ({q.device})")
        if t.dtype not in DTYPES or t.dtype != q.dtype:
            raise TypeError(f"{name}: dtype {t.dtype}, expected float32 or "
                            "bfloat16, the same for all five")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name}: not contiguous or not 16-byte "
                             "aligned")
    check_shapes(q, k, v, causal, window)
    if out.shape != q.shape or dout.shape != q.shape:
        raise ValueError(f"attention backward: out {tuple(out.shape)} and "
                         f"dout {tuple(dout.shape)} must have q's shape "
                         f"{tuple(q.shape)}")
    B, Sq, Hq, hd = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    if hd not in HEAD_DIMS:
        raise ValueError(f"attention backward: head_dim {hd}; the kernel "
                         f"takes {HEAD_DIMS}, the rest waits for {DEFERRED}")
    dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
    if q.numel() == 0 or k.numel() == 0:
        return dq.zero_(), dk.zero_(), dv.zero_()
    stats = torch.empty((2, B, Hq, Sq), dtype=torch.float32, device=q.device)
    lib = library()
    stream = torch._C._cuda_getCurrentRawStream(q.device.index)
    rc = lib.mcsa_attention_bwd_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        dout.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
        stats[0].data_ptr(), stats[1].data_ptr(), B, Sq, Skv, Hq, Hkv, hd,
        float(hd ** -0.5), int(bool(causal)), int(window), DTYPES[q.dtype],
        stream)
    if rc != 0:
        msg = lib.mcsa_cuda_error_string(rc).decode()
        raise RuntimeError(f"attention backward launch failed: {msg} ({rc})")
    LAUNCHES["flash_attention_bwd"] += 1
    return dq, dk, dv
