"""ctypes wrapper of the CUDA WKV6 kernel (``csrc/wkv6.cu``).

The library is built by :mod:`repro_torch.kernels._build` at the first
launch, never at import.  :func:`wkv6_cuda` checks its inputs, allocates
what the caller did not give with ``torch.empty``, launches on the
current stream without synchronising, and raises if the launch was
refused.  ``LAUNCHES`` counts successful launches, nowhere else.
"""
from __future__ import annotations

import ctypes
import functools
from pathlib import Path
from typing import Optional, Tuple

import torch

from repro_torch.kernels import _build

SOURCE = Path(__file__).resolve().parent / "csrc" / "wkv6.cu"
LIB_NAME = "mcsa_wkv6"
FLAGS = _build.NVCC_FLAGS

#: launches since the last reset (callers may zero it)
LAUNCHES = {"wkv6": 0}

DTYPES = {torch.float32: 0, torch.bfloat16: 1}
HEAD_SIZES = (32, 64)


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    """Build (first call) and load the WKV6 library, with argtypes."""
    lib = _build.load(LIB_NAME, SOURCE, FLAGS)
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.mcsa_wkv6_launch.argtypes = [p, p, p, p, p, p, p, p, i, i, i, i, i, p]
    lib.mcsa_wkv6_launch.restype = ctypes.c_int
    lib.mcsa_cuda_error_string.argtypes = [ctypes.c_int]
    lib.mcsa_cuda_error_string.restype = ctypes.c_char_p
    return lib


def check_shapes(r, k, v, w, u, s0=None, state_out=None) -> None:
    """Raise unless r, k, v, w are (B, S, H, n), u (H, n) and the states
    (B, H, n, n)."""
    if r.dim() != 4:
        raise ValueError(f"wkv6: r {tuple(r.shape)}, expected (B, S, H, n)")
    B, S, H, n = r.shape
    for name, t in (("k", k), ("v", v), ("w", w)):
        if t.shape != r.shape:
            raise ValueError(f"wkv6: {name} {tuple(t.shape)} != r "
                             f"{tuple(r.shape)}")
    if tuple(u.shape) != (H, n):
        raise ValueError(f"wkv6: u {tuple(u.shape)}, expected {(H, n)}")
    for name, t in (("s0", s0), ("state_out", state_out)):
        if t is not None and tuple(t.shape) != (B, H, n, n):
            raise ValueError(f"wkv6: {name} {tuple(t.shape)}, expected "
                             f"{(B, H, n, n)}")


def wkv6_cuda(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              w: torch.Tensor, u: torch.Tensor,
              s0: Optional[torch.Tensor] = None,
              state_out: Optional[torch.Tensor] = None
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """r, k, v (B, S, H, n) in one dtype (float32 or bfloat16); w
    (B, S, H, n), u (H, n), s0 (B, H, n, n) or None, all float32; n 32 or
    64; contiguous, on one CUDA device.  Returns (y (B, S, H, n) float32,
    the final state): written into ``state_out`` (float32, may be ``s0``
    itself) when given, else into a new tensor."""
    if not torch.is_tensor(r) or r.dtype not in DTYPES:
        raise TypeError("r: expected a float32 or bfloat16 tensor")
    for name, t, dtype in (("r", r, r.dtype), ("k", k, r.dtype),
                           ("v", v, r.dtype), ("w", w, torch.float32),
                           ("u", u, torch.float32),
                           ("s0", s0, torch.float32),
                           ("state_out", state_out, torch.float32)):
        if t is None and name in ("s0", "state_out"):
            continue
        if not torch.is_tensor(t):
            raise TypeError(f"{name}: expected a tensor")
        if t.device.type != "cuda" or t.device != r.device:
            raise ValueError(f"{name}: on {t.device}, expected r's CUDA "
                             f"device ({r.device})")
        if t.dtype != dtype:
            raise TypeError(f"{name}: dtype {t.dtype}, expected {dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: not contiguous")
    check_shapes(r, k, v, w, u, s0, state_out)
    B, S, H, n = r.shape
    if n not in HEAD_SIZES:
        raise ValueError(f"wkv6: head size {n}, expected one of "
                         f"{HEAD_SIZES}")
    y = torch.empty(r.shape, dtype=torch.float32, device=r.device)
    s_final = (state_out if state_out is not None else
               torch.empty((B, H, n, n), dtype=torch.float32,
                           device=r.device))
    if B == 0 or H == 0:
        return y, s_final
    lib = library()
    stream = torch.cuda.current_stream(r.device).cuda_stream
    rc = lib.mcsa_wkv6_launch(
        r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(),
        u.data_ptr(), None if s0 is None else s0.data_ptr(), y.data_ptr(),
        s_final.data_ptr(), B, S, H, n, DTYPES[r.dtype], stream)
    if rc != 0:
        msg = lib.mcsa_cuda_error_string(rc).decode()
        raise RuntimeError(f"wkv6 kernel launch failed: {msg} ({rc})")
    LAUNCHES["wkv6"] += 1
    return y, s_final
