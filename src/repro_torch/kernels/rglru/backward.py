"""ctypes wrapper of the CUDA RG-LRU scan backward
(``csrc/rglru_scan_bwd.cu``).

The library is built by :mod:`repro_torch.kernels._build` at the first
launch, never at import.  :func:`rglru_scan_bwd_cuda` checks its inputs,
allocates da and db with ``torch.empty``, launches on the current stream
without synchronising, and raises if the launch was refused.
``LAUNCHES["rglru_scan_bwd"]`` counts each successful launch, nowhere
else.
"""
from __future__ import annotations

import ctypes
import functools
from pathlib import Path

import torch

from repro_torch.kernels import _build

SOURCE = Path(__file__).resolve().parent / "csrc" / "rglru_scan_bwd.cu"
LIB_NAME = "mcsa_rglru_scan_bwd"
FLAGS = _build.NVCC_FLAGS

#: launches since the last reset (callers may zero it)
LAUNCHES = {"rglru_scan_bwd": 0}


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    """Build (first call) and load the RG-LRU backward library."""
    lib = _build.load(LIB_NAME, SOURCE, FLAGS)
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.mcsa_rglru_scan_bwd_launch.argtypes = [p, p, p, p, p, i, i, i, p]
    lib.mcsa_rglru_scan_bwd_launch.restype = ctypes.c_int
    lib.mcsa_cuda_error_string.argtypes = [ctypes.c_int]
    lib.mcsa_cuda_error_string.restype = ctypes.c_char_p
    return lib


def rglru_scan_bwd_cuda(a: torch.Tensor, h: torch.Tensor,
                        dh: torch.Tensor) -> tuple:
    """a, h (the forward's output) and dh (B, S, C) float32, contiguous,
    on one CUDA device -> (da, db) (B, S, C) float32."""
    for name, t in (("a", a), ("h", h), ("dh", dh)):
        if not torch.is_tensor(t):
            raise TypeError(f"{name}: expected a tensor")
        if t.device.type != "cuda" or t.device != a.device:
            raise ValueError(f"{name}: on {t.device}, expected a's CUDA "
                             f"device ({a.device})")
        if t.dtype != torch.float32:
            raise TypeError(f"{name}: dtype {t.dtype}, expected float32")
        if not t.is_contiguous():
            raise ValueError(f"{name}: not contiguous")
    if a.dim() != 3 or h.shape != a.shape or dh.shape != a.shape:
        raise ValueError(f"rglru_scan backward: a {tuple(a.shape)}, h "
                         f"{tuple(h.shape)}, dh {tuple(dh.shape)}; expected "
                         "three equal (B, S, C)")
    B, S, C = a.shape
    if B > 65535:
        raise ValueError(f"rglru_scan backward: batch {B} > 65535")
    da, db = torch.empty_like(a), torch.empty_like(a)
    if a.numel() == 0:
        return da, db
    lib = library()
    stream = torch.cuda.current_stream(a.device).cuda_stream
    rc = lib.mcsa_rglru_scan_bwd_launch(a.data_ptr(), h.data_ptr(),
                                        dh.data_ptr(), da.data_ptr(),
                                        db.data_ptr(), B, S, C, stream)
    if rc != 0:
        msg = lib.mcsa_cuda_error_string(rc).decode()
        raise RuntimeError(f"rglru_scan backward launch failed: {msg} "
                           f"({rc})")
    LAUNCHES["rglru_scan_bwd"] += 1
    return da, db
