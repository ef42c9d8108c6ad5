"""ctypes wrapper of the CUDA RG-LRU scan kernel (``csrc/rglru_scan.cu``).

The library is built by :mod:`repro_torch.kernels._build` at the first
launch, never at import.  :func:`rglru_scan_cuda` checks its inputs,
allocates the output with ``torch.empty``, launches on the current
stream without synchronising, and raises if the launch was refused.
``LAUNCHES`` counts successful launches, nowhere else.
"""
from __future__ import annotations

import ctypes
import functools
from pathlib import Path

import torch

from repro_torch.kernels import _build

SOURCE = Path(__file__).resolve().parent / "csrc" / "rglru_scan.cu"
LIB_NAME = "mcsa_rglru_scan"
FLAGS = _build.NVCC_FLAGS

#: launches since the last reset (callers may zero it)
LAUNCHES = {"rglru_scan": 0}


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    """Build (first call) and load the RG-LRU library, with argtypes."""
    lib = _build.load(LIB_NAME, SOURCE, FLAGS)
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.mcsa_rglru_scan_launch.argtypes = [p, p, p, i, i, i, p]
    lib.mcsa_rglru_scan_launch.restype = ctypes.c_int
    lib.mcsa_cuda_error_string.argtypes = [ctypes.c_int]
    lib.mcsa_cuda_error_string.restype = ctypes.c_char_p
    return lib


def check_shapes(a: torch.Tensor, b: torch.Tensor) -> None:
    """Raise unless a and b are one (B, S, C) shape."""
    if a.dim() != 3 or b.shape != a.shape:
        raise ValueError(f"rglru_scan: a {tuple(a.shape)}, b "
                         f"{tuple(b.shape)}; expected two equal (B, S, C)")


def rglru_scan_cuda(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a, b (B, S, C) float32, contiguous, on one CUDA device -> h
    (B, S, C) float32 with h_t = a_t h_{t-1} + b_t from h = 0."""
    for name, t in (("a", a), ("b", b)):
        if not torch.is_tensor(t):
            raise TypeError(f"{name}: expected a tensor")
        if t.device.type != "cuda" or t.device != a.device:
            raise ValueError(f"{name}: on {t.device}, expected a's CUDA "
                             f"device ({a.device})")
        if t.dtype != torch.float32:
            raise TypeError(f"{name}: dtype {t.dtype}, expected float32")
        if not t.is_contiguous():
            raise ValueError(f"{name}: not contiguous")
    check_shapes(a, b)
    B, S, C = a.shape
    if B > 65535:
        raise ValueError(f"rglru_scan: batch {B} > 65535")
    h = torch.empty_like(a)
    if h.numel() == 0:
        return h
    lib = library()
    stream = torch.cuda.current_stream(a.device).cuda_stream
    rc = lib.mcsa_rglru_scan_launch(a.data_ptr(), b.data_ptr(), h.data_ptr(),
                                    B, S, C, stream)
    if rc != 0:
        msg = lib.mcsa_cuda_error_string(rc).decode()
        raise RuntimeError(f"rglru_scan kernel launch failed: {msg} ({rc})")
    LAUNCHES["rglru_scan"] += 1
    return h
