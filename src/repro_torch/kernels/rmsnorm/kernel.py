"""ctypes wrapper of the CUDA RMSNorm kernel (``csrc/rmsnorm.cu``).

The library is built by :mod:`repro_torch.kernels._build` at the first
launch, never at import.  :func:`rmsnorm_cuda` checks its inputs,
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

SOURCE = Path(__file__).resolve().parent / "csrc" / "rmsnorm.cu"
LIB_NAME = "mcsa_rmsnorm"
FLAGS = _build.NVCC_FLAGS

#: launches since the last reset (callers may zero it)
LAUNCHES = {"rmsnorm": 0}

DTYPES = {torch.float32: 0, torch.bfloat16: 1}


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    """Build (first call) and load the RMSNorm library, with argtypes."""
    lib = _build.load(LIB_NAME, SOURCE, FLAGS)
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.mcsa_rmsnorm_launch.argtypes = [p, p, p, i, i, ctypes.c_float, i, p]
    lib.mcsa_rmsnorm_launch.restype = ctypes.c_int
    lib.mcsa_cuda_error_string.argtypes = [ctypes.c_int]
    lib.mcsa_cuda_error_string.restype = ctypes.c_char_p
    return lib


def rmsnorm_cuda(x: torch.Tensor, w: torch.Tensor,
                 eps: float = 1e-6) -> torch.Tensor:
    """x (R, d) and w (d,), both float32 or both bfloat16, contiguous and
    16-byte aligned with d a multiple of 16 bytes, on one CUDA device ->
    (R, d) in x's dtype."""
    if not (torch.is_tensor(x) and torch.is_tensor(w)):
        raise TypeError("rmsnorm_cuda: x and w must be tensors")
    if x.device.type != "cuda" or w.device != x.device:
        raise ValueError(f"rmsnorm_cuda: x on {x.device}, w on {w.device}; "
                         "expected one CUDA device")
    if x.dtype not in DTYPES or w.dtype != x.dtype:
        raise TypeError(f"rmsnorm_cuda: dtypes {x.dtype}/{w.dtype}, "
                        "expected both float32 or both bfloat16")
    if x.dim() != 2 or w.shape != (x.shape[1],):
        raise ValueError(f"rmsnorm_cuda: shapes x {tuple(x.shape)}, w "
                         f"{tuple(w.shape)}; expected (R, d) and (d,)")
    if not (x.is_contiguous() and w.is_contiguous()):
        raise ValueError("rmsnorm_cuda: x and w must be contiguous")
    R, d = x.shape
    if (d * x.element_size()) % 16 or (x.data_ptr() | w.data_ptr()) % 16:
        raise ValueError(f"rmsnorm_cuda: rows of {d} x {x.element_size()} "
                         "bytes, or x or w not 16-byte aligned; the kernel "
                         "reads 16-byte vectors only")
    y = torch.empty_like(x)
    if R == 0 or d == 0:
        return y
    lib = library()
    stream = torch.cuda.current_stream(x.device).cuda_stream
    rc = lib.mcsa_rmsnorm_launch(x.data_ptr(), w.data_ptr(), y.data_ptr(),
                                 R, d, float(eps), DTYPES[x.dtype], stream)
    if rc != 0:
        msg = lib.mcsa_cuda_error_string(rc).decode()
        raise RuntimeError(f"rmsnorm kernel launch failed: {msg} ({rc})")
    LAUNCHES["rmsnorm"] += 1
    return y
