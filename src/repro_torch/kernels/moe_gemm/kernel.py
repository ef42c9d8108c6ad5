"""ctypes wrapper of the CUDA fused expert SwiGLU kernel
(``csrc/moe_swiglu.cu``).

The library is built by :mod:`repro_torch.kernels._build` at the first
launch, never at import.  :func:`moe_swiglu_cuda` checks its inputs,
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

SOURCE = Path(__file__).resolve().parent / "csrc" / "moe_swiglu.cu"
LIB_NAME = "mcsa_moe_swiglu"
FLAGS = _build.NVCC_FLAGS

#: launches since the last reset (callers may zero it)
LAUNCHES = {"moe_swiglu": 0}

DTYPES = {torch.float32: 0, torch.bfloat16: 1}
#: the kernel keeps d / 256 output columns a thread in registers
MAX_D = 2048


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    """Build (first call) and load the MoE library, with argtypes."""
    lib = _build.load(LIB_NAME, SOURCE, FLAGS)
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.mcsa_moe_swiglu_plan.argtypes = [i, i, i, i, i, i]
    lib.mcsa_moe_swiglu_plan.restype = ctypes.c_int
    lib.mcsa_moe_swiglu_launch.argtypes = [p, p, p, p, p, p, i, i, i, i, i,
                                           i, p]
    lib.mcsa_moe_swiglu_launch.restype = ctypes.c_int
    lib.mcsa_cuda_error_string.argtypes = [ctypes.c_int]
    lib.mcsa_cuda_error_string.restype = ctypes.c_char_p
    return lib


def check_shapes(x: torch.Tensor, wg: torch.Tensor, wu: torch.Tensor,
                 wd: torch.Tensor) -> None:
    """Raise unless x is (E, C, d), wg and wu (E, d, ff), wd (E, ff, d)."""
    if x.dim() != 3 or wg.dim() != 3:
        raise ValueError(f"moe_swiglu: shapes x {tuple(x.shape)}, wg "
                         f"{tuple(wg.shape)}; expected (E, C, d) and "
                         "(E, d, ff)")
    E, C, d = x.shape
    ff = wg.shape[2]
    if (tuple(wg.shape) != (E, d, ff) or tuple(wu.shape) != (E, d, ff)
            or tuple(wd.shape) != (E, ff, d)):
        raise ValueError(f"moe_swiglu: shapes x {tuple(x.shape)}, wg "
                         f"{tuple(wg.shape)}, wu {tuple(wu.shape)}, wd "
                         f"{tuple(wd.shape)}; expected (E, C, d), "
                         "(E, d, ff) twice and (E, ff, d)")


def moe_swiglu_cuda(x: torch.Tensor, wg: torch.Tensor, wu: torch.Tensor,
                    wd: torch.Tensor) -> torch.Tensor:
    """x (E, C, d), wg/wu (E, d, ff), wd (E, ff, d): one dtype (float32 or
    bfloat16), contiguous and 16-byte aligned, on one CUDA device, d a
    multiple of 4 and at most 2048 -> (E, C, d) in that dtype.  The
    library's plan picks the tensor-core path (bfloat16, d a multiple of
    128 up to 1024, ff a multiple of 8), split over ff into slices when
    there are too few capacity tiles to fill the card; the slices'
    float32 partial outputs go to a workspace allocated here."""
    for name, t in (("x", x), ("wg", wg), ("wu", wu), ("wd", wd)):
        if not torch.is_tensor(t):
            raise TypeError(f"{name}: expected a tensor")
        if t.device.type != "cuda" or t.device != x.device:
            raise ValueError(f"{name}: on {t.device}, expected x's CUDA "
                             f"device ({x.device})")
        if t.dtype not in DTYPES or t.dtype != x.dtype:
            raise TypeError(f"{name}: dtype {t.dtype}, expected float32 or "
                            "bfloat16, the same for all four")
        if not t.is_contiguous():
            raise ValueError(f"{name}: not contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: not 16-byte aligned")
    check_shapes(x, wg, wu, wd)
    E, C, d = x.shape
    ff = wg.shape[2]
    if d % 4 or d > MAX_D:
        raise ValueError(f"moe_swiglu: d={d}; the kernel takes a multiple "
                         f"of 4 up to {MAX_D}")
    y = torch.empty_like(x)
    if y.numel() == 0:
        return y
    if ff == 0:
        return y.zero_()
    lib = library()
    sms = torch.cuda.get_device_properties(x.device).multi_processor_count
    fs = lib.mcsa_moe_swiglu_plan(E, C, d, ff, DTYPES[x.dtype], sms)
    ws = (torch.empty((fs, E, C, d), dtype=torch.float32, device=x.device)
          if fs > 1 else None)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    rc = lib.mcsa_moe_swiglu_launch(
        x.data_ptr(), wg.data_ptr(), wu.data_ptr(), wd.data_ptr(),
        y.data_ptr(), None if ws is None else ws.data_ptr(), E, C, d, ff,
        fs, DTYPES[x.dtype], stream)
    if rc != 0:
        msg = lib.mcsa_cuda_error_string(rc).decode()
        raise RuntimeError(f"moe_swiglu kernel launch failed: {msg} ({rc})")
    LAUNCHES["moe_swiglu"] += 1
    return y
