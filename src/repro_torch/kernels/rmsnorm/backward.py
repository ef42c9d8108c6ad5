"""ctypes wrapper of the CUDA RMSNorm backward (``csrc/rmsnorm_bwd.cu``).

The library is built by :mod:`repro_torch.kernels._build` at the first
launch, never at import.  :func:`rmsnorm_bwd_cuda` checks its inputs,
allocates dx, dw and the (nblocks, d) float32 partials with
``torch.empty``, launches both stages on the current stream without
synchronising, and raises if a launch was refused.
``LAUNCHES["rmsnorm_bwd"]`` counts each successful call (its two
launches once), nowhere else.

:func:`launch_shape` fixes threads a row, 16-byte vectors a thread and
the number of stage-1 blocks from the shape alone (never from the card),
so that the deterministic reduction gives the same bits on every run.
"""
from __future__ import annotations

import ctypes
import functools
from pathlib import Path

import torch

from repro_torch.kernels import _build

SOURCE = Path(__file__).resolve().parent / "csrc" / "rmsnorm_bwd.cu"
LIB_NAME = "mcsa_rmsnorm_bwd"
FLAGS = _build.NVCC_FLAGS

#: successful calls since the last reset (callers may zero it)
LAUNCHES = {"rmsnorm_bwd": 0}

DTYPES = {torch.float32: 0, torch.bfloat16: 1}
THREADS = 256
#: 16-byte vectors a thread below THREADS threads a row; a row of THREADS
#: threads holds up to WIDE_MAX_V (bf16 d 14336, f32 d 7168: the forward's
#: widest)
V_GROUP, WIDE_MAX_V = 4, 7
#: stage-1 blocks: at most two a streaming multiprocessor of the H100
MAX_BLOCKS = 264


@functools.lru_cache(maxsize=None)
def launch_shape(rows: int, d: int, element_size: int) -> tuple:
    """(threads a row, vectors a thread, stage-1 blocks) for ``rows`` rows
    of ``d`` elements of ``element_size`` bytes: the fewest threads, a
    power of two up to THREADS, that hold the row in V_GROUP vectors
    each; at THREADS, as many vectors as the row needs (up to
    WIDE_MAX_V).  Raises for rows that are not whole 16-byte vectors or
    are wider than the forward takes."""
    if d <= 0 or (d * element_size) % 16:
        raise ValueError(f"rmsnorm backward: rows of {d} x {element_size} "
                         "bytes; the kernel reads 16-byte vectors only")
    nvec = d * element_size // 16
    tpr = min(THREADS, 1 << (-(-nvec // V_GROUP) - 1).bit_length())
    v = V_GROUP if tpr < THREADS else -(-nvec // THREADS)
    if v > WIDE_MAX_V:
        raise ValueError(f"rmsnorm backward: rows of {d} x {element_size} "
                         f"bytes exceed the kernel's {THREADS * WIDE_MAX_V} "
                         "vectors of 16 bytes")
    return tpr, v, max(1, min(-(-rows // (THREADS // tpr)), MAX_BLOCKS))


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    """Build (first call) and load the RMSNorm backward library."""
    lib = _build.load(LIB_NAME, SOURCE, FLAGS)
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.mcsa_rmsnorm_bwd_launch.argtypes = [p, p, p, p, p, p, i, i,
                                            ctypes.c_float, i, i, i, i, p]
    lib.mcsa_rmsnorm_bwd_launch.restype = ctypes.c_int
    lib.mcsa_cuda_error_string.argtypes = [ctypes.c_int]
    lib.mcsa_cuda_error_string.restype = ctypes.c_char_p
    return lib


def rmsnorm_bwd_cuda(x: torch.Tensor, w: torch.Tensor, g: torch.Tensor,
                     eps: float = 1e-6) -> tuple:
    """x and g (R, d), w (d,), one dtype (float32 or bfloat16), contiguous
    and 16-byte aligned with d a multiple of 16 bytes, on one CUDA device
    -> (dx (R, d) in x's dtype, dw (d,) in w's)."""
    for name, t in (("x", x), ("w", w), ("g", g)):
        if not torch.is_tensor(t):
            raise TypeError(f"rmsnorm_bwd_cuda: {name} must be a tensor")
        if t.device.type != "cuda" or t.device != x.device:
            raise ValueError(f"rmsnorm_bwd_cuda: {name} on {t.device}; "
                             "expected x's CUDA device")
        if t.dtype not in DTYPES or t.dtype != x.dtype:
            raise TypeError(f"rmsnorm_bwd_cuda: {name} dtype {t.dtype}; "
                            "expected float32 or bfloat16, one for all")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"rmsnorm_bwd_cuda: {name} not contiguous or "
                             "not 16-byte aligned")
    if x.dim() != 2 or g.shape != x.shape or w.shape != (x.shape[1],):
        raise ValueError(f"rmsnorm_bwd_cuda: shapes x {tuple(x.shape)}, g "
                         f"{tuple(g.shape)}, w {tuple(w.shape)}; expected "
                         "(R, d), (R, d) and (d,)")
    R, d = x.shape
    dx, dw = torch.empty_like(x), torch.empty_like(w)
    if R == 0 or d == 0:
        return dx, dw.zero_()
    tpr, v, nblocks = launch_shape(R, d, x.element_size())
    partial = torch.empty((nblocks, d), dtype=torch.float32,
                          device=x.device)
    lib = library()
    stream = torch._C._cuda_getCurrentRawStream(x.device.index)
    rc = lib.mcsa_rmsnorm_bwd_launch(
        x.data_ptr(), w.data_ptr(), g.data_ptr(), dx.data_ptr(),
        dw.data_ptr(), partial.data_ptr(), R, d, float(eps), DTYPES[x.dtype],
        tpr, v, nblocks, stream)
    if rc != 0:
        msg = lib.mcsa_cuda_error_string(rc).decode()
        raise RuntimeError(f"rmsnorm backward launch failed: {msg} ({rc})")
    LAUNCHES["rmsnorm_bwd"] += 1
    return dx, dw
