"""ctypes wrapper of the CUDA RMSNorm kernel (``csrc/rmsnorm.cu``).

The library is built by :mod:`repro_torch.kernels._build` at the first
launch, never at import.  :func:`rmsnorm_cuda` checks its inputs,
allocates the output with ``torch.empty``, launches on the current
stream without synchronising, and raises if the launch was refused.
``LAUNCHES`` counts successful launches, nowhere else.

:func:`launch_shape` chooses, from d and the number of rows, how many
threads share a row and how many 16-byte vectors each holds in
registers; the library has an instance for each pair it can return and
refuses any other.
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

#: threads a row: a whole warp for rows of up to V_MAX_WARP vectors a
#: lane, else 256 (one row a block), and 256 too for launches of fewer
#: than FEW_ROWS rows, which a warp a row would leave on a few SMs
WARP, WIDE = 32, 256
V_MAX_WARP = 12
FEW_ROWS = 128
#: vectors per thread that the library has instances for (``launch_v`` in
#: csrc/rmsnorm.cu), by threads a row (1 below a warp): those that
#: launch_shape gives the registry's widths (configs/archs.py's d_model
#: and the qk-norm's 128, in float32 and bfloat16), no more
V_SETS = {WARP: (1, 4, 7, 8, 10, 12), WIDE: (1, 2, 3, 4, 6, 7)}


def launch_shape(d: int, element_size: int, rows: int) -> tuple:
    """(threads per row, 16-byte vectors per thread) for ``rows`` rows of
    ``d`` elements of ``element_size`` bytes: the fewest threads (a power
    of two up to a warp) that cover a short row (at most 32 vectors) with
    one vector each; else a warp if the row fits in ``V_MAX_WARP`` vectors
    a lane and there are at least ``FEW_ROWS`` rows; else 256 threads.
    The vectors a thread are the fewest in ``V_SETS`` that cover the row.
    Raises past 256 x 7 vectors (bf16 d > 14336, f32 d > 7168) or for
    rows that are not whole 16-byte vectors."""
    return _shape(d, element_size, rows < FEW_ROWS)


@functools.lru_cache(maxsize=None)
def _shape(d: int, element_size: int, few_rows: bool) -> tuple:
    if d <= 0 or (d * element_size) % 16:
        raise ValueError(f"rmsnorm: rows of {d} x {element_size} bytes; "
                         "the kernel reads 16-byte vectors only")
    nvec = d * element_size // 16
    if nvec <= WARP:
        return 1 << (nvec - 1).bit_length(), 1
    tpr = WARP if not few_rows and nvec <= WARP * V_MAX_WARP else WIDE
    per = -(-nvec // tpr)
    if per > V_SETS[tpr][-1]:
        raise ValueError(f"rmsnorm: rows of {d} x {element_size} bytes "
                         f"exceed the kernel's {WIDE * V_SETS[WIDE][-1]} "
                         "vectors of 16 bytes")
    return tpr, next(v for v in V_SETS[tpr] if v >= per)


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    """Build (first call) and load the RMSNorm library, with argtypes."""
    lib = _build.load(LIB_NAME, SOURCE, FLAGS)
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.mcsa_rmsnorm_launch.argtypes = [p, p, p, i, i, ctypes.c_float, i,
                                        i, i, p]
    lib.mcsa_rmsnorm_launch.restype = ctypes.c_int
    lib.mcsa_cuda_error_string.argtypes = [ctypes.c_int]
    lib.mcsa_cuda_error_string.restype = ctypes.c_char_p
    return lib


def check_args(x: torch.Tensor, w: torch.Tensor) -> None:
    """Raise on what the kernel refuses on any device: dtypes other than
    both float32 or both bfloat16, shapes other than (R, d) and (d,),
    rows that are not whole 16-byte vectors (or wider than
    :func:`launch_shape` takes)."""
    dt = x.dtype
    if dt not in DTYPES or w.dtype != dt:
        raise TypeError(f"rmsnorm_cuda: dtypes {dt}/{w.dtype}, "
                        "expected both float32 or both bfloat16")
    if x.dim() != 2 or w.shape != (x.shape[1],):
        raise ValueError(f"rmsnorm_cuda: shapes x {tuple(x.shape)}, w "
                         f"{tuple(w.shape)}; expected (R, d) and (d,)")
    R, d = x.shape
    size = x.element_size()
    if (d * size) % 16:
        raise ValueError(f"rmsnorm_cuda: rows of {d} x {size} "
                         "bytes, or x or w not 16-byte aligned; the kernel "
                         "reads 16-byte vectors only")
    if R and d:
        launch_shape(d, size, R)


def rmsnorm_cuda(x: torch.Tensor, w: torch.Tensor,
                 eps: float = 1e-6) -> torch.Tensor:
    """x (R, d) and w (d,), both float32 or both bfloat16, contiguous and
    16-byte aligned with d a multiple of 16 bytes, on one CUDA device ->
    (R, d) in x's dtype."""
    if not (torch.is_tensor(x) and torch.is_tensor(w)):
        raise TypeError("rmsnorm_cuda: x and w must be tensors")
    dev = x.device
    if dev.type != "cuda" or w.device != dev:
        raise ValueError(f"rmsnorm_cuda: x on {dev}, w on {w.device}; "
                         "expected one CUDA device")
    check_args(x, w)
    if not (x.is_contiguous() and w.is_contiguous()):
        raise ValueError("rmsnorm_cuda: x and w must be contiguous")
    R, d = x.shape
    dt, size, xp, wp = x.dtype, x.element_size(), x.data_ptr(), w.data_ptr()
    if (xp | wp) % 16:
        raise ValueError(f"rmsnorm_cuda: rows of {d} x {size} "
                         "bytes, or x or w not 16-byte aligned; the kernel "
                         "reads 16-byte vectors only")
    y = torch.empty_like(x)
    if R == 0 or d == 0:
        return y
    tpr, v = launch_shape(d, size, R)
    lib = library()
    # the current stream's handle, without building a torch.cuda.Stream
    # (the wrapper's host cost is most of a decode step's RMSNorm time)
    stream = torch._C._cuda_getCurrentRawStream(dev.index)
    rc = lib.mcsa_rmsnorm_launch(xp, wp, y.data_ptr(), R, d, float(eps),
                                 DTYPES[dt], tpr, v, stream)
    if rc != 0:
        msg = lib.mcsa_cuda_error_string(rc).decode()
        raise RuntimeError(f"rmsnorm kernel launch failed: {msg} ({rc})")
    LAUNCHES["rmsnorm"] += 1
    return y
