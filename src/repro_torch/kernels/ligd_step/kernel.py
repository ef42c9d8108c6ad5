"""ctypes wrapper of the CUDA sweep kernel (``csrc/sweep.cu``).

The library is built by :mod:`repro_torch.kernels._build` at the first
launch (never at import: the CPU tests import this module on machines
without ``nvcc``).  :func:`sweep_cuda` checks its inputs, allocates the
outputs and the kernel's lane counter with ``torch.empty``, launches on
the current stream without synchronising, and raises if the launch was
refused.

``LAUNCHES`` counts launches per variant — one per successful launch,
nowhere else — so a run can show that its main path went through the
kernel.
"""
from __future__ import annotations

import ctypes
import functools
from pathlib import Path

import numpy as np
import torch

from repro_torch.kernels import _build
from .ref import NF_SWEEP

SOURCE = Path(__file__).resolve().parent / "csrc" / "sweep.cu"
LIB_NAME = "mcsa_sweep"

#: the default flags: the body rounds every product, sum and quotient on
#: its own through round-to-nearest intrinsics, which are never contracted
#: into an FMA, so it equals its plain version bit for bit without
#: --fmad=false
FLAGS = _build.NVCC_FLAGS

#: launches per variant since the last reset (callers may zero them)
LAUNCHES = {"ligd_sweep": 0, "mligd_sweep": 0}

#: the (M1, 4) tables live in dynamic shared memory; 48 KB needs no
#: opt-in attribute, which bounds the split count
MAX_SPLITS = 48 * 1024 // 16


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    """Build (first call) and load the sweep library, with argtypes."""
    lib = _build.load(LIB_NAME, SOURCE, FLAGS)
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.mcsa_sweep_launch.argtypes = [p] * 9 + [i, i, i, f, f, f, i, i,
                                                f, f, f, f, i, i, p]
    lib.mcsa_sweep_launch.restype = ctypes.c_int
    lib.mcsa_sweep_resident_blocks.argtypes = [i, i, i]
    lib.mcsa_sweep_resident_blocks.restype = ctypes.c_int
    lib.mcsa_sweep_fast_path_check.argtypes = [p, p, p, i, p, i, p]
    lib.mcsa_sweep_fast_path_check.restype = ctypes.c_int
    lib.mcsa_cuda_error_string.argtypes = [ctypes.c_int]
    lib.mcsa_cuda_error_string.restype = ctypes.c_char_p
    return lib


@functools.lru_cache(maxsize=None)
def sqrt_bound(eps: float) -> float:
    """The float32 ``t`` with ``sqrt(g) < eps`` exactly when ``g < t``, for
    every float32 ``g >= 0`` (and NaN): the smallest float whose
    correctly rounded square root is ``float32(eps)`` or more.  The kernel
    tests ``gsq < t`` where the plain version tests ``sqrt(gsq) < eps``."""
    e = np.float32(eps)
    if not e > 0 or np.isinf(e):
        return float(e) if e != e or e > 0 else 0.0
    f32 = np.float32
    t = f32(e * e)
    while t > 0 and np.sqrt(np.nextafter(t, f32(0))) >= e:
        t = np.nextafter(t, f32(0))
    while np.sqrt(t) < e:
        t = np.nextafter(t, f32(np.inf))
    return float(t)


@functools.lru_cache(maxsize=None)
def resident_blocks(joint: bool, M1: int, device_index: int) -> int:
    """Blocks of the sweep kernel the card holds at once (its persistent
    grid's size), asked once per variant, split count and device."""
    lib = library()
    n = lib.mcsa_sweep_resident_blocks(int(joint), M1, device_index)
    if n <= 0:
        msg = lib.mcsa_cuda_error_string(-n).decode()
        raise RuntimeError(f"sweep occupancy query failed: {msg} ({-n})")
    return n


def _check(name: str, t: torch.Tensor, shape: tuple, device) -> None:
    if not torch.is_tensor(t):
        raise TypeError(f"{name}: expected a tensor, got {type(t).__name__}")
    if t.device != device or t.device.type != "cuda":
        raise ValueError(f"{name}: on {t.device}, expected {device} (CUDA)")
    if t.dtype != torch.float32:
        raise TypeError(f"{name}: dtype {t.dtype}, expected float32")
    if tuple(t.shape) != shape:
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected {shape}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: not contiguous")


def sweep_cuda(feat: torch.Tensor, x0: torch.Tensor, tables: torch.Tensor,
               *, joint: bool, lr: float, eps: float, max_iters: int,
               warm_start: bool, init) -> tuple:
    """Launch the fused sweep.  feat (NF_SWEEP, X), x0 (K, X) with K = 4
    when ``joint`` else 2, tables (M1, 4), all float32 on one CUDA
    device.  Returns (u, xB, xr, iters) as (M1, X) and best (2+K, X) =
    [s*, U*, x*...], as the TPU kernel returns them.  Each lane stops on
    its own, so the TPU kernel's ``chunk`` has no counterpart here."""
    device = feat.device
    X = feat.shape[1] if feat.dim() == 2 else -1
    K = 4 if joint else 2
    M1 = tables.shape[0] if tables.dim() == 2 else -1
    _check("feat", feat, (NF_SWEEP, X), device)
    _check("x0", x0, (K, X), device)
    _check("tables", tables, (M1, 4), device)
    if not 0 < M1 <= MAX_SPLITS:
        raise ValueError(f"tables: {M1} splits, expected 1..{MAX_SPLITS}")
    if len(init) != K:
        raise ValueError(f"init: {len(init)} values, expected {K}")
    out = [torch.empty((M1, X), dtype=torch.float32, device=device)
           for _ in range(4)]
    best = torch.empty((2 + K, X), dtype=torch.float32, device=device)
    if X == 0:
        return (*out, best)
    init4 = [float(v) for v in init] + [0.0] * (4 - K)
    next_lane = torch.empty((1,), dtype=torch.int32, device=device)
    lib = library()
    index = device.index or 0
    stream = torch.cuda.current_stream(device).cuda_stream
    rc = lib.mcsa_sweep_launch(
        feat.data_ptr(), x0.data_ptr(), tables.data_ptr(),
        *(o.data_ptr() for o in out), best.data_ptr(), next_lane.data_ptr(),
        X, M1, int(joint), float(lr), float(eps), sqrt_bound(float(eps)),
        int(max_iters), int(bool(warm_start)), *init4,
        resident_blocks(bool(joint), M1, index), index, stream)
    if rc != 0:
        msg = lib.mcsa_cuda_error_string(rc).decode()
        raise RuntimeError(f"sweep kernel launch failed: {msg} ({rc})")
    LAUNCHES["mligd_sweep" if joint else "ligd_sweep"] += 1
    return (*out, best)


def fast_path_check(a: torch.Tensor, b: torch.Tensor,
                    c: torch.Tensor) -> torch.Tensor:
    """The kernel's fast division, reciprocal, exp2 and log2 on the card,
    for tests: (8, n) float32 rows a/b, 1/b, 2^c and log2|b| through the
    fast paths the sweep takes for lanes in range, then the same through
    CUDA's IEEE intrinsics, exp2f and log2f.  a, b, c: (n,) float32 on one
    CUDA device."""
    n = a.shape[0] if a.dim() == 1 else -1
    for name, t in (("a", a), ("b", b), ("c", c)):
        _check(name, t, (n,), a.device)
    out = torch.empty((8, n), dtype=torch.float32, device=a.device)
    lib = library()
    rc = lib.mcsa_sweep_fast_path_check(
        a.data_ptr(), b.data_ptr(), c.data_ptr(), n, out.data_ptr(),
        a.device.index or 0, torch.cuda.current_stream(a.device).cuda_stream)
    if rc != 0:
        msg = lib.mcsa_cuda_error_string(rc).decode()
        raise RuntimeError(f"fast-path check launch failed: {msg} ({rc})")
    return out
