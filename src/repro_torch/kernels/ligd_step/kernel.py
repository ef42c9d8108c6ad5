"""ctypes wrapper of the CUDA sweep kernel (``csrc/sweep.cu``).

The library is built by :mod:`repro_torch.kernels._build` at the first
launch (never at import: the CPU tests import this module on machines
without ``nvcc``).  :func:`sweep_cuda` checks its inputs, allocates the
outputs with ``torch.empty``, launches on the current stream without
synchronising, and raises if the launch was refused.

``LAUNCHES`` counts launches per variant — one per successful launch,
nowhere else — so a run can show that its main path went through the
kernel.
"""
from __future__ import annotations

import ctypes
import functools
from pathlib import Path

import torch

from repro_torch.kernels import _build
from .ref import NF_SWEEP

SOURCE = Path(__file__).resolve().parent / "csrc" / "sweep.cu"
LIB_NAME = "mcsa_sweep"

#: --fmad=false keeps every product and sum separately rounded, as the
#: plain PyTorch version rounds them: the sweep's discrete outputs (split,
#: iteration counts) flip on one ulp, and this flag is what makes the
#: kernel equal its plain version bit for bit
FLAGS = _build.NVCC_FLAGS + ("--fmad=false",)

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
    lib.mcsa_sweep_launch.argtypes = [p] * 8 + [i, i, i, f, f, i, i,
                                                f, f, f, f, i, p]
    lib.mcsa_sweep_launch.restype = ctypes.c_int
    lib.mcsa_cuda_error_string.argtypes = [ctypes.c_int]
    lib.mcsa_cuda_error_string.restype = ctypes.c_char_p
    return lib


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
    lib = library()
    stream = torch.cuda.current_stream(device).cuda_stream
    rc = lib.mcsa_sweep_launch(
        feat.data_ptr(), x0.data_ptr(), tables.data_ptr(),
        *(o.data_ptr() for o in out), best.data_ptr(),
        X, M1, int(joint), float(lr), float(eps), int(max_iters),
        int(bool(warm_start)), *init4, device.index or 0, stream)
    if rc != 0:
        msg = lib.mcsa_cuda_error_string(rc).decode()
        raise RuntimeError(f"sweep kernel launch failed: {msg} ({rc})")
    LAUNCHES["mligd_sweep" if joint else "ligd_sweep"] += 1
    return (*out, best)
