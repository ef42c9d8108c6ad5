"""ctypes wrapper of the CUDA single-split Li-GD kernel
(``csrc/steps.cu``, kernel row 2).

The library is built by :mod:`repro_torch.kernels._build` at the first
launch, never at import.  :func:`ligd_steps_grouped_cuda` checks its
inputs, allocates the outputs with ``torch.empty``, launches once for all
groups on the current stream without synchronising, and raises if the
launch was refused; :func:`ligd_steps_cuda` is its one-group case.
``LAUNCHES`` counts successful launches, nowhere else.
"""
from __future__ import annotations

import ctypes
import functools
from pathlib import Path

import torch

from repro_torch.kernels import _build
from .ref import EDGE_KEYS, MAX_GROUPS, NF, check_groups

SOURCE = Path(__file__).resolve().parent / "csrc" / "steps.cu"
LIB_NAME = "mcsa_ligd_steps"
#: the group cap is the source's only through this define
FLAGS = _build.NVCC_FLAGS + (f"-DMCSA_STEPS_MAX_GROUPS={MAX_GROUPS}",)

#: launches since the last reset (callers may zero it)
LAUNCHES = {"ligd_steps": 0}


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    """Build (first call) and load the steps library, with argtypes."""
    lib = _build.load(LIB_NAME, SOURCE, FLAGS)
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.mcsa_ligd_steps_launch.argtypes = [p] * 4 + [i, i, f, i, p, p, p]
    lib.mcsa_ligd_steps_launch.restype = ctypes.c_int
    lib.mcsa_cuda_error_string.argtypes = [ctypes.c_int]
    lib.mcsa_cuda_error_string.restype = ctypes.c_char_p
    return lib


def _check_rows(feat: torch.Tensor, x0: torch.Tensor) -> int:
    for name, t, cols in (("feat", feat, NF), ("x0", x0, 2)):
        if not torch.is_tensor(t):
            raise TypeError(f"{name}: expected a tensor")
        if t.device.type != "cuda" or t.device != feat.device:
            raise ValueError(f"{name}: on {t.device}, expected feat's CUDA "
                             f"device ({feat.device})")
        if t.dtype != torch.float32:
            raise TypeError(f"{name}: dtype {t.dtype}, expected float32")
        if t.dim() != 2 or t.shape[1] != cols:
            raise ValueError(f"{name}: shape {tuple(t.shape)}, expected "
                             f"(X, {cols})")
        if not t.is_contiguous() or (name == "feat" and t.data_ptr() % 16):
            raise ValueError(f"{name}: not contiguous or not 16-byte "
                             "aligned")
    X = feat.shape[0]
    if x0.shape[0] != X:
        raise ValueError(f"x0: {x0.shape[0]} rows, feat {X}")
    return X


def ligd_steps_grouped_cuda(feat: torch.Tensor, x0: torch.Tensor, offsets,
                            edge_tuples, *, iters: int = 64,
                            lr: float = 0.15):
    """One launch for G groups: feat (X, NF) and x0 (X, 2) float32,
    contiguous, on one CUDA device, the rows of group j at
    ``offsets[j]:offsets[j + 1]`` (G + 1 non-decreasing host ints from 0
    to X, G <= MAX_GROUPS); ``edge_tuples`` G records from
    :func:`.ref.edge_tuple_of`.  Returns (x (X, 2), U (X,)) float32, each
    row what :func:`ligd_steps_cuda` returns for its group alone."""
    X = _check_rows(feat, x0)
    start = check_groups(offsets, edge_tuples, X)
    if iters < 0:
        raise ValueError(f"iters {iters} < 0")
    x = torch.empty((X, 2), dtype=torch.float32, device=feat.device)
    u = torch.empty((X,), dtype=torch.float32, device=feat.device)
    if X == 0:
        return x, u
    G = len(edge_tuples)
    starts = (ctypes.c_int * (G + 1))(*start)
    edges = (ctypes.c_float * (G * len(EDGE_KEYS)))(
        *(v for et in edge_tuples for _, v in et))
    lib = library()
    stream = torch.cuda.current_stream(feat.device).cuda_stream
    rc = lib.mcsa_ligd_steps_launch(
        feat.data_ptr(), x0.data_ptr(), x.data_ptr(), u.data_ptr(), X,
        int(iters), float(lr), G, starts, edges, stream)
    if rc != 0:
        msg = lib.mcsa_cuda_error_string(rc).decode()
        raise RuntimeError(f"ligd_steps kernel launch failed: {msg} ({rc})")
    LAUNCHES["ligd_steps"] += 1
    return x, u


def ligd_steps_cuda(feat: torch.Tensor, x0: torch.Tensor, edge_tuple, *,
                    iters: int = 64, lr: float = 0.15):
    """feat (X, NF) and x0 (X, 2) float32, contiguous, on one CUDA
    device; ``edge_tuple`` from :func:`.ref.edge_tuple_of`.  Returns
    (x (X, 2), U (X,)) float32: the one-group case of
    :func:`ligd_steps_grouped_cuda`."""
    return ligd_steps_grouped_cuda(feat, x0, (0, len(feat)), (edge_tuple,),
                                   iters=iters, lr=lr)
