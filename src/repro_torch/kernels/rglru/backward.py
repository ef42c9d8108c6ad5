"""ctypes wrapper of the CUDA RG-LRU scan backward
(``csrc/rglru_scan_bwd.cu``).

The library is built by :mod:`repro_torch.kernels._build` at the first
launch, never at import.  :func:`rglru_scan_bwd_cuda` checks its inputs,
allocates da, db and the carries with ``torch.empty`` (the flags and
ticket with ``torch.zeros``), launches on the current stream without
synchronising, and raises if the launch was refused.
``LAUNCHES["rglru_scan_bwd"]`` counts each successful call, nowhere else.

Time is split into chunks of ``CHUNK`` steps across blocks, and each
chunk passes its carry to the earlier one in one pass.
"""
from __future__ import annotations

import ctypes
import functools
from pathlib import Path

import torch

from repro_torch.kernels import _build

from .ref import CHUNK, SUB

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
    lib.mcsa_rglru_scan_bwd_launch.argtypes = [p] * 7 + [i] * 3 + [p]
    lib.mcsa_rglru_scan_bwd_launch.restype = ctypes.c_int
    for name, want in (("chunk", CHUNK), ("sub", SUB)):
        fn = getattr(lib, f"mcsa_rglru_scan_bwd_{name}")
        fn.argtypes = []
        fn.restype = ctypes.c_int
        if fn() != want:
            raise RuntimeError(f"rglru_scan backward: the library's {name} "
                               f"is {fn()}, ref.{name.upper()} {want}")
    lib.mcsa_cuda_error_string.argtypes = [ctypes.c_int]
    lib.mcsa_cuda_error_string.restype = ctypes.c_char_p
    return lib


def workspace_bytes(B: int, S: int, C: int) -> int:
    """Bytes of the workspace: a float32 carry a (chunk, batch, channel)
    and a zeroed 32-bit flag a (chunk, batch, 32 channels) plus the
    ticket."""
    nc = -(-S // CHUNK)
    return 4 * (nc * B * C + nc * B * -(-C // 32) + 1)


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
    nc = -(-S // CHUNK)
    ws = torch.empty(nc * B * C, dtype=torch.float32, device=a.device)
    flags = torch.zeros(nc * B * -(-C // 32) + 1, dtype=torch.int32,
                        device=a.device)
    lib = library()
    stream = torch.cuda.current_stream(a.device).cuda_stream
    rc = lib.mcsa_rglru_scan_bwd_launch(
        a.data_ptr(), h.data_ptr(), dh.data_ptr(), da.data_ptr(),
        db.data_ptr(), ws.data_ptr(), flags.data_ptr(), B, S, C, stream)
    if rc != 0:
        msg = lib.mcsa_cuda_error_string(rc).decode()
        raise RuntimeError(f"rglru_scan backward launch failed: {msg} "
                           f"({rc})")
    LAUNCHES["rglru_scan_bwd"] += 1
    return da, db
