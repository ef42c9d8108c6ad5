"""ctypes wrapper of the CUDA fused expert SwiGLU kernel
(``csrc/moe_swiglu.cu``).

The library is built by :mod:`repro_torch.kernels._build` at the first
launch, never at import.  :func:`moe_swiglu_cuda` checks its inputs,
allocates the output with ``torch.empty``, launches on the current
stream without synchronising, and raises if the launch was refused.
``LAUNCHES["moe_swiglu"]`` counts every successful call, and
``LAUNCHES["moe_swiglu_" + body]`` those of each body, nowhere else.

The body follows the dtype and the shape, explicitly (:func:`body_for`):
bfloat16 with more than ``DECODE_C`` capacity rows (prefill) runs the
wgmma + TMA body (two kernels, h through a bf16 hi + lo workspace
allocated here); bfloat16 up to ``DECODE_C`` rows (decode) the mma.sync
body, split over ff; float32 and shapes neither takes the CUDA-core
body.  The launch names the body and the library refuses any other
pairing.
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
LAUNCHES = {"moe_swiglu": 0, "moe_swiglu_wgmma": 0, "moe_swiglu_mma": 0,
            "moe_swiglu_cuda_cores": 0}

DTYPES = {torch.float32: 0, torch.bfloat16: 1}
#: widest d of either body that keeps y in registers: the CUDA-core body
#: holds d / 256 output columns a thread, the mma.sync body (one m16
#: tile a block) d / 16 floats
MAX_D = 2048
#: capacity rows up to which bfloat16 runs the mma.sync body (decode:
#: C 2-16, where the weights' bytes bind)
DECODE_C = 16
#: the library's body codes
BODIES = {"cuda_cores": 0, "mma": 1, "wgmma": 2}


def body_for(dtype: torch.dtype, C: int, d: int, ff: int) -> str:
    """The body that runs x (E, C, d) of ``dtype`` with ff columns:
    ``"wgmma"`` for bfloat16 with C > DECODE_C and d, ff multiples of 8;
    ``"mma"`` for bfloat16 with d a multiple of 128 up to ``MAX_D`` and
    ff a multiple of 8; else ``"cuda_cores"``."""
    if dtype == torch.bfloat16 and d % 8 == 0 and ff % 8 == 0:
        if C > DECODE_C:
            return "wgmma"
        if d % 128 == 0 and d <= MAX_D:
            return "mma"
    return "cuda_cores"


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    """Build (first call) and load the MoE library, with argtypes."""
    lib = _build.load(LIB_NAME, SOURCE, FLAGS)
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.mcsa_moe_swiglu_plan.argtypes = [i, i, i, i, i, i]
    lib.mcsa_moe_swiglu_plan.restype = ctypes.c_int
    lib.mcsa_moe_swiglu_launch.argtypes = [p, p, p, p, p, p, p, i, i, i, i,
                                           i, i, i, i, p]
    lib.mcsa_moe_swiglu_launch.restype = ctypes.c_int
    lib.mcsa_moe_swiglu_wgmma_smem.argtypes = [i]
    lib.mcsa_moe_swiglu_wgmma_smem.restype = ctypes.c_int
    lib.mcsa_cuda_error_string.argtypes = [ctypes.c_int]
    lib.mcsa_cuda_error_string.restype = ctypes.c_char_p
    return lib


def wgmma_smem_bytes(kernel: str) -> int:
    """Dynamic shared memory of the wgmma body's ``"gate_up"`` or
    ``"down"`` kernel (builds the library on first use)."""
    return int(library().mcsa_moe_swiglu_wgmma_smem(
        {"gate_up": 0, "down": 1}[kernel]))


@functools.lru_cache(maxsize=None)
def num_sms(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


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


def check_args(x: torch.Tensor, wg: torch.Tensor, wu: torch.Tensor,
               wd: torch.Tensor) -> None:
    """Raise on what the kernel refuses on any device: the four not all
    float32 or all bfloat16, :func:`check_shapes`' shapes, d not a
    multiple of 4 up to ``MAX_D``."""
    for name, t in (("x", x), ("wg", wg), ("wu", wu), ("wd", wd)):
        if t.dtype not in DTYPES or t.dtype != x.dtype:
            raise TypeError(f"{name}: dtype {t.dtype}, expected float32 or "
                            "bfloat16, the same for all four")
    check_shapes(x, wg, wu, wd)
    d = x.shape[2]
    if d % 4 or d > MAX_D:
        raise ValueError(f"moe_swiglu: d={d}; the kernel takes a multiple "
                         f"of 4 up to {MAX_D}")


def moe_swiglu_cuda(x: torch.Tensor, wg: torch.Tensor, wu: torch.Tensor,
                    wd: torch.Tensor) -> torch.Tensor:
    """x (E, C, d), wg/wu (E, d, ff), wd (E, ff, d): one dtype (float32 or
    bfloat16), contiguous and 16-byte aligned, on one CUDA device, d a
    multiple of 4 and at most 2048 -> (E, C, d) in that dtype.  The body
    is :func:`body_for`'s; the mma.sync body is split over ff into the
    slices the library's plan gives (float32 partial outputs in a
    workspace allocated here), the wgmma body writes h as bf16 hi + lo
    into two (E, C, ff) workspaces allocated here."""
    for name, t in (("x", x), ("wg", wg), ("wu", wu), ("wd", wd)):
        if not torch.is_tensor(t):
            raise TypeError(f"{name}: expected a tensor")
        if t.device.type != "cuda" or t.device != x.device:
            raise ValueError(f"{name}: on {t.device}, expected x's CUDA "
                             f"device ({x.device})")
        if not t.is_contiguous():
            raise ValueError(f"{name}: not contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: not 16-byte aligned")
    check_args(x, wg, wu, wd)
    E, C, d = x.shape
    ff = wg.shape[2]
    y = torch.empty_like(x)
    if y.numel() == 0:
        return y
    if ff == 0:
        return y.zero_()
    lib = library()
    body = body_for(x.dtype, C, d, ff)
    fs, ws, ws2 = 0, None, None
    if body == "mma":
        fs = lib.mcsa_moe_swiglu_plan(E, C, d, ff, DTYPES[x.dtype],
                                      num_sms(x.device))
        if fs < 1:
            raise RuntimeError(f"moe_swiglu: the library's plan refuses "
                               f"the mma body at {(E, C, d, ff)}")
        if fs > 1:
            ws = torch.empty((fs, E, C, d), dtype=torch.float32,
                             device=x.device)
    elif body == "wgmma":
        ws = torch.empty((E, C, ff), dtype=x.dtype, device=x.device)
        ws2 = torch.empty((E, C, ff), dtype=x.dtype, device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    rc = lib.mcsa_moe_swiglu_launch(
        x.data_ptr(), wg.data_ptr(), wu.data_ptr(), wd.data_ptr(),
        y.data_ptr(), None if ws is None else ws.data_ptr(),
        None if ws2 is None else ws2.data_ptr(), E, C, d, ff, fs,
        num_sms(x.device), DTYPES[x.dtype], BODIES[body], stream)
    if rc != 0:
        msg = lib.mcsa_cuda_error_string(rc).decode()
        raise RuntimeError(f"moe_swiglu kernel launch failed: {msg} ({rc})")
    LAUNCHES["moe_swiglu"] += 1
    LAUNCHES["moe_swiglu_" + body] += 1
    return y
