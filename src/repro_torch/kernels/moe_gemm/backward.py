"""ctypes wrapper of the CUDA fused expert SwiGLU backward
(``csrc/moe_swiglu_bwd.cu``).

The library is built by :mod:`repro_torch.kernels._build` at the first
launch, never at import.  :func:`moe_swiglu_bwd_cuda` checks its inputs,
allocates the four gradients and the three (E, C, ff) scratch tensors (H,
dG, dU in x's dtype) with ``torch.empty``, launches the three kernels on
the current stream without synchronising, and raises if a launch was
refused.  ``LAUNCHES["moe_swiglu_bwd"]`` counts each successful call (its
three launches once) and ``LAUNCHES["moe_swiglu_bwd_tc"]`` those of the
wgmma + TMA body, nowhere else.

The body follows the dtype and the capacity, explicitly
(:func:`body_for`): bfloat16 with more than ``DECODE_C`` capacity rows
(training) runs the wgmma + TMA body on persistent blocks, bfloat16 up to
``DECODE_C`` rows the mma.sync tiles, float32 the CUDA cores.  The launch
names the body and the library refuses any other pairing.
"""
from __future__ import annotations

import ctypes
import functools
from pathlib import Path

import torch

from repro_torch.kernels import _build

from .kernel import DECODE_C, DTYPES, check_shapes, num_sms

SOURCE = Path(__file__).resolve().parent / "csrc" / "moe_swiglu_bwd.cu"
LIB_NAME = "mcsa_moe_swiglu_bwd"
FLAGS = _build.NVCC_FLAGS

#: launches since the last reset (callers may zero it)
LAUNCHES = {"moe_swiglu_bwd": 0, "moe_swiglu_bwd_tc": 0}
#: the library's body codes
BODIES = {"cuda_cores": 0, "mma": 1, "wgmma": 2}
#: dynamic shared memory of a wgmma + TMA block, as ``hopper_tc::SMEM``
#: counts it: 4 ring stages of a 128 x 64 and a 64 x 256 bf16 tile, 64
#: bytes for their mbarriers and release counters, each warpgroup's 64 x
#: 128 bf16 output block, 1 KiB to align the swizzle
WGMMA_SMEM = 4 * (128 * 64 * 2 + 64 * 256 * 2) + 64 + 2 * 64 * 128 * 2 + 1024


def body_for(dtype: torch.dtype, C: int, d: int, ff: int) -> str:
    """The backward body that runs x (E, C, d) of ``dtype`` with ff
    columns (d and ff multiples of 8): ``"wgmma"`` for bfloat16 with C >
    DECODE_C, ``"mma"`` for bfloat16 up to DECODE_C, ``"cuda_cores"`` for
    float32; raises for any other dtype or width (no fallback)."""
    if d % 8 or ff % 8:
        raise ValueError(f"moe_swiglu backward: d {d}, ff {ff}; the "
                         "kernel takes multiples of 8")
    if dtype == torch.bfloat16:
        return "wgmma" if C > DECODE_C else "mma"
    if dtype == torch.float32:
        return "cuda_cores"
    raise TypeError(f"moe_swiglu backward: dtype {dtype}, expected float32 "
                    "or bfloat16")


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    """Build (first call) and load the MoE backward library."""
    lib = _build.load(LIB_NAME, SOURCE, FLAGS)
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.mcsa_moe_swiglu_bwd_launch.argtypes = [p] * 12 + [i] * 7 + [p]
    lib.mcsa_moe_swiglu_bwd_launch.restype = ctypes.c_int
    lib.mcsa_moe_swiglu_bwd_wgmma_smem.argtypes = []
    lib.mcsa_moe_swiglu_bwd_wgmma_smem.restype = ctypes.c_int
    lib.mcsa_cuda_error_string.argtypes = [ctypes.c_int]
    lib.mcsa_cuda_error_string.restype = ctypes.c_char_p
    return lib


def library_wgmma_smem_bytes() -> int:
    """:data:`WGMMA_SMEM` as the library counts it (builds it on first
    use)."""
    return int(library().mcsa_moe_swiglu_bwd_wgmma_smem())


def check_args(x: torch.Tensor, wg: torch.Tensor, wu: torch.Tensor,
               wd: torch.Tensor, dy: torch.Tensor) -> str:
    """Raise on what the backward kernel refuses on any device: the five
    not all float32 or all bfloat16, :func:`.kernel.check_shapes`'
    shapes, dy not x's shape, widths :func:`body_for` refuses; else the
    body."""
    for name, t in (("x", x), ("wg", wg), ("wu", wu), ("wd", wd),
                    ("dy", dy)):
        if t.dtype not in DTYPES or t.dtype != x.dtype:
            raise TypeError(f"{name}: dtype {t.dtype}, expected float32 or "
                            "bfloat16, the same for all five")
    check_shapes(x, wg, wu, wd)
    if dy.shape != x.shape:
        raise ValueError(f"moe_swiglu backward: dy {tuple(dy.shape)} != x "
                         f"{tuple(x.shape)}")
    return body_for(x.dtype, *x.shape[1:], wg.shape[2])


def moe_swiglu_bwd_cuda(x: torch.Tensor, wg: torch.Tensor, wu: torch.Tensor,
                        wd: torch.Tensor, dy: torch.Tensor) -> tuple:
    """x and dy (E, C, d), wg/wu (E, d, ff), wd (E, ff, d): one dtype
    (float32 or bfloat16), contiguous and 16-byte aligned, on one CUDA
    device, d and ff multiples of 8 -> (dx, dwg, dwu, dwd) in that
    dtype, the gradients of :func:`.kernel.moe_swiglu_cuda` for dy."""
    for name, t in (("x", x), ("wg", wg), ("wu", wu), ("wd", wd),
                    ("dy", dy)):
        if not torch.is_tensor(t):
            raise TypeError(f"{name}: expected a tensor")
        if t.device.type != "cuda" or t.device != x.device:
            raise ValueError(f"{name}: on {t.device}, expected x's CUDA "
                             f"device ({x.device})")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name}: not contiguous or not 16-byte "
                             "aligned")
    body = check_args(x, wg, wu, wd, dy)
    E, C, d = x.shape
    ff = wg.shape[2]
    dx, dwg, dwu, dwd = (torch.empty_like(t) for t in (x, wg, wu, wd))
    if E == 0 or d == 0 or ff == 0 or C == 0:
        return dx.zero_(), dwg.zero_(), dwu.zero_(), dwd.zero_()
    h, dg, du = (torch.empty((E, C, ff), dtype=x.dtype, device=x.device)
                 for _ in range(3))
    lib = library()
    stream = torch.cuda.current_stream(x.device).cuda_stream
    rc = lib.mcsa_moe_swiglu_bwd_launch(
        x.data_ptr(), wg.data_ptr(), wu.data_ptr(), wd.data_ptr(),
        dy.data_ptr(), dx.data_ptr(), dwg.data_ptr(), dwu.data_ptr(),
        dwd.data_ptr(), h.data_ptr(), dg.data_ptr(), du.data_ptr(), E, C, d,
        ff, num_sms(x.device), DTYPES[x.dtype], BODIES[body], stream)
    if rc != 0:
        msg = lib.mcsa_cuda_error_string(rc).decode()
        raise RuntimeError(f"moe_swiglu backward launch failed: {msg} "
                           f"({rc})")
    LAUNCHES["moe_swiglu_bwd"] += 1
    if body == "wgmma":
        LAUNCHES["moe_swiglu_bwd_tc"] += 1
    return dx, dwg, dwu, dwd
