"""ctypes wrapper of the CUDA flash-attention backward
(``csrc/flash_attention_bwd.cu``).

The library is built by :mod:`repro_torch.kernels._build` at the first
launch, never at import.  :func:`flash_attention_bwd_cuda` checks its
inputs, allocates dq, dk, dv and the float32 scratch with
``torch.empty``, launches the body's kernels on the current stream
without synchronising, and raises if a launch was refused.
``LAUNCHES["flash_attention_bwd"]`` counts each successful call (its
launches once) and ``LAUNCHES["flash_attention_bwd_tc"]`` those of the
tensor-core body, nowhere else.

The body follows the dtype, explicitly (:func:`body_for`): bfloat16 runs
the tensor-core body (wgmma, TMA) at every head_dim, one warpgroup a
block up to head_dim 128 and two at 256; it takes the training forward's
LSE and output residual (``kernel.flash_attention_cuda(stats=True)``).
float32 runs the CUDA-core body, which recomputes LSE and takes D from
its float32 output.  :func:`group_split`, :func:`slots` and
:func:`smem_bytes` are the tensor-core body's launch shape, from the
shape alone.  ``q_offset`` places query row i at key position
``q_offset + i``, as in the forward (``kernel.py``); the bands the
kernels walk, and so :func:`band_q_tiles` and :func:`group_split`, read
the shifted positions.
"""
from __future__ import annotations

import ctypes
import functools
from pathlib import Path
from typing import Optional

import torch

from repro_torch.kernels import _build
from .kernel import check_shapes

SOURCE = Path(__file__).resolve().parent / "csrc" / "flash_attention_bwd.cu"
LIB_NAME = "mcsa_flash_attention_bwd"
FLAGS = _build.NVCC_FLAGS

#: successful calls since the last reset (callers may zero it)
LAUNCHES = {"flash_attention_bwd": 0, "flash_attention_bwd_tc": 0}

DTYPES = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIMS = (32, 64, 128, 256)
#: the library's body codes
BODIES = {"cuda_cores": 0, "tensor_cores": 1}

#: q rows and keys a tile of the tensor-core body
TILE = 64
#: the H100's streaming multiprocessors; a constant, never read from the
#: card, so the split, and the bits, follow the shape alone
SMS = 132
#: the H100's shared memory a block may take
SMEM_LIMIT = 232_448


def body_for(dtype: torch.dtype, hd: int) -> str:
    """The backward body that runs ``dtype`` at head_dim ``hd``:
    ``"tensor_cores"`` for bfloat16, ``"cuda_cores"`` for float32; raises
    for any other dtype or head_dim (no fallback)."""
    if hd not in HEAD_DIMS:
        raise ValueError(f"attention backward: head_dim {hd}; the kernel "
                         f"takes {HEAD_DIMS}")
    if dtype == torch.bfloat16:
        return "tensor_cores"
    if dtype == torch.float32:
        return "cuda_cores"
    raise TypeError(f"attention backward: dtype {dtype}, expected float32 "
                    "or bfloat16")


def blocks_per_sm(hd: int) -> int:
    """Tensor-core blocks an SM holds at head_dim ``hd`` (``tc::Cfg::
    BLOCKS_PER_SM``, the kernels' launch bounds): two of one warpgroup up
    to 128, one of two warpgroups (``tc::Cfg::NWG``) at 256."""
    return 1 if hd > 128 else 2


def slots(hd: int) -> int:
    """The card's dK/dV block slots at head_dim ``hd``: SMS x
    :func:`blocks_per_sm` (264 up to 128, 132 at 256)."""
    return SMS * blocks_per_sm(hd)


def smem_bytes(hd: int, kernel: str) -> int:
    """Dynamic shared memory of a tensor-core block (``kernel`` "dkdv" or
    "dq") at head_dim ``hd``, as ``csrc/flash_attention_bwd.cu``'s
    ``tc::Cfg`` counts it: six 64-row bf16 tiles (K, V and two stages of
    Q, dO; or Q, dO and two stages of K, V), dkdv's two stats rows of 64
    (LSE, D) pairs, three mbarriers and 1 KiB to align the swizzle."""
    if kernel not in ("dkdv", "dq"):
        raise ValueError(f"attention backward: kernel {kernel!r}")
    tiles = 6 * TILE * max(64, hd) * 2
    stats = 2 * TILE * 8 if kernel == "dkdv" else 0
    return tiles + stats + 8 * 3 + 1024


def band_q_tiles(Sq: int, Skv: int, causal: bool, window: int,
                 q_offset: int = 0) -> list:
    """For each kv tile of 64 keys, the q tiles of 64 rows that the dK/dV
    kernel walks for one head (those whose rows, at key positions
    ``q_offset + row``, meet its keys under the masks), as the kernel
    counts them."""
    out = []
    for kt in range(-(-Skv // TILE)):
        k0, k_last = kt * TILE, min(kt * TILE + TILE, Skv) - 1
        first = max(0, k0 - q_offset) // TILE if causal else 0
        q_end = (min(Sq, max(0, k_last + window - q_offset)) if window > 0
                 else Sq)
        out.append(max(0, -(-q_end // TILE) - first))
    return out


def group_split(B: int, Sq: int, Skv: int, Hq: int, Hkv: int, causal: bool,
                window: int, hd: int, q_offset: int = 0) -> int:
    """How many dK/dV blocks share one (kv tile, k/v head, batch): the
    smallest divisor n of Hq // Hkv for which the heaviest block (its kv
    tile's q tiles x Hq // Hkv // n heads) is no longer than the mean work
    of a slot (all blocks' q tiles over ``slots(hd)``); Hq // Hkv if none
    is.  More than 1 adds a pass that sums the n float32 partials."""
    rep = Hq // Hkv
    tiles = band_q_tiles(Sq, Skv, causal, window, q_offset)
    total = B * Hq * sum(tiles)
    for n in range(1, rep + 1):
        if rep % n == 0 and max(tiles, default=0) * (rep // n) * slots(hd) \
                <= total:
            return n
    return rep


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    """Build (first call) and load the attention backward library."""
    lib = _build.load(LIB_NAME, SOURCE, FLAGS)
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.mcsa_attention_bwd_launch.argtypes = [
        p, p, p, p, p, p, p, p, p, p, p, p, i, i, i, i, i, i,
        ctypes.c_float, i, i, i, i, i, i, p]
    lib.mcsa_attention_bwd_launch.restype = ctypes.c_int
    lib.mcsa_attention_bwd_smem.argtypes = [i, i]
    lib.mcsa_attention_bwd_smem.restype = ctypes.c_int
    lib.mcsa_cuda_error_string.argtypes = [ctypes.c_int]
    lib.mcsa_cuda_error_string.restype = ctypes.c_char_p
    return lib


def library_smem_bytes(hd: int, kernel: str) -> int:
    """:func:`smem_bytes` as the library counts it (builds it on first
    use)."""
    return int(library().mcsa_attention_bwd_smem(
        hd, {"dkdv": 0, "dq": 1}[kernel]))


def _check(name: str, t, device) -> None:
    if not torch.is_tensor(t):
        raise TypeError(f"{name}: expected a tensor")
    if t.device.type != "cuda" or t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected q's CUDA device "
                         f"({device})")
    if not t.is_contiguous() or t.data_ptr() % 16:
        raise ValueError(f"{name}: not contiguous or not 16-byte aligned")


def check_args(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               out: torch.Tensor, dout: torch.Tensor, *, causal: bool,
               window: int, lse, out_lo,
               q_offset: Optional[int] = None) -> str:
    """Raise on what the backward kernels refuse on any device: dtypes
    other than one float32 or bfloat16 for q, k, v, out and dout, shapes
    or offsets :func:`.kernel.check_shapes` refuses or out/dout not q's,
    a head_dim
    :func:`body_for` has no body for, bfloat16 without the forward's
    ``lse`` (B, Hq, Sq) float32 and ``out_lo`` (q's shape and dtype),
    float32 with either; else the body."""
    if q.dtype not in DTYPES:
        raise TypeError(f"q: dtype {q.dtype}, expected float32 or bfloat16")
    for name, t in (("k", k), ("v", v), ("out", out), ("dout", dout)):
        if t.dtype != q.dtype:
            raise TypeError(f"{name}: dtype {t.dtype}, expected {q.dtype}")
    check_shapes(q, k, v, causal, window, q_offset)
    if out.shape != q.shape or dout.shape != q.shape:
        raise ValueError(f"attention backward: out {tuple(out.shape)} and "
                         f"dout {tuple(dout.shape)} must have q's shape "
                         f"{tuple(q.shape)}")
    B, Sq, Hq, hd = q.shape
    body = body_for(q.dtype, hd)
    if body == "tensor_cores":
        if lse is None or out_lo is None:
            raise ValueError("attention backward: bfloat16 takes the "
                             "forward's lse and out_lo "
                             "(flash_attention_cuda(stats=True))")
        if lse.dtype != torch.float32 or out_lo.dtype != q.dtype:
            raise TypeError(f"attention backward: lse {lse.dtype} and "
                            f"out_lo {out_lo.dtype}; expected float32 and "
                            f"{q.dtype}")
        if lse.shape != (B, Hq, Sq) or out_lo.shape != q.shape:
            raise ValueError(f"attention backward: lse {tuple(lse.shape)} "
                             f"and out_lo {tuple(out_lo.shape)}; expected "
                             f"{(B, Hq, Sq)} and {tuple(q.shape)}")
    elif lse is not None or out_lo is not None:
        raise ValueError("attention backward: float32 recomputes LSE and "
                         "takes D from out; pass no lse or out_lo")
    return body


def flash_attention_bwd_cuda(q: torch.Tensor, k: torch.Tensor,
                             v: torch.Tensor, out: torch.Tensor,
                             dout: torch.Tensor, *, causal: bool = True,
                             window: int = 0, lse: torch.Tensor = None,
                             out_lo: torch.Tensor = None,
                             q_offset: Optional[int] = None) -> tuple:
    """q, out, dout (B, Sq, Hq, hd), k/v (B, Skv, Hkv, hd), one dtype
    (float32 or bfloat16), contiguous and 16-byte aligned, on one CUDA
    device, ``out`` the forward's output for (q, k, v) -> (dq, dk, dv) in
    that dtype.  bfloat16 also takes the training forward's ``lse``
    (B, Hq, Sq) float32 and ``out_lo`` (out's shape and dtype); float32
    takes neither.  hd 32, 64, 128 or 256; any other raises.
    ``q_offset``: query row i at key position q_offset + i."""
    if not torch.is_tensor(q):
        raise TypeError("q: expected a tensor")
    for name, t in (("q", q), ("k", k), ("v", v), ("out", out),
                    ("dout", dout)):
        _check(name, t, q.device)
    for name, t in (("lse", lse), ("out_lo", out_lo)):
        if t is not None:
            _check(name, t, q.device)
    body = check_args(q, k, v, out, dout, causal=causal, window=window,
                      lse=lse, out_lo=out_lo, q_offset=q_offset)
    off = int(q_offset or 0)
    B, Sq, Hq, hd = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    tc = body == "tensor_cores"
    dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
    if q.numel() == 0 or k.numel() == 0:
        return dq.zero_(), dk.zero_(), dv.zero_()
    nsplit, partial = 1, None
    if tc:
        scratch = torch.empty((B, Hq, -(-Sq // TILE) * TILE, 2),
                              dtype=torch.float32, device=q.device)
        nsplit = group_split(B, Sq, Skv, Hq, Hkv, causal, window, hd, off)
        if nsplit > 1:
            partial = torch.empty((2, nsplit, B, Skv, Hkv, hd),
                                  dtype=torch.float32, device=q.device)
    else:
        scratch = torch.empty((2, B, Hq, Sq), dtype=torch.float32,
                              device=q.device)
    lib = library()
    stream = torch._C._cuda_getCurrentRawStream(q.device.index)
    rc = lib.mcsa_attention_bwd_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        out_lo.data_ptr() if tc else None, dout.data_ptr(),
        lse.data_ptr() if tc else None, dq.data_ptr(), dk.data_ptr(),
        dv.data_ptr(), scratch.data_ptr(),
        partial.data_ptr() if partial is not None else None, B, Sq, Skv, Hq,
        Hkv, hd, float(hd ** -0.5), int(bool(causal)), int(window), off,
        DTYPES[q.dtype], BODIES[body], nsplit, stream)
    if rc != 0:
        msg = lib.mcsa_cuda_error_string(rc).decode()
        raise RuntimeError(f"attention backward launch failed: {msg} ({rc})")
    LAUNCHES["flash_attention_bwd"] += 1
    if tc:
        LAUNCHES["flash_attention_bwd_tc"] += 1
    return dq, dk, dv
