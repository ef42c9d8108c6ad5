"""ctypes wrapper of the CUDA WKV6 kernel (``csrc/wkv6.cu``).

The library is built by :mod:`repro_torch.kernels._build` at the first
launch, never at import.  :func:`wkv6_cuda` checks its inputs, allocates
what the caller did not give with ``torch.empty``, launches on the
current stream without synchronising, and raises if the launch was
refused.  ``LAUNCHES["wkv6"]`` counts every successful call, and
``LAUNCHES["wkv6_serial"]`` / ``LAUNCHES["wkv6_chunked"]`` those of each
body, nowhere else.

The body follows S and the head size, explicitly (:func:`body_for`):
up to one chunk (``CHUNK`` steps, decode at S 1 among them) runs the
serial body, longer sequences at head size 64 the chunked one (three
launches over a float32 workspace of the chunks' start states,
allocated here).
"""
from __future__ import annotations

import ctypes
import functools
from pathlib import Path
from typing import Optional, Tuple

import torch

from repro_torch.kernels import _build

from .ref import CHUNK

SOURCE = Path(__file__).resolve().parent / "csrc" / "wkv6.cu"
LIB_NAME = "mcsa_wkv6"
FLAGS = _build.NVCC_FLAGS

#: launches since the last reset (callers may zero it)
LAUNCHES = {"wkv6": 0, "wkv6_serial": 0, "wkv6_chunked": 0}

DTYPES = {torch.float32: 0, torch.bfloat16: 1}
HEAD_SIZES = (32, 64)
#: the library's body codes
BODIES = {"serial": 0, "chunked": 1}


#: head sizes the chunked body is built for (rwkv6-3b's)
CHUNKED_HEAD_SIZES = (64,)


def body_for(S: int, n: int) -> str:
    """The body that runs S steps of head size n: ``"chunked"`` past one
    chunk (``CHUNK`` steps) at a head size it is built for, else
    ``"serial"`` (its B·H blocks walk every step; decode at S 1)."""
    return ("chunked" if S > CHUNK and n in CHUNKED_HEAD_SIZES
            else "serial")


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    """Build (first call) and load the WKV6 library, with argtypes."""
    lib = _build.load(LIB_NAME, SOURCE, FLAGS)
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.mcsa_wkv6_launch.argtypes = [p, p, p, p, p, p, p, p, p, p, i, i,
                                     i, i, i, i, p]
    lib.mcsa_wkv6_launch.restype = ctypes.c_int
    lib.mcsa_wkv6_chunk.argtypes = []
    lib.mcsa_wkv6_chunk.restype = ctypes.c_int
    if lib.mcsa_wkv6_chunk() != CHUNK:
        raise RuntimeError(f"wkv6: the library's chunk is "
                           f"{lib.mcsa_wkv6_chunk()}, ref.CHUNK {CHUNK}")
    lib.mcsa_cuda_error_string.argtypes = [ctypes.c_int]
    lib.mcsa_cuda_error_string.restype = ctypes.c_char_p
    return lib


def check_shapes(r, k, v, w, u, s0=None, state_out=None) -> None:
    """Raise unless r, k, v, w are (B, S, H, n), u (H, n) and the states
    (B, H, n, n)."""
    if r.dim() != 4:
        raise ValueError(f"wkv6: r {tuple(r.shape)}, expected (B, S, H, n)")
    B, S, H, n = r.shape
    for name, t in (("k", k), ("v", v), ("w", w)):
        if t.shape != r.shape:
            raise ValueError(f"wkv6: {name} {tuple(t.shape)} != r "
                             f"{tuple(r.shape)}")
    if tuple(u.shape) != (H, n):
        raise ValueError(f"wkv6: u {tuple(u.shape)}, expected {(H, n)}")
    for name, t in (("s0", s0), ("state_out", state_out)):
        if t is not None and tuple(t.shape) != (B, H, n, n):
            raise ValueError(f"wkv6: {name} {tuple(t.shape)}, expected "
                             f"{(B, H, n, n)}")


def wkv6_cuda(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              w: torch.Tensor, u: torch.Tensor,
              s0: Optional[torch.Tensor] = None,
              state_out: Optional[torch.Tensor] = None
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """r, k, v (B, S, H, n) in one dtype (float32 or bfloat16); w
    (B, S, H, n), u (H, n), s0 (B, H, n, n) or None, all float32; n 32 or
    64; contiguous (r, k, v, w 16-byte aligned), on one CUDA device.
    Returns (y (B, S, H, n) float32, the final state): written into
    ``state_out`` (float32, may be ``s0`` itself) when given, else into
    a new tensor."""
    if not torch.is_tensor(r) or r.dtype not in DTYPES:
        raise TypeError("r: expected a float32 or bfloat16 tensor")
    for name, t, dtype in (("r", r, r.dtype), ("k", k, r.dtype),
                           ("v", v, r.dtype), ("w", w, torch.float32),
                           ("u", u, torch.float32),
                           ("s0", s0, torch.float32),
                           ("state_out", state_out, torch.float32)):
        if t is None and name in ("s0", "state_out"):
            continue
        if not torch.is_tensor(t):
            raise TypeError(f"{name}: expected a tensor")
        if t.device.type != "cuda" or t.device != r.device:
            raise ValueError(f"{name}: on {t.device}, expected r's CUDA "
                             f"device ({r.device})")
        if t.dtype != dtype:
            raise TypeError(f"{name}: dtype {t.dtype}, expected {dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: not contiguous")
        if name in ("r", "k", "v", "w") and t.data_ptr() % 16:
            raise ValueError(f"{name}: not 16-byte aligned")
    check_shapes(r, k, v, w, u, s0, state_out)
    B, S, H, n = r.shape
    if n not in HEAD_SIZES:
        raise ValueError(f"wkv6: head size {n}, expected one of "
                         f"{HEAD_SIZES}")
    y = torch.empty(r.shape, dtype=torch.float32, device=r.device)
    s_final = (state_out if state_out is not None else
               torch.empty((B, H, n, n), dtype=torch.float32,
                           device=r.device))
    if B == 0 or H == 0:
        return y, s_final
    lib = library()
    body = body_for(S, n)
    ws = pw = None
    if body == "chunked":
        nc = -(-S // CHUNK)
        ws = torch.empty((B * H, nc, n, n), dtype=torch.float32,
                         device=r.device)
        pw = torch.empty((B * H, nc, n), dtype=torch.float32,
                         device=r.device)
    stream = torch.cuda.current_stream(r.device).cuda_stream
    rc = lib.mcsa_wkv6_launch(
        r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(),
        u.data_ptr(), None if s0 is None else s0.data_ptr(), y.data_ptr(),
        s_final.data_ptr(), None if ws is None else ws.data_ptr(),
        None if pw is None else pw.data_ptr(), B, S, H, n, DTYPES[r.dtype],
        BODIES[body], stream)
    if rc != 0:
        msg = lib.mcsa_cuda_error_string(rc).decode()
        raise RuntimeError(f"wkv6 kernel launch failed: {msg} ({rc})")
    LAUNCHES["wkv6"] += 1
    LAUNCHES["wkv6_" + body] += 1
    return y, s_final
