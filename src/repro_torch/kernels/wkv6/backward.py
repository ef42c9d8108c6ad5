"""ctypes wrapper of the CUDA WKV6 backward (``csrc/wkv6_bwd.cu``).

The library is built by :mod:`repro_torch.kernels._build` at the first
launch, never at import.  :func:`wkv6_bwd_cuda` checks its inputs,
allocates the gradients, du's partials and the body's float32 workspace
with ``torch.empty``, launches on the current stream without
synchronising, and raises if the launch was refused.  du is the partials
summed in a fixed order.  ``LAUNCHES["wkv6_bwd"]`` counts each successful
call, ``LAUNCHES["wkv6_bwd_serial"]`` / ``["wkv6_bwd_chunked"]`` those of
each body, nowhere else.

The body follows S and the head size exactly as the forward's does
(:func:`body_for` is :func:`.kernel.body_for`): past one chunk at head
size 64 the chunked body (five launches over a workspace of each chunk's
start state, the gradient after it and the states before its
sub-chunks), else the serial one (one launch over states checkpointed
every ``SEGMENT`` steps).
"""
from __future__ import annotations

import ctypes
import functools
from pathlib import Path
from typing import Optional

import torch

from repro_torch.kernels import _build

from .kernel import BODIES, DTYPES, HEAD_SIZES, body_for, check_shapes
from .ref import CHUNK

SOURCE = Path(__file__).resolve().parent / "csrc" / "wkv6_bwd.cu"
LIB_NAME = "mcsa_wkv6_bwd"
FLAGS = _build.NVCC_FLAGS

#: launches since the last reset (callers may zero it)
LAUNCHES = {"wkv6_bwd": 0, "wkv6_bwd_serial": 0, "wkv6_bwd_chunked": 0}

#: steps between the workspace's checkpointed states (``SEG`` in the
#: source; the library reports its count)
SEGMENT = 8


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    """Build (first call) and load the WKV6 backward library."""
    lib = _build.load(LIB_NAME, SOURCE, FLAGS)
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.mcsa_wkv6_bwd_launch.argtypes = [p] * 15 + [i] * 6 + [p]
    lib.mcsa_wkv6_bwd_launch.restype = ctypes.c_int
    lib.mcsa_wkv6_bwd_segments.argtypes = [i]
    lib.mcsa_wkv6_bwd_segments.restype = ctypes.c_int
    if lib.mcsa_wkv6_bwd_segments(SEGMENT + 1) != 2:
        raise RuntimeError("wkv6 backward: the library's segment is not "
                           f"{SEGMENT} steps")
    lib.mcsa_wkv6_bwd_chunk.argtypes = []
    lib.mcsa_wkv6_bwd_chunk.restype = ctypes.c_int
    if lib.mcsa_wkv6_bwd_chunk() != CHUNK:
        raise RuntimeError(f"wkv6 backward: the library's chunk is "
                           f"{lib.mcsa_wkv6_bwd_chunk()}, ref.CHUNK {CHUNK}")
    lib.mcsa_wkv6_bwd_workspace_floats.argtypes = [i] * 5
    lib.mcsa_wkv6_bwd_workspace_floats.restype = ctypes.c_longlong
    for body, code in BODIES.items():
        got = lib.mcsa_wkv6_bwd_workspace_floats(3, 200, 5, 64, code)
        if 4 * got != workspace_bytes(3, 200, 5, 64, body):
            raise RuntimeError(f"wkv6 backward: the {body} body's "
                               f"workspace is {4 * got} bytes in the "
                               "library, workspace_bytes says "
                               f"{workspace_bytes(3, 200, 5, 64, body)}")
    lib.mcsa_cuda_error_string.argtypes = [ctypes.c_int]
    lib.mcsa_cuda_error_string.restype = ctypes.c_char_p
    return lib


def workspace_bytes(B: int, S: int, H: int, n: int,
                    body: Optional[str] = None) -> int:
    """Bytes of the float32 workspace of ``body`` (the one :func:`body_for`
    picks when None): serial, the states checkpointed every SEGMENT steps
    of every (batch, head); chunked, each chunk's start state and the
    gradient after it (n x n each), its decays (n) and the states before
    its sub-chunks 1-3 (3 n x n)."""
    body = body or body_for(S, n)
    if body == "serial":
        return 4 * B * H * -(-S // SEGMENT) * n * n
    nc = -(-S // CHUNK)
    return 4 * B * H * (5 * nc * n * n + nc * n)


def wkv6_bwd_cuda(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  w: torch.Tensor, u: torch.Tensor,
                  s0: Optional[torch.Tensor], dy: torch.Tensor,
                  ds: Optional[torch.Tensor] = None) -> tuple:
    """r, k, v (B, S, H, n) in one dtype (float32 or bfloat16); w, dy
    (B, S, H, n), u (H, n), s0 and ds (B, H, n, n) or None, all float32;
    n 32 or 64; contiguous, on one CUDA device -> (dr, dk, dv in r's
    dtype, dw, du, ds0 float32; ds0 None when s0 is None): the gradients
    of :func:`.kernel.wkv6_cuda`'s (y, final state) for (dy, ds)."""
    if not torch.is_tensor(r) or r.dtype not in DTYPES:
        raise TypeError("r: expected a float32 or bfloat16 tensor")
    f32 = torch.float32
    for name, t, dtype in (("r", r, r.dtype), ("k", k, r.dtype),
                           ("v", v, r.dtype), ("w", w, f32), ("u", u, f32),
                           ("s0", s0, f32), ("dy", dy, f32), ("ds", ds, f32)):
        if t is None and name in ("s0", "ds"):
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
    check_shapes(r, k, v, w, u, s0, ds)
    if dy.shape != r.shape:
        raise ValueError(f"wkv6 backward: dy {tuple(dy.shape)} != r "
                         f"{tuple(r.shape)}")
    B, S, H, n = r.shape
    if n not in HEAD_SIZES:
        raise ValueError(f"wkv6 backward: head size {n}, expected one of "
                         f"{HEAD_SIZES}")
    if r.numel() == 0:
        raise ValueError(f"wkv6 backward: empty input {tuple(r.shape)}")
    body = body_for(S, n)
    if body == "chunked" and B * H > 65535:
        raise ValueError(f"wkv6 backward: B·H {B * H} > 65535")
    dr, dk, dv = (torch.empty_like(t) for t in (r, k, v))
    dw = torch.empty_like(w)
    ds0 = None if s0 is None else torch.empty_like(s0)
    part = torch.empty((B, H, n) if body == "serial" else
                       (B, H, -(-S // CHUNK), n), dtype=f32, device=r.device)
    ws = torch.empty(workspace_bytes(B, S, H, n, body) // 4, dtype=f32,
                     device=r.device)
    lib = library()
    stream = torch.cuda.current_stream(r.device).cuda_stream

    def ptr(t):
        return None if t is None else t.data_ptr()

    rc = lib.mcsa_wkv6_bwd_launch(
        r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(),
        u.data_ptr(), ptr(s0), dy.data_ptr(), ptr(ds), dr.data_ptr(),
        dk.data_ptr(), dv.data_ptr(), dw.data_ptr(), part.data_ptr(),
        ptr(ds0), ws.data_ptr(), B, S, H, n, DTYPES[r.dtype], BODIES[body],
        stream)
    if rc != 0:
        msg = lib.mcsa_cuda_error_string(rc).decode()
        raise RuntimeError(f"wkv6 backward launch failed: {msg} ({rc})")
    LAUNCHES["wkv6_bwd"] += 1
    LAUNCHES["wkv6_bwd_" + body] += 1
    du = part.sum(dim=0) if body == "serial" else part.sum(dim=(0, 2))
    return dr, dk, dv, dw, du, ds0
