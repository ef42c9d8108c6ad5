"""ctypes wrapper of the CUDA flash-attention kernel
(``csrc/flash_attention.cu``).

The library is built by :mod:`repro_torch.kernels._build` at the first
launch, never at import.  :func:`flash_attention_cuda` checks its
inputs, allocates the output with ``torch.empty``, launches on the
current stream without synchronising, and raises if the launch was
refused.  ``LAUNCHES["flash_attention"]`` counts every successful launch
and ``LAUNCHES["flash_attention_tc"]`` those of the tensor-core body,
nowhere else.  A training forward (``stats=True``, bfloat16) also
returns each row's log-sum-exp and the output's rounding residual, what
the tensor-core backward (``backward.py``) takes; ``out``'s bits do not
change.  In float32 ``stats=True`` returns the log-sum-exp alone (no
residual: the output is float32), what the serving merge over a
sharded cross cache takes (``models/transformer.py``).

The body follows the dtype, explicitly (:func:`body_for`): bfloat16 runs
the tensor-core body (wgmma, bf16 tiles), float32 the CUDA-core body
(fp32 FMAs, so the float32 path keeps full float32 products).  The
launch names the body and the library refuses any other pairing, so a
bfloat16 tensor never reaches the CUDA-core body.
"""
from __future__ import annotations

import ctypes
import functools
from pathlib import Path

import torch

from repro_torch.kernels import _build

SOURCE = Path(__file__).resolve().parent / "csrc" / "flash_attention.cu"
LIB_NAME = "mcsa_flash_attention"
FLAGS = _build.NVCC_FLAGS

#: launches since the last reset (callers may zero it)
LAUNCHES = {"flash_attention": 0, "flash_attention_tc": 0}

DTYPES = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIMS = (32, 64, 128, 256)
#: the library's body codes
BODIES = {"cuda_cores": 0, "tensor_cores": 1}


def body_for(dtype: torch.dtype, hd: int) -> str:
    """The kernel body that runs ``dtype`` at head_dim ``hd``:
    ``"tensor_cores"`` for bfloat16, ``"cuda_cores"`` for float32; raises
    for any other dtype or head_dim (no fallback)."""
    if hd not in HEAD_DIMS:
        raise ValueError(f"attention: head_dim {hd}, expected one of "
                         f"{HEAD_DIMS}")
    if dtype == torch.bfloat16:
        return "tensor_cores"
    if dtype == torch.float32:
        return "cuda_cores"
    raise TypeError(f"attention: dtype {dtype}, expected float32 or "
                    "bfloat16")


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    """Build (first call) and load the attention library, with argtypes."""
    lib = _build.load(LIB_NAME, SOURCE, FLAGS)
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.mcsa_flash_attention_launch.argtypes = [
        p, p, p, p, p, p, i, i, i, i, i, i, ctypes.c_float, i, i, i, i, p]
    lib.mcsa_flash_attention_launch.restype = ctypes.c_int
    lib.mcsa_flash_attention_smem.argtypes = [i, i]
    lib.mcsa_flash_attention_smem.restype = ctypes.c_int
    lib.mcsa_cuda_error_string.argtypes = [ctypes.c_int]
    lib.mcsa_cuda_error_string.restype = ctypes.c_char_p
    return lib


def smem_bytes(hd: int, body: str) -> int:
    """Dynamic shared memory one block of ``body`` takes at head_dim
    ``hd`` (builds the library on first use)."""
    return int(library().mcsa_flash_attention_smem(hd, BODIES[body]))


def check_shapes(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 causal: bool, window: int) -> None:
    """Raise on what neither version takes: shapes that are not
    (B, S, H, hd) with matching B/hd, Hkv not dividing Hq, k/v shapes that
    differ, a negative window, or causal attention with Sq != Skv (the
    kernel aligns q 0 with k 0, while ``models.attention.naive_attention``
    aligns the ends: prefill always has Sq == Skv)."""
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(f"attention: shapes q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)}; expected "
                         "(B, Sq, Hq, hd) and two equal (B, Skv, Hkv, hd)")
    B, Sq, Hq, hd = q.shape
    Bk, Skv, Hkv, hdk = k.shape
    if Bk != B or hdk != hd or Hkv == 0 or Hq % Hkv:
        raise ValueError(f"attention: q {tuple(q.shape)} and k "
                         f"{tuple(k.shape)} disagree on B or hd, or Hkv "
                         "does not divide Hq")
    if window < 0:
        raise ValueError(f"attention: window {window} < 0")
    if causal and Sq != Skv:
        raise ValueError(f"attention: causal with Sq={Sq} != Skv={Skv} is "
                         "refused (q 0 would align with k 0, not with the "
                         "end of the keys)")


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         *, causal: bool = True, window: int = 0,
                         stats: bool = False):
    """q (B, Sq, Hq, hd), k/v (B, Skv, Hkv, hd), one dtype (float32 or
    bfloat16), contiguous and 16-byte aligned, on one CUDA device ->
    (B, Sq, Hq, hd) in that dtype.

    ``stats=True`` returns ``(out, lse, out_lo)``: ``out`` with the same
    bits, each row's log-sum-exp of the scaled scores in base 2 (B, Hq,
    Sq) float32, and in bfloat16 ``out_lo`` = bf16(o − out) of the
    float32 output o (see ``ref.attention_ref``), in float32 None."""
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not torch.is_tensor(t):
            raise TypeError(f"{name}: expected a tensor")
        if t.device.type != "cuda" or t.device != q.device:
            raise ValueError(f"{name}: on {t.device}, expected q's CUDA "
                             f"device ({q.device})")
        if t.dtype not in DTYPES or t.dtype != q.dtype:
            raise TypeError(f"{name}: dtype {t.dtype}, expected float32 or "
                            "bfloat16, the same for q, k and v")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name}: not contiguous or not 16-byte "
                             "aligned")
    check_shapes(q, k, v, causal, window)
    B, Sq, Hq, hd = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    body = body_for(q.dtype, hd)
    out = torch.empty_like(q)
    lse = out_lo = None
    if stats:
        lse = torch.empty((B, Hq, Sq), dtype=torch.float32,
                          device=q.device)
        if body == "tensor_cores":
            out_lo = torch.empty_like(q)
    if out.numel() == 0:
        return (out, lse, out_lo) if stats else out
    lib = library()
    stream = torch.cuda.current_stream(q.device).cuda_stream
    rc = lib.mcsa_flash_attention_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        lse.data_ptr() if stats else None,
        out_lo.data_ptr() if out_lo is not None else None, B, Sq, Skv, Hq,
        Hkv, hd,
        float(hd ** -0.5), int(bool(causal)), int(window), DTYPES[q.dtype],
        BODIES[body], stream)
    if rc != 0:
        msg = lib.mcsa_cuda_error_string(rc).decode()
        raise RuntimeError(f"flash attention launch failed: {msg} ({rc})")
    LAUNCHES["flash_attention"] += 1
    if body == "tensor_cores":
        LAUNCHES["flash_attention_tc"] += 1
    return (out, lse, out_lo) if stats else out
