"""Attention paths of the dense decoder in plain PyTorch: decode against
a KV cache, and the reference softmax attention.

The port of the JAX package's ``repro/models/attention.py``.  Every path
is GQA-grouped: q has Hq heads, k/v Hkv <= Hq, and the group structure
(rep = Hq // Hkv) is carried through the products, so the cache is never
widened to Hq heads.

* Prefill attention is not here: the reference's model code calls its
  chunked-jnp ``flash_attention``; the port's ``models/transformer.py``
  calls the same contract through
  :mod:`repro_torch.kernels.flash_attention.ops` (the CUDA kernel on the
  card, the plain version on the CPU).
* :func:`decode_attention` — one query token against the cache, with
  per-sequence positions (continuous batching).  Plain tensor code, as in
  the reference (a candidate kernel: ROADMAP).
* :func:`decode_attention_partial` — the same over one rank's slots of
  a cache whose length is sharded over a mesh: the float32 partial
  (max, sum of exponentials, weighted values) that the ranks merge.
* :func:`naive_attention` — the reference softmax attention (ends of q
  and k aligned) that tests hold the others against.
* :func:`quantize_kv` — int8 codes of k or v with one float32 scale a
  row, for the int8 KV cache.

Sliding-window (local) layers keep a ring-buffer cache: slot ``j``
holds position ``pos - ((pos - j) mod L)``.
"""
from __future__ import annotations

from typing import Optional

import torch

NEG_INF = -1e30


def _mask_bias(mask: torch.Tensor) -> torch.Tensor:
    zero = torch.zeros((), dtype=torch.float32, device=mask.device)
    return torch.where(mask, zero, torch.full_like(zero, NEG_INF))


def _group(q: torch.Tensor, Hkv: int) -> torch.Tensor:
    """(B, S, Hq, hd) -> (B, S, Hkv, rep, hd)."""
    B, S, Hq, hd = q.shape
    return q.reshape(B, S, Hkv, Hq // Hkv, hd)


def naive_attention(q, k, v, *, causal: bool = True, window: int = 0,
                    q_positions=None, kv_positions=None,
                    scale: Optional[float] = None) -> torch.Tensor:
    """Reference: q (B,Sq,Hq,hd), k/v (B,Skv,Hkv,hd), Hkv | Hq ->
    (B,Sq,Hq,hd); causal aligns the last query with the last key."""
    B, Sq, Hq, hd = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    scale = scale if scale is not None else hd ** -0.5
    dev = q.device
    if q_positions is None:
        q_positions = torch.arange(Sq, device=dev) + (Skv - Sq if causal else 0)
    if kv_positions is None:
        kv_positions = torch.arange(Skv, device=dev)
    qg = _group(q, Hkv).float()
    scores = torch.einsum("bqgrd,bkgd->bgrqk", qg, k.float()) * scale
    dq = q_positions[:, None]
    dk = kv_positions[None, :]
    mask = torch.ones((Sq, Skv), dtype=torch.bool, device=dev)
    if causal:
        mask &= dq >= dk
    if window > 0:
        mask &= (dq - dk) < window
    scores = scores + _mask_bias(mask)
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bgrqk,bkgd->bqgrd", probs, v.float())
    return out.reshape(B, Sq, Hq, hd).to(q.dtype)


def decode_attention(q, cache_k, cache_v, pos, *, window: int = 0,
                     scale: Optional[float] = None, k_scale=None,
                     v_scale=None) -> torch.Tensor:
    """q (B,1,Hq,hd); cache_k/v (B,L,Hkv,hd); pos: the position of the
    query token, an int or a (B,) tensor of per-sequence positions.
    Global layers (``window`` 0): slots 0..pos are valid.  Local layers:
    the cache is a ring of L slots, slot j holds position
    ``pos - ((pos - j) mod L)``, valid when that position is >= 0 and
    within ``window`` of ``pos``.  Scores and probabilities in float32.

    ``k_scale``/``v_scale`` (B,L,Hkv): the per-row scales of an int8
    cache.  They fold into the scores and the probabilities, so no
    dequantized copy of the cache is made.  The codes enter the products
    as they are: jnp promotes int8 x bf16 to bf16 and accumulates in
    float32, and every code and bf16 value is exact in float32, so the
    float32 products here are the same."""
    B, _, Hq, hd = q.shape
    L, Hkv = cache_k.shape[1], cache_k.shape[2]
    scale = scale if scale is not None else hd ** -0.5
    qg = _group(q, Hkv).float()                          # (B,1,Hkv,rep,hd)
    s = torch.einsum("bqgrd,bkgd->bgrqk", qg, cache_k.float()) * scale
    if k_scale is not None:
        s = s * k_scale.transpose(1, 2)[:, :, None, None, :]
    slots = torch.arange(L, device=q.device)
    p = torch.as_tensor(pos, device=q.device)
    if p.dim() == 1:
        p = p[:, None]                                   # (B,1) vs (L,)
    if window > 0:
        slot_pos = p - torch.remainder(p - slots, L)     # ring positions
        valid = (slot_pos >= 0) & (slot_pos <= p) & ((p - slot_pos) < window)
    else:
        valid = slots <= p
    bias = _mask_bias(valid)                             # (L,) or (B, L)
    bias = bias[:, None, None, None, :] if bias.dim() == 2 else bias
    probs = torch.softmax(s + bias, dim=-1)
    if v_scale is not None:
        probs = probs * v_scale.transpose(1, 2)[:, :, None, None, :]
    out = torch.einsum("bgrqk,bkgd->bqgrd", probs, cache_v.float())
    return out.reshape(B, 1, Hq, hd).to(q.dtype)


def decode_attention_partial(q, cache_k, cache_v, pos, *, window: int = 0,
                             first: int = 0, length: Optional[int] = None,
                             scale: Optional[float] = None, k_scale=None,
                             v_scale=None) -> tuple:
    """:func:`decode_attention` over one piece of a cache whose length is
    sharded: ``cache_k``/``cache_v`` (B, L, Hkv, hd) hold slots
    [first, first + L) of a cache of ``length`` slots (a ring of
    ``length`` slots for a local layer), the int8 scales likewise.
    Returns the float32 partial, relative to this piece's own max: (m,
    l) (B, 1, Hq, 1), each head's max score and sum of exponentials, and
    o (B, 1, Hq, hd), the exponentials times v (times ``v_scale``).
    Pieces merge as the online softmax does: with M the max of the m's,
    out = sum(o·e^(m−M)) / sum(l·e^(m−M)).  A piece with no valid slot
    has m near -1e30 and weighs nothing in the merge."""
    B, _, Hq, hd = q.shape
    L, Hkv = cache_k.shape[1], cache_k.shape[2]
    length = L if length is None else length
    scale = scale if scale is not None else hd ** -0.5
    qg = _group(q, Hkv).float()                          # (B,1,Hkv,rep,hd)
    s = torch.einsum("bqgrd,bkgd->bgrqk", qg, cache_k.float()) * scale
    if k_scale is not None:
        s = s * k_scale.transpose(1, 2)[:, :, None, None, :]
    slots = first + torch.arange(L, device=q.device)
    p = torch.as_tensor(pos, device=q.device)
    if p.dim() == 1:
        p = p[:, None]                                   # (B,1) vs (L,)
    if window > 0:
        slot_pos = p - torch.remainder(p - slots, length)
        valid = (slot_pos >= 0) & (slot_pos <= p) & ((p - slot_pos) < window)
    else:
        valid = slots <= p
    bias = _mask_bias(valid)
    bias = bias[:, None, None, None, :] if bias.dim() == 2 else bias
    s = s + bias
    m = s.amax(dim=-1, keepdim=True)                     # (B,Hkv,rep,1,1)
    e = torch.exp(s - m)
    l = e.sum(dim=-1, keepdim=True)
    if v_scale is not None:
        e = e * v_scale.transpose(1, 2)[:, :, None, None, :]
    o = torch.einsum("bgrqk,bkgd->bqgrd", e, cache_v.float())
    return (m.reshape(B, 1, Hq, 1), l.reshape(B, 1, Hq, 1),
            o.reshape(B, 1, Hq, hd))


def quantize_kv(x: torch.Tensor):
    """(B,S,Hkv,hd) -> (int8 codes, (B,S,Hkv) float32 scales), one scale
    a row: ``max|x| / 127`` floored at 1e-8, codes rounded half to even
    (``torch.round``, as ``jnp.round``) and clipped to [-127, 127].
    Both divisions are true float32 divisions on either device: the
    divisor 127 is a tensor, since CUDA divides by a Python scalar
    through its reciprocal, which can miss the quotient by an ulp and
    move a code across a rounding tie."""
    xf = x.float()
    d = torch.full((), 127.0, dtype=torch.float32, device=xf.device)
    s = torch.clamp(xf.abs().amax(dim=-1) / d, min=1e-8)
    q = torch.clamp(torch.round(xf / s[..., None]), -127, 127)
    return q.to(torch.int8), s


__all__ = ["NEG_INF", "decode_attention", "decode_attention_partial",
           "naive_attention", "quantize_kv"]
