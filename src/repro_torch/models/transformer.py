"""Decoder stacks on one card: init, prefill and decode.

The port of the JAX package's ``repro/models/transformer.py`` for four
families: the dense decoder (RMSNorm, global or sliding-window causal
GQA attention with RoPE and optional qk-norm, a SwiGLU MLP), the MoE
decoder (the same attention, a routed expert FFN, :mod:`.moe`), RWKV-6
(time mix and channel mix, :mod:`.rwkv`) and the RecurrentGemma hybrid
(RG-LRU blocks, :mod:`.rglru`, between sliding-window MQA blocks); then
a final norm and an untied or tied unembedding.  Both norms of every
block and the final norm go through the RMSNorm kernel, prefill
attention through the flash-attention kernel, the experts through the
fused expert SwiGLU kernel, the WKV recurrence through the WKV6 kernel
and the RG-LRU recurrence through the RG-LRU scan kernel
(``kernels/``); the projections and the unembedding are plain matrix
products, as the reference leaves them to XLA.

Parameters are a plain dict: ``embed`` (Vp, d), ``final_norm`` (d,),
``unembed`` (d, Vp) unless tied, and ``layers``, a list with one dict per
block (``ln1``, ``mix``, ``ln2``, ``ffn``; ``mix`` = {wq, wk, wv, wo[,
q_norm, k_norm]}, the time mix or the RG-LRU's {wx, wy, wo, conv_w,
gate_a, gate_i, a_param}, ``ffn`` = {wg, wu, wd}, the MoE's {router, wg,
wu, wd} or the channel mix).  The reference stacks blocks
on a superblock axis for ``lax.scan``; PyTorch runs eagerly, so a Python
loop over the list takes its place.

Caches are a list with one dict per block: ``{"k", "v"}`` of
(B, L, Hkv, hd) for an attention block, ``{"mix": {"s", "tm"}, "ffn":
{"cm"}}`` for an RWKV-6 block and ``{"mix": {"h", "conv"}}`` for an
RG-LRU block (the reference's trees).  A sliding-window block's k/v are
a ring of L = min(window, cache length) slots, slot ``pos mod L``; the
reference's prefill always returns a ring of ``window`` rows, which
does not fit its own pool when the cache length is below the window
(ROADMAP §3), so the port's prefill ring is min(window, max(cache
length, S)) rows, the pool's size.  Decode writes each new k/v row, and
the new recurrent state, into the cache in place (JAX returns an
updated copy) and returns the same list.

The int8 KV cache (``kv_quant``) keeps int8 ``k``/``v`` codes and
float32 ``k_scale``/``v_scale`` of (B, L, Hkv), one scale a row
(:func:`.attention.quantize_kv`); prefill quantizes after attention and
decode quantizes each new row, as the reference does.

The encoder-decoder stack (``cfg.enc_dec``, seamless-m4t) adds an
``encoder`` list of non-causal attention blocks and ``enc_norm``; each
decoder block gains ``ln_cross`` and ``cross`` (attention to the encoder
output, no RoPE, no qk-norm), and its cache a ``"cross"`` entry
``{"k", "v"}`` of (B, Ss, Hkv, hd): built from the encoder output at
prefill, carried unchanged by decode.

MoE capacity factors are the reference's (``CAPACITY_FACTOR``,
``DECODE_CAPACITY_FACTOR``).
"""
from __future__ import annotations

import dataclasses
import math
from typing import List, Optional

import torch

from repro_torch.configs.base import (ATTN_GLOBAL, ATTN_LOCAL, RGLRU, RWKV6,
                                      ModelConfig)
from repro_torch.kernels.flash_attention import ops as flash_ops
from . import attention as attn_lib
from .attention import quantize_kv
from .layers import (apply_mlp, apply_rope, init_attention, init_mlp,
                     init_norm, param_dtype, rms_norm)
from .moe import apply_moe, init_moe
from .rglru import (apply_rglru_decode, apply_rglru_seq, init_rglru,
                    init_rglru_state)
from .rwkv import (apply_channel_mix, apply_time_mix, init_rwkv_channel_mix,
                   init_rwkv_state, init_rwkv_time_mix)
from .sharded_ops import (embed_lookup, padded_vocab, sharded_argmax,
                          unembed_logits)

Params = dict

#: MoE capacity factors, the reference's defaults: ``apply_block`` (and so
#: prefill and both halves of the split path, decode included) uses 1.25,
#: ``decode_step`` 2.0
CAPACITY_FACTOR = 1.25
DECODE_CAPACITY_FACTOR = 2.0


def check_supported(cfg: ModelConfig) -> None:
    """Raise ``ValueError`` for a layer type the port does not know."""
    for lt in dict.fromkeys(cfg.layer_types()):
        if lt not in (ATTN_GLOBAL, ATTN_LOCAL, RGLRU, RWKV6):
            raise ValueError(f"unknown layer type {lt!r}")


def encoder_cfg(cfg: ModelConfig) -> ModelConfig:
    """The encoder stack's config: ``num_enc_layers`` global attention
    blocks."""
    return dataclasses.replace(cfg, num_layers=cfg.num_enc_layers,
                               pattern=(ATTN_GLOBAL,), enc_dec=False)


# ===========================================================================
# Init
# ===========================================================================
def init_block(cfg: ModelConfig, gen: torch.Generator, device,
               layer_type: str = ATTN_GLOBAL, cross: bool = False) -> Params:
    """One block; ``cross`` adds the decoder's ``ln_cross`` and ``cross``
    attention (an encoder-decoder stack)."""
    rwkv = layer_type == RWKV6
    init_mix = {RWKV6: init_rwkv_time_mix, RGLRU: init_rglru}.get(
        layer_type, init_attention)
    p = {"ln1": init_norm(cfg, device), "mix": init_mix(cfg, gen, device)}
    if cross:
        p["ln_cross"] = init_norm(cfg, device)
        p["cross"] = init_attention(cfg, gen, device, cross=True)
    p["ln2"] = init_norm(cfg, device)
    if rwkv:
        p["ffn"] = init_rwkv_channel_mix(cfg, gen, device)
    elif cfg.num_experts:
        p["ffn"] = init_moe(cfg, gen, device)
    else:
        p["ffn"] = init_mlp(cfg, gen, device)
    return p


def init_lm(cfg: ModelConfig, gen: torch.Generator, device=None) -> Params:
    """Random parameters from ``gen`` (drawn on the generator's device,
    then moved to ``device``, default the generator's): embeddings
    Normal(0, 1/d_model), projections Normal(0, 1/fan_in), norms zero.
    An encoder-decoder config also gets ``encoder`` (one block per
    encoder layer) and ``enc_norm``, and cross attention in every
    decoder block."""
    check_supported(cfg)
    device = gen.device if device is None else torch.device(device)
    dt = param_dtype(cfg)
    Vp = padded_vocab(cfg.vocab_size)
    scale = 1.0 / math.sqrt(cfg.d_model)

    def table(shape):
        w = torch.randn(shape, generator=gen, device=gen.device,
                        dtype=torch.float32) * scale
        return w.to(device=device, dtype=dt)

    params: Params = {"embed": table((Vp, cfg.d_model)),
                      "final_norm": init_norm(cfg, device),
                      "layers": [init_block(cfg, gen, device, lt,
                                            cross=cfg.enc_dec)
                                 for lt in cfg.layer_types()]}
    if not cfg.tie_embeddings:
        params["unembed"] = table((cfg.d_model, Vp))
    if cfg.enc_dec:
        ecfg = encoder_cfg(cfg)
        params["encoder"] = [init_block(ecfg, gen, device, lt)
                             for lt in ecfg.layer_types()]
        params["enc_norm"] = init_norm(cfg, device)
    return params


# ===========================================================================
# Attention block
# ===========================================================================
def _project_qkv(cfg: ModelConfig, p: Params, x: torch.Tensor, positions,
                 layer_type: str):
    """x (B, S, d) -> q (B, S, Hq, hd), k and v (B, S, Hkv, hd), RoPE'd
    with the local base for a sliding-window block."""
    B, S, d = x.shape

    def proj(w):
        return (x @ w.reshape(d, -1)).reshape(B, S, w.shape[1], w.shape[2])

    q, k, v = proj(p["wq"]), proj(p["wk"]), proj(p["wv"])
    if cfg.qk_norm:
        q = rms_norm(q, p["q_norm"], cfg.norm_eps)
        k = rms_norm(k, p["k_norm"], cfg.norm_eps)
    theta = (cfg.rope_theta_local if layer_type == ATTN_LOCAL
             else cfg.rope_theta)
    q = apply_rope(q, positions, theta)
    k = apply_rope(k, positions, theta)
    return q, k, v


def _to_ring(t: torch.Tensor, L: int) -> torch.Tensor:
    """(B, S, ...) -> (B, L, ...) ring layout, slot = position mod L: the
    last L positions, zero-padded when S < L (the reference's
    ``_to_ring``)."""
    B, S = t.shape[:2]
    if S < L:
        out = t.new_zeros((B, L) + t.shape[2:])
        out[:, :S] = t
        return out
    j = torch.arange(L, device=t.device)
    return t[:, (S - 1) - torch.remainder((S - 1) - j, L)]


def _write_decode_rows(cache: torch.Tensor, new: torch.Tensor,
                       pos: torch.Tensor, ring: bool) -> None:
    """cache[b, slot(pos[b])] = new[b, 0], in place, for k/v rows (B, L,
    Hkv, hd) or their scales (B, L, Hkv): slot ``pos mod L`` in a ring,
    else ``pos``, where a position past the cache drops its write, as
    JAX's scatter does, without a host sync."""
    L = cache.shape[1]
    rows = torch.arange(cache.shape[0], device=cache.device)
    if ring:
        cache[rows, torch.remainder(pos, L)] = new[:, 0].to(cache.dtype)
        return
    slot = pos.clamp(0, L - 1)
    keep = (pos < L).reshape((-1,) + (1,) * (new.dim() - 2))
    cache[rows, slot] = torch.where(keep, new[:, 0].to(cache.dtype),
                                    cache[rows, slot])


def _kv_rows(k: torch.Tensor, v: torch.Tensor, kv_quant: bool,
             dt: torch.dtype) -> dict:
    """The cache rows of new k/v (B, S, Hkv, hd): in ``dt``, or int8
    codes with their (B, S, Hkv) scales."""
    if not kv_quant:
        return {"k": k.to(dt), "v": v.to(dt)}
    (kc, ks), (vc, vs) = quantize_kv(k), quantize_kv(v)
    return {"k": kc, "v": vc, "k_scale": ks, "v_scale": vs}


def apply_attention(cfg: ModelConfig, p: Params, x: torch.Tensor, *,
                    mode: str, positions, cache: Optional[dict],
                    cache_len: int = 0, layer_type: str = ATTN_GLOBAL,
                    kv_quant: bool = False):
    """x (B, S, d) normalised input -> (out (B, S, d), cache).

    mode ``prefill``: positions (B, S); returns a new cache: for a global
    block of length max(cache_len, S) holding k/v at [0, S), for a
    sliding-window block a ring of min(window, max(cache_len, S)) slots;
    int8 codes and their scales when ``kv_quant``.
    mode ``decode``: S = 1, positions an int or (B,) tensor; writes into
    ``cache`` in place (quantizing the new rows when the cache holds
    scales).
    mode ``encode``: non-causal attention over the whole sequence (the
    encoder), no cache."""
    B, S, d = x.shape
    W = cfg.window_size if layer_type == ATTN_LOCAL else 0
    if mode == "decode":
        pos = torch.as_tensor(positions, device=x.device)
        pos = pos.expand(B) if pos.dim() == 0 else pos
        q, k, v = _project_qkv(cfg, p, x, pos[:, None], layer_type)
        rows = _kv_rows(k, v, "k_scale" in cache, cache["k"].dtype)
        for name, new in rows.items():
            _write_decode_rows(cache[name], new, pos, ring=bool(W))
        out = attn_lib.decode_attention(q, cache["k"], cache["v"], pos,
                                        window=W,
                                        k_scale=cache.get("k_scale"),
                                        v_scale=cache.get("v_scale"))
        new_cache = cache
    elif mode in ("prefill", "encode"):
        q, k, v = _project_qkv(cfg, p, x, positions, layer_type)
        out = flash_ops.flash_attention(q, k, v, causal=mode == "prefill",
                                        window=W)
        new_cache = None
        if mode == "prefill":
            L = min(W, max(cache_len, S)) if W else max(cache_len, S)
            new_cache = {n: _to_ring(t, L) for n, t in
                         _kv_rows(k, v, kv_quant, param_dtype(cfg)).items()}
    else:
        raise ValueError(f"mode {mode!r}: 'prefill', 'decode' or 'encode'")
    Hq, hd = p["wo"].shape[:2]
    out = out.reshape(B, S, Hq * hd) @ p["wo"].reshape(Hq * hd, d)
    return out, new_cache


def cross_kv(cfg: ModelConfig, p: Params, kv_memory: torch.Tensor) -> dict:
    """The cross cache {"k", "v"} (B, Ss, Hkv, hd) of one decoder block:
    the encoder output through its ``cross`` wk/wv, in the model dtype."""
    B, Ss, d = kv_memory.shape
    dt = param_dtype(cfg)

    def proj(w):
        return (kv_memory @ w.reshape(d, -1)).reshape(
            B, Ss, w.shape[1], w.shape[2]).to(dt)

    return {"k": proj(p["wk"]), "v": proj(p["wv"])}


def apply_cross_attention(cfg: ModelConfig, p: Params, x: torch.Tensor,
                          cache: dict) -> torch.Tensor:
    """Cross attention of x (B, S, d) to the encoder's k/v in ``cache``
    (:func:`cross_kv`): non-causal, no RoPE, no qk-norm."""
    B, S, d = x.shape
    q = (x @ p["wq"].reshape(d, -1)).reshape(B, S, p["wq"].shape[1],
                                             p["wq"].shape[2])
    out = flash_ops.flash_attention(q, cache["k"], cache["v"], causal=False)
    Hq, hd = p["wo"].shape[:2]
    return out.reshape(B, S, Hq * hd) @ p["wo"].reshape(Hq * hd, d)


def apply_block(cfg: ModelConfig, p: Params, h: torch.Tensor, *, mode: str,
                positions, cache=None, cache_len: int = 0,
                layer_type: str = ATTN_GLOBAL,
                capacity_factor: float = CAPACITY_FACTOR,
                kv_memory: Optional[torch.Tensor] = None,
                kv_quant: bool = False):
    """Residual block: the mixer (attention, RWKV-6 time mix or RG-LRU),
    in a decoder block with ``cross`` then cross attention to the encoder
    output (its k/v built from ``kv_memory`` at prefill, read from the
    cache at decode), then the FFN (SwiGLU MLP, MoE or RWKV-6 channel
    mix), each behind an RMSNorm.
    Returns (h, cache).  The MoE's aux loss is dropped: serving ignores
    it.  Mode ``encode`` (an encoder block) returns no cache."""
    if mode not in ("prefill", "decode", "encode"):
        raise ValueError(f"mode {mode!r}: 'prefill', 'decode' or 'encode'")
    x = rms_norm(h, p["ln1"], cfg.norm_eps)
    if layer_type == RWKV6:
        st = cache if mode == "decode" else {"mix": None, "ffn": None}
        out, mix_state = apply_time_mix(cfg, p["mix"], x, st["mix"])
        h = h + out
        x = rms_norm(h, p["ln2"], cfg.norm_eps)
        out, ffn_state = apply_channel_mix(cfg, p["ffn"], x, st["ffn"])
        return h + out, {"mix": mix_state, "ffn": ffn_state}
    if layer_type == RGLRU:
        if mode == "decode":
            out, st = apply_rglru_decode(cfg, p["mix"], x, cache["mix"])
        else:
            out, st = apply_rglru_seq(cfg, p["mix"], x)
        new_cache = {"mix": st}
    else:
        out, new_cache = apply_attention(cfg, p["mix"], x, mode=mode,
                                         positions=positions, cache=cache,
                                         cache_len=cache_len,
                                         layer_type=layer_type,
                                         kv_quant=kv_quant)
    h = h + out
    if "cross" in p:
        cross = (cache["cross"] if mode == "decode"
                 else cross_kv(cfg, p["cross"], kv_memory))
        h = h + apply_cross_attention(
            cfg, p["cross"], rms_norm(h, p["ln_cross"], cfg.norm_eps), cross)
        new_cache["cross"] = cross
    x = rms_norm(h, p["ln2"], cfg.norm_eps)
    if cfg.num_experts:
        out, _ = apply_moe(cfg, p["ffn"], x, capacity_factor=capacity_factor)
    else:
        out = apply_mlp(p["ffn"], x)
    return h + out, new_cache


def apply_stack(cfg: ModelConfig, params: Params, h: torch.Tensor, *,
                mode: str, positions, caches: Optional[List] = None,
                cache_len: int = 0, lo: int = 0, hi: Optional[int] = None,
                capacity_factor: float = CAPACITY_FACTOR,
                kv_memory: Optional[torch.Tensor] = None,
                kv_quant: bool = False):
    """Blocks [lo, hi) (default: all).  ``caches`` holds one cache per
    block of the range (decode); returns (h, caches of the range)."""
    hi = cfg.num_layers if hi is None else hi
    types = cfg.layer_types()
    new_caches = []
    for i in range(lo, hi):
        c = caches[i - lo] if caches is not None else None
        h, nc = apply_block(cfg, params["layers"][i], h, mode=mode,
                            positions=positions, cache=c,
                            cache_len=cache_len, layer_type=types[i],
                            capacity_factor=capacity_factor,
                            kv_memory=kv_memory, kv_quant=kv_quant)
        new_caches.append(nc)
    return h, new_caches


# ===========================================================================
# Caches
# ===========================================================================
def init_layer_cache(cfg: ModelConfig, batch: int, cache_len: int,
                     device, kv_quant: bool = False,
                     layer_type: str = ATTN_GLOBAL,
                     cross_len: int = 0) -> dict:
    """Zero cache of one block: {"k", "v"} of (batch, L, Hkv, hd) in the
    model's dtype for attention, L = cache_len for a global block and
    min(window, cache_len) for a sliding-window ring, int8 with float32
    {"k_scale", "v_scale"} of (batch, L, Hkv) when ``kv_quant``;
    {"mix": {"s", "tm"}, "ffn": {"cm"}} in float32 for RWKV-6 and
    {"mix": {"h", "conv"}} for RG-LRU (no cache-length axis).  An
    encoder-decoder block with ``cross_len`` also gets "cross": {"k",
    "v"} of (batch, cross_len, Hkv, hd) in the model's dtype."""
    dt = param_dtype(cfg)
    kv_shape = (cfg.num_kv_heads, cfg.head_dim)
    if layer_type == RWKV6:
        st = init_rwkv_state(cfg, batch, device)
        c = {"mix": {"s": st["s"], "tm": st["tm"]}, "ffn": {"cm": st["cm"]}}
    elif layer_type == RGLRU:
        c = {"mix": init_rglru_state(cfg, batch, device)}
    else:
        L = (min(cfg.window_size, cache_len) if layer_type == ATTN_LOCAL
             else cache_len)
        kv_dt = torch.int8 if kv_quant else dt
        c = {n: torch.zeros((batch, L) + kv_shape, dtype=kv_dt,
                            device=device) for n in ("k", "v")}
        if kv_quant:
            c.update({n: torch.zeros((batch, L, cfg.num_kv_heads),
                                     dtype=torch.float32, device=device)
                      for n in ("k_scale", "v_scale")})
    if cfg.enc_dec and cross_len:
        c["cross"] = {n: torch.zeros((batch, cross_len) + kv_shape,
                                     dtype=dt, device=device)
                      for n in ("k", "v")}
    return c


def init_caches(cfg: ModelConfig, batch: int, cache_len: int, device,
                kv_quant: bool = False, cross_len: int = 0) -> List[dict]:
    """Zero caches of every block."""
    return [init_layer_cache(cfg, batch, cache_len, device, kv_quant, lt,
                             cross_len)
            for lt in cfg.layer_types()]


# ===========================================================================
# Top-level model functions
# ===========================================================================
def _embed_tokens(cfg: ModelConfig, params: Params,
                  tokens: torch.Tensor) -> torch.Tensor:
    h = embed_lookup(params["embed"], tokens)
    return h * torch.tensor(math.sqrt(cfg.d_model), dtype=h.dtype)


def _positions(tokens: torch.Tensor) -> torch.Tensor:
    B, S = tokens.shape[:2]
    return torch.arange(S, device=tokens.device)[None, :].expand(B, S)


def _assemble_inputs(cfg: ModelConfig, params: Params,
                     batch: dict) -> torch.Tensor:
    """The reference's ``_assemble_inputs``: the scaled token embeddings,
    with a VLM's ``patch_embeds`` (B, P, d) prepended (cast to their
    dtype) when ``cfg.frontend == "vit"``."""
    h = _embed_tokens(cfg, params, batch["tokens"])
    if cfg.frontend == "vit" and "patch_embeds" in batch:
        pe = batch["patch_embeds"].to(device=h.device, dtype=h.dtype)
        h = torch.cat([pe, h], dim=1)
    return h


def _encode(cfg: ModelConfig, params: Params,
            src_embeds: torch.Tensor) -> torch.Tensor:
    """The encoder: src_embeds (B, Ss, d), cast to the model dtype,
    through the non-causal encoder blocks (positions 0..Ss-1) and
    ``enc_norm``."""
    h = src_embeds.to(device=params["embed"].device,
                      dtype=params["embed"].dtype)
    h, _ = apply_stack(encoder_cfg(cfg), {"layers": params["encoder"]}, h,
                       mode="encode", positions=_positions(h))
    return rms_norm(h, params["enc_norm"], cfg.norm_eps)


def head(cfg: ModelConfig, params: Params, h: torch.Tensor):
    """Final norm, unembedding and greedy pick of (B, 1, d) hidden states:
    (logits (B, Vp), next token (B,))."""
    h = rms_norm(h, params["final_norm"], cfg.norm_eps)
    table = params["embed"] if cfg.tie_embeddings else params["unembed"]
    logits = unembed_logits(h, table, transpose_table=cfg.tie_embeddings,
                            valid_vocab=cfg.vocab_size)[:, 0]
    return logits, sharded_argmax(logits)


def prefill(cfg: ModelConfig, params: Params, batch: dict, *,
            cache_len: int, kv_quant: bool = False):
    """batch = {"tokens": (B, S)}, with ``"patch_embeds"`` (B, P, d) for a
    ``vit`` frontend: the patches come first and positions run over all
    P + S; for an encoder-decoder, ``"src_embeds"`` (B, Ss, d), which the
    encoder reads and every decoder block's cross cache keeps.
    ``kv_quant``: int8 k/v caches with per-row scales.  Returns
    (last-position logits (B, Vp), caches)."""
    check_supported(cfg)
    kv_memory = _encode(cfg, params, batch["src_embeds"]) \
        if cfg.enc_dec else None
    h = _assemble_inputs(cfg, params, batch)
    h, caches = apply_stack(cfg, params, h, mode="prefill",
                            positions=_positions(h), cache_len=cache_len,
                            kv_memory=kv_memory, kv_quant=kv_quant)
    logits, _ = head(cfg, params, h[:, -1:])
    return logits, caches


def decode_step(cfg: ModelConfig, params: Params, token: torch.Tensor, pos,
                caches: List[dict]):
    """token (B, 1); pos: the position of this token, an int or (B,)
    per-sequence positions.  Returns (logits (B, Vp), next token (B,),
    caches) — the caches updated in place (an encoder-decoder's cross
    caches are read, not written)."""
    h = _embed_tokens(cfg, params, token)
    h, caches = apply_stack(cfg, params, h, mode="decode", positions=pos,
                            caches=caches,
                            capacity_factor=DECODE_CAPACITY_FACTOR)
    logits, nxt = head(cfg, params, h)
    return logits, nxt, caches


__all__ = ["Params", "apply_attention", "apply_block",
           "apply_cross_attention", "apply_stack", "check_supported",
           "cross_kv", "decode_step", "encoder_cfg", "head", "init_block",
           "init_caches", "init_layer_cache", "init_lm", "prefill"]
