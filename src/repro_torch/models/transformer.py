"""The dense decoder on one card: init, prefill and decode.

The port of the dense-decoder path of the JAX package's
``repro/models/transformer.py``: RMSNorm, global causal GQA attention
with RoPE (optional qk-norm) and a SwiGLU MLP per block, a final norm
and an untied or tied unembedding.  Both norms of every block and the
final norm go through the RMSNorm kernel, and prefill attention through
the flash-attention kernel (``kernels/``); the projections, the MLP and
the unembedding are plain matrix products, as the reference leaves them
to XLA.

Parameters are a plain dict: ``embed`` (Vp, d), ``final_norm`` (d,),
``unembed`` (d, Vp) unless tied, and ``layers``, a list with one dict per
block (``ln1``, ``mix`` = {wq, wk, wv, wo[, q_norm, k_norm]}, ``ln2``,
``ffn`` = {wg, wu, wd}).  The reference stacks blocks on a superblock
axis for ``lax.scan``; PyTorch runs eagerly, so a Python loop over the
list takes its place.  Caches are a list with one ``{"k", "v"}`` dict of
(B, L, Hkv, hd) per block.  Decode writes each new k/v row into the
cache in place (JAX returns an updated copy) and returns the same list.

Other layer types (local attention, RG-LRU, RWKV-6), MoE FFNs,
encoder-decoder stacks and int8 KV caches raise ``NotImplementedError``
naming their ROADMAP item.
"""
from __future__ import annotations

import math
from typing import List, Optional

import torch

from repro_torch.configs.base import (ATTN_GLOBAL, ATTN_LOCAL, RGLRU, RWKV6,
                                      ModelConfig)
from repro_torch.kernels.flash_attention import ops as flash_ops
from . import attention as attn_lib
from .layers import (apply_mlp, apply_rope, init_attention, init_mlp,
                     init_norm, param_dtype, rms_norm)
from .sharded_ops import (embed_lookup, padded_vocab, sharded_argmax,
                          unembed_logits)

Params = dict

FAMILY_DEFERRED = ("{what} is not ported yet: ROADMAP, queue 1, item 1 "
                   "(kernel rows 5-7 with the model families that reach "
                   "them)")
REST_DEFERRED = "{what} is not ported yet: ROADMAP, queue 1, item 4"


def check_supported(cfg: ModelConfig) -> None:
    """Raise ``NotImplementedError`` for what the dense decoder path of
    the port does not run."""
    for lt in dict.fromkeys(cfg.layer_types()):
        if lt == ATTN_LOCAL:
            raise NotImplementedError(FAMILY_DEFERRED.format(
                what="sliding-window (local) attention"))
        if lt in (RGLRU, RWKV6):
            raise NotImplementedError(FAMILY_DEFERRED.format(
                what=f"the {lt} layer type"))
        if lt != ATTN_GLOBAL:
            raise ValueError(f"unknown layer type {lt!r}")
    if cfg.num_experts:
        raise NotImplementedError(FAMILY_DEFERRED.format(what="MoE FFNs"))
    if cfg.enc_dec:
        raise NotImplementedError(REST_DEFERRED.format(
            what="the encoder-decoder stack"))


# ===========================================================================
# Init
# ===========================================================================
def init_block(cfg: ModelConfig, gen: torch.Generator, device) -> Params:
    return {"ln1": init_norm(cfg, device),
            "mix": init_attention(cfg, gen, device),
            "ln2": init_norm(cfg, device),
            "ffn": init_mlp(cfg, gen, device)}


def init_lm(cfg: ModelConfig, gen: torch.Generator, device=None) -> Params:
    """Random parameters from ``gen`` (drawn on the generator's device,
    then moved to ``device``, default the generator's): embeddings
    Normal(0, 1/d_model), projections Normal(0, 1/fan_in), norms zero."""
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
                      "layers": [init_block(cfg, gen, device)
                                 for _ in range(cfg.num_layers)]}
    if not cfg.tie_embeddings:
        params["unembed"] = table((cfg.d_model, Vp))
    return params


# ===========================================================================
# Attention block
# ===========================================================================
def _project_qkv(cfg: ModelConfig, p: Params, x: torch.Tensor, positions):
    """x (B, S, d) -> q (B, S, Hq, hd), k and v (B, S, Hkv, hd), RoPE'd."""
    B, S, d = x.shape

    def proj(w):
        return (x @ w.reshape(d, -1)).reshape(B, S, w.shape[1], w.shape[2])

    q, k, v = proj(p["wq"]), proj(p["wk"]), proj(p["wv"])
    if cfg.qk_norm:
        q = rms_norm(q, p["q_norm"], cfg.norm_eps)
        k = rms_norm(k, p["k_norm"], cfg.norm_eps)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def _write_decode_rows(cache: torch.Tensor, new: torch.Tensor,
                       pos: torch.Tensor) -> None:
    """cache[b, pos[b]] = new[b, 0], in place.  A position past the cache
    drops its write, as JAX's scatter does, without a host sync."""
    L = cache.shape[1]
    rows = torch.arange(cache.shape[0], device=cache.device)
    slot = pos.clamp(0, L - 1)
    keep = (pos < L)[:, None, None]
    cache[rows, slot] = torch.where(keep, new[:, 0].to(cache.dtype),
                                    cache[rows, slot])


def apply_attention(cfg: ModelConfig, p: Params, x: torch.Tensor, *,
                    mode: str, positions, cache: Optional[dict],
                    cache_len: int = 0):
    """x (B, S, d) normalised input -> (out (B, S, d), cache).

    mode ``prefill``: positions (B, S); returns a new cache of length
    max(cache_len, S) holding k/v at [0, S).  mode ``decode``: S = 1,
    positions an int or (B,) tensor; writes into ``cache`` in place."""
    B, S, d = x.shape
    if mode == "decode":
        pos = torch.as_tensor(positions, device=x.device)
        pos = pos.expand(B) if pos.dim() == 0 else pos
        q, k, v = _project_qkv(cfg, p, x, pos[:, None])
        _write_decode_rows(cache["k"], k, pos)
        _write_decode_rows(cache["v"], v, pos)
        out = attn_lib.decode_attention(q, cache["k"], cache["v"], pos)
        new_cache = cache
    elif mode == "prefill":
        q, k, v = _project_qkv(cfg, p, x, positions)
        out = flash_ops.flash_attention(q, k, v, causal=True)
        L = max(cache_len, S)
        new_cache = {}
        for name, t in (("k", k), ("v", v)):
            c = torch.zeros((B, L) + t.shape[2:], dtype=param_dtype(cfg),
                            device=x.device)
            c[:, :S] = t
            new_cache[name] = c
    else:
        raise ValueError(f"mode {mode!r}: 'prefill' or 'decode'")
    Hq, hd = p["wo"].shape[:2]
    out = out.reshape(B, S, Hq * hd) @ p["wo"].reshape(Hq * hd, d)
    return out, new_cache


def apply_block(cfg: ModelConfig, p: Params, h: torch.Tensor, *, mode: str,
                positions, cache=None, cache_len: int = 0):
    """Residual block: attention then SwiGLU MLP, each behind an RMSNorm.
    Returns (h, cache)."""
    x = rms_norm(h, p["ln1"], cfg.norm_eps)
    out, new_cache = apply_attention(cfg, p["mix"], x, mode=mode,
                                     positions=positions, cache=cache,
                                     cache_len=cache_len)
    h = h + out
    x = rms_norm(h, p["ln2"], cfg.norm_eps)
    return h + apply_mlp(p["ffn"], x), new_cache


def apply_stack(cfg: ModelConfig, params: Params, h: torch.Tensor, *,
                mode: str, positions, caches: Optional[List] = None,
                cache_len: int = 0, lo: int = 0, hi: Optional[int] = None):
    """Blocks [lo, hi) (default: all).  ``caches`` holds one cache per
    block of the range (decode); returns (h, caches of the range)."""
    hi = cfg.num_layers if hi is None else hi
    new_caches = []
    for i in range(lo, hi):
        c = caches[i - lo] if caches is not None else None
        h, nc = apply_block(cfg, params["layers"][i], h, mode=mode,
                            positions=positions, cache=c,
                            cache_len=cache_len)
        new_caches.append(nc)
    return h, new_caches


# ===========================================================================
# Caches
# ===========================================================================
def init_layer_cache(cfg: ModelConfig, batch: int, cache_len: int,
                     device, kv_quant: bool = False) -> dict:
    """Zero KV cache of one block: {"k", "v"} of (batch, cache_len, Hkv,
    hd) in the model's dtype."""
    if kv_quant:
        raise NotImplementedError(REST_DEFERRED.format(what="the int8 KV "
                                                            "cache"))
    shape = (batch, cache_len, cfg.num_kv_heads, cfg.head_dim)
    return {n: torch.zeros(shape, dtype=param_dtype(cfg), device=device)
            for n in ("k", "v")}


def init_caches(cfg: ModelConfig, batch: int, cache_len: int, device,
                kv_quant: bool = False) -> List[dict]:
    """Zero caches of every block."""
    return [init_layer_cache(cfg, batch, cache_len, device, kv_quant)
            for _ in range(cfg.num_layers)]


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
    """batch = {"tokens": (B, S)}.  Returns (last-position logits (B, Vp),
    caches)."""
    check_supported(cfg)
    if kv_quant:
        raise NotImplementedError(REST_DEFERRED.format(what="the int8 KV "
                                                            "cache"))
    tokens = batch["tokens"]
    h = _embed_tokens(cfg, params, tokens)
    h, caches = apply_stack(cfg, params, h, mode="prefill",
                            positions=_positions(tokens),
                            cache_len=cache_len)
    logits, _ = head(cfg, params, h[:, -1:])
    return logits, caches


def decode_step(cfg: ModelConfig, params: Params, token: torch.Tensor, pos,
                caches: List[dict]):
    """token (B, 1); pos: the position of this token, an int or (B,)
    per-sequence positions.  Returns (logits (B, Vp), next token (B,),
    caches) — the caches updated in place."""
    h = _embed_tokens(cfg, params, token)
    h, caches = apply_stack(cfg, params, h, mode="decode", positions=pos,
                            caches=caches)
    logits, nxt = head(cfg, params, h)
    return logits, nxt, caches


__all__ = ["Params", "apply_attention", "apply_block", "apply_stack",
           "check_supported", "decode_step", "head", "init_block",
           "init_caches", "init_layer_cache", "init_lm", "prefill"]
