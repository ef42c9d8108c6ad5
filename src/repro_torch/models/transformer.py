"""Decoder stacks on one card: init, prefill, decode and the training
loss.

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

Training (:func:`loss_fn`, mode ``train``) covers every family: each
kernel on the path (attention, RMSNorm, the fused expert SwiGLU, the
RG-LRU scan, WKV6) is a ``torch.autograd.Function`` with a backward
kernel on the card; the MoE's load-balance loss is summed over the
blocks into ``aux``; an encoder-decoder encodes ``src_embeds`` under the
same remat; and ``remat`` recomputes each block in the backward
(``torch.utils.checkpoint``, per block where the reference checkpoints
per superblock: the same arithmetic).

Tensor and data parallelism (``env``, a ``runtime.meshenv.MeshEnv``)
cover every family in :func:`loss_fn`: each rank holds its slice of
every parameter under :func:`param_specs` (the reference's rules:
attention's q heads, padded to divide TP, and its k/v heads when they
divide it; the MLP's ``wg``/``wu`` column- and ``wd`` row-parallel; the
MoE's experts (:mod:`.moe`), RWKV-6's heads when they divide TP and its
channel mix (:mod:`.rwkv`), the RG-LRU's channels (:mod:`.rglru`); the
vocab of ``embed`` and ``unembed``; an encoder-decoder's encoder blocks
and cross attention as the decoder's attention); each sharded branch
runs on the local heads, channels or experts, RMSNorm on the replicated
residual, and each row-parallel output ends in an all-reduce over the
model axis.  ``src_embeds`` and ``patch_embeds`` are rows of the batch
like the tokens.  The reference's sequence-sharded residual between
blocks is a GSPMD layout choice that does not change the numbers and is
not reproduced; its context-parallel attention raises
:class:`NotImplementedError` naming ROADMAP item 8e.

Serving on a mesh (:func:`prefill`, :func:`decode_step` with ``env``)
keeps the reference's sharded caches (:func:`cache_specs`): k/v by
heads over the model axis when the kv heads divide TP, else by the
cache length (over the batch axes and the model axis together when the
batch is too small to shard), else replicated; RWKV-6's state by heads,
the RG-LRU's by channels, int8 scales like their codes.  Prefill runs
attention as training does and keeps the rank's piece of each new
cache.  Decode over heads-sharded (or replicated) caches attends with
the local q heads; over a length-sharded cache every rank takes all q
heads (gathered over the model axis), a float32 partial (max, sum of
exponentials, weighted values) over its own slots, and the partials
merge across the shard axes (``pmax``, then sums), before ``wo`` on the
local heads.  Only the rank that owns a new row's slot (``pos mod L`` in
a ring) writes it.  A length-sharded cross cache merges row 3's
forward and its log-sum-exp over the local source rows the same way.
"""
from __future__ import annotations

import dataclasses
import functools
import math
from typing import List, Optional

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import (ATTN_GLOBAL, ATTN_LOCAL, RGLRU, RWKV6,
                                      ModelConfig)
from repro_torch.kernels.flash_attention import ops as flash_ops
from . import attention as attn_lib
from .attention import quantize_kv
from repro_torch.runtime.meshenv import CPU_ENV, MeshEnv, P
from .layers import (apply_mlp, apply_rope, attention_specs, dense_init,
                     init_attention, init_mlp, init_norm, kv_sharded,
                     mlp_specs, param_dtype, rms_norm)
from .moe import apply_moe, init_moe, moe_specs
from .rglru import (apply_rglru_decode, apply_rglru_seq, init_rglru,
                    rglru_specs)
from .rwkv import (apply_channel_mix, apply_time_mix, channel_mix_specs,
                   heads_sharded, init_rwkv_channel_mix, init_rwkv_time_mix,
                   time_mix_specs)
from .sharded_ops import (embed_lookup, fused_unembed_xent, padded_vocab,
                          sharded_argmax, unembed_logits)

Params = dict

#: MoE capacity factors, the reference's defaults: ``apply_block`` (and so
#: prefill and both halves of the split path, decode included) uses 1.25,
#: ``decode_step`` 2.0
CAPACITY_FACTOR = 1.25
DECODE_CAPACITY_FACTOR = 2.0
#: weight of the MoE load-balancing loss in ``loss_fn``'s total, the
#: reference's
MOE_AUX_WEIGHT = 0.01


def check_supported(cfg: ModelConfig, env: MeshEnv = CPU_ENV) -> None:
    """Raise ``ValueError`` for a layer type the port does not know, or
    for a model axis that the MoE's experts or the RG-LRU's channels and
    heads do not divide (the reference's specs need it), and
    ``NotImplementedError`` for the reference's context-parallel
    attention with ``tp > 1`` (ROADMAP item 8e)."""
    types = set(cfg.layer_types())
    for lt in types:
        if lt not in (ATTN_GLOBAL, ATTN_LOCAL, RGLRU, RWKV6):
            raise ValueError(f"unknown layer type {lt!r}")
    if env.tp > 1:
        if cfg.num_experts:
            moe_specs(cfg, env)
        if RGLRU in types:
            rglru_specs(cfg, env)
    if env.context_parallel_attn and env.tp > 1:
        raise NotImplementedError("context-parallel attention waits for "
                                  "ROADMAP item 8e")


def encoder_cfg(cfg: ModelConfig) -> ModelConfig:
    """The encoder stack's config: ``num_enc_layers`` global attention
    blocks."""
    return dataclasses.replace(cfg, num_layers=cfg.num_enc_layers,
                               pattern=(ATTN_GLOBAL,), enc_dec=False)


# ===========================================================================
# Init
# ===========================================================================
def init_block(cfg: ModelConfig, gen: torch.Generator, device,
               layer_type: str = ATTN_GLOBAL, cross: bool = False,
               env: MeshEnv = CPU_ENV) -> Params:
    """One block; ``cross`` adds the decoder's ``ln_cross`` and ``cross``
    attention (an encoder-decoder stack).  ``env`` pads the attention's
    q heads (self and cross) for its TP size."""
    rwkv = layer_type == RWKV6
    if layer_type in (RWKV6, RGLRU):
        init_mix = {RWKV6: init_rwkv_time_mix, RGLRU: init_rglru}[layer_type]
        mix = init_mix(cfg, gen, device)
    else:
        mix = init_attention(cfg, gen, device, env=env)
    p = {"ln1": init_norm(cfg, device), "mix": mix}
    if cross:
        p["ln_cross"] = init_norm(cfg, device)
        p["cross"] = init_attention(cfg, gen, device, cross=True, env=env)
    p["ln2"] = init_norm(cfg, device)
    if rwkv:
        p["ffn"] = init_rwkv_channel_mix(cfg, gen, device)
    elif cfg.num_experts:
        p["ffn"] = init_moe(cfg, gen, device)
    else:
        p["ffn"] = init_mlp(cfg, gen, device)
    return p


def init_lm(cfg: ModelConfig, gen: torch.Generator, device=None,
            env: MeshEnv = CPU_ENV) -> Params:
    """Random parameters from ``gen`` (drawn on the generator's device,
    then moved to ``device``, default the generator's): embeddings
    Normal(0, 1/d_model), projections Normal(0, 1/fan_in), norms zero.
    An encoder-decoder config also gets ``encoder`` (one block per
    encoder layer) and ``enc_norm``, and cross attention in every
    decoder block.  These are the logical (whole) parameters for
    ``env``: the vocab padded to lcm(tp, 128) and the q heads padded for
    its TP size, as the reference's ``init_lm`` pads them; a rank's own
    slice is ``interop.shard_lm_params`` of them.  ``device="meta"``
    draws and allocates nothing (``launch.steps.abstract_params``)."""
    check_supported(cfg, env)
    device = gen.device if device is None else torch.device(device)
    dt = param_dtype(cfg)
    Vp = padded_vocab(cfg.vocab_size, env.tp)

    def table(shape):
        return dense_init(gen, shape, cfg.d_model, dt, device)

    params: Params = {"embed": table((Vp, cfg.d_model)),
                      "final_norm": init_norm(cfg, device),
                      "layers": [init_block(cfg, gen, device, lt,
                                            cross=cfg.enc_dec, env=env)
                                 for lt in cfg.layer_types()]}
    if not cfg.tie_embeddings:
        params["unembed"] = table((cfg.d_model, Vp))
    if cfg.enc_dec:
        ecfg = encoder_cfg(cfg)
        params["encoder"] = [init_block(ecfg, gen, device, lt, env=env)
                             for lt in ecfg.layer_types()]
        params["enc_norm"] = init_norm(cfg, device)
    return params


def block_specs(cfg: ModelConfig, env: MeshEnv,
                layer_type: str = ATTN_GLOBAL, cross: bool = False) -> dict:
    """The reference's specs of one block (``init_block``): its mixer's
    (attention, RWKV-6 time mix or RG-LRU), a decoder block's
    ``ln_cross`` and ``cross`` attention, and its FFN's (SwiGLU MLP, MoE
    or RWKV-6 channel mix); norms replicated."""
    if layer_type == RWKV6:
        mix = time_mix_specs(cfg, env)
    elif layer_type == RGLRU:
        mix = rglru_specs(cfg, env)
    else:
        mix = attention_specs(cfg, env)
    specs = {"ln1": P(None), "mix": mix}
    if cross:
        specs["ln_cross"] = P(None)
        specs["cross"] = attention_specs(cfg, env, cross=True)
    specs["ln2"] = P(None)
    if layer_type == RWKV6:
        specs["ffn"] = channel_mix_specs(cfg, env)
    elif cfg.num_experts:
        specs["ffn"] = moe_specs(cfg, env)
    else:
        specs["ffn"] = mlp_specs(cfg, env)
    return specs


def param_specs(cfg: ModelConfig, env: MeshEnv) -> Params:
    """The reference's ``PartitionSpec`` of every parameter under
    ``env``, in the port's tree (``layers`` and an encoder-decoder's
    ``encoder`` one block each, where the reference stacks its tail and
    scan blocks): ``embed`` P("model", None), ``unembed`` P(None,
    "model"), norms replicated, each block as :func:`block_specs`
    says."""
    specs = {"embed": P("model", None), "final_norm": P(None),
             "layers": [block_specs(cfg, env, lt, cross=cfg.enc_dec)
                        for lt in cfg.layer_types()]}
    if not cfg.tie_embeddings:
        specs["unembed"] = P(None, "model")
    if cfg.enc_dec:
        ecfg = encoder_cfg(cfg)
        specs["encoder"] = [block_specs(ecfg, env, lt)
                            for lt in ecfg.layer_types()]
        specs["enc_norm"] = P(None)
    return specs


# ===========================================================================
# Attention block
# ===========================================================================
def _local_kv_heads(cfg: ModelConfig, env: MeshEnv, hq_local: int,
                    device) -> torch.Tensor:
    """The kv heads this rank's q heads read when k/v are replicated:
    q head h (global, of the padded count) reads kv head h // rep.  The
    local q heads cover whole groups, sit inside one group, or (neither)
    take one kv head each."""
    hq_pad = hq_local * env.tp
    rep = hq_pad // cfg.num_kv_heads
    first = env.axis_index(env.model_axis) * hq_local
    if hq_local % rep == 0:
        heads = torch.arange(first // rep, (first + hq_local) // rep)
    elif rep % hq_local == 0:
        heads = torch.tensor([first // rep])
    else:
        heads = (first + torch.arange(hq_local)) // rep
    return heads.to(device)


def _project_qkv(cfg: ModelConfig, p: Params, x: torch.Tensor, positions,
                 layer_type: str, env: MeshEnv = CPU_ENV):
    """x (B, S, d) -> q (B, S, Hq, hd), k and v (B, S, Hkv, hd), RoPE'd
    with the local base for a sliding-window block.

    With ``env.tp > 1`` the q heads (and k/v heads, when they divide TP)
    are this rank's; replicated k/v come back whole (every kv head):
    :func:`_read_kv` cuts them to the heads the local q heads read.  A
    replicated tensor that only part of each rank's computation uses (x,
    replicated wk/wv, the qk-norm weights) enters through ``psum_grad``,
    so its gradient is the sum over the model axis."""
    B, S, d = x.shape
    wk, wv = p["wk"], p["wv"]
    q_norm, k_norm = p.get("q_norm"), p.get("k_norm")
    if env.tp > 1:
        model = env.model_axis
        x = env.psum_grad(x, model)
        if not kv_sharded(cfg, env):
            wk, wv = env.psum_grad(wk, model), env.psum_grad(wv, model)
        if cfg.qk_norm:
            q_norm = env.psum_grad(q_norm, model)
            k_norm = env.psum_grad(k_norm, model)

    def proj(w):
        return (x @ w.reshape(d, -1)).reshape(B, S, w.shape[1], w.shape[2])

    q, k, v = proj(p["wq"]), proj(wk), proj(wv)
    if cfg.qk_norm:
        q = rms_norm(q, q_norm, cfg.norm_eps)
        k = rms_norm(k, k_norm, cfg.norm_eps)
    theta = (cfg.rope_theta_local if layer_type == ATTN_LOCAL
             else cfg.rope_theta)
    return (apply_rope(q, positions, theta), apply_rope(k, positions, theta),
            v)


def _read_kv(cfg: ModelConfig, env: MeshEnv, hq_local: int, *kv):
    """The k/v heads (dim 2) that this rank's ``hq_local`` q heads read:
    the tensors as they are on one process or when the kv heads shard,
    else their :func:`_local_kv_heads` (int8 scales (B, L, Hkv) too)."""
    if env.tp <= 1 or kv_sharded(cfg, env):
        return kv
    heads = _local_kv_heads(cfg, env, hq_local, kv[0].device)
    return tuple(None if t is None else t.index_select(2, heads)
                 for t in kv)


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


def _length_shard(cache: dict, spec: Optional[P], env: MeshEnv) -> dict:
    """This rank's slots of whole-length cache tensors (B, L, ...) when
    ``spec`` shards the cache length (its dim 1), as copies; else the
    tensors as they are."""
    if spec is None or spec[1] is None:
        return cache
    return {n: env.local_slice(t, 1, spec[1]).clone()
            for n, t in cache.items()}


def _write_decode_rows(cache: torch.Tensor, new: torch.Tensor,
                       pos: torch.Tensor, ring: bool, first: int = 0,
                       length: Optional[int] = None) -> None:
    """cache[b, slot(pos[b]) - first] = new[b, 0], in place, for k/v rows
    (B, L, Hkv, hd) or their scales (B, L, Hkv), where ``cache`` holds
    slots [first, first + L) of a cache of ``length`` slots (default L):
    slot ``pos mod length`` in a ring, else ``pos``.  A row whose slot
    lies outside this piece (another rank's, or past the cache, where
    JAX's scatter drops the write) is not written; no host sync."""
    L = cache.shape[1]
    length = L if length is None else length
    rows = torch.arange(cache.shape[0], device=cache.device)
    if ring and length == L:                    # the whole ring is here
        cache[rows, torch.remainder(pos, L)] = new[:, 0].to(cache.dtype)
        return
    slot = (torch.remainder(pos, length) if ring else pos) - first
    keep = ((slot >= 0) & (slot < L)).reshape(
        (-1,) + (1,) * (new.dim() - 2))
    slot = slot.clamp(0, L - 1)
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


def _merge_partials(m: torch.Tensor, l: torch.Tensor, o: torch.Tensor,
                    env: MeshEnv, axis) -> torch.Tensor:
    """The online-softmax merge of per-rank partials over ``axis``: each
    rank's max ``m`` and sum of exponentials ``l`` (B, Sq, H, 1) and its
    weighted values ``o`` (B, Sq, H, hd), all float32, relative to its
    own max -> the attention output over every rank's rows (float32)."""
    top = env.pmax(m, axis)
    w = torch.exp(m - top)
    num = env.all_reduce_((o * w).contiguous(), axis)
    den = env.all_reduce_((l * w).contiguous(), axis)
    return num / den


def _decode_self_attention(cfg: ModelConfig, p: Params, x: torch.Tensor,
                           pos: torch.Tensor, cache: dict, W: int,
                           layer_type: str, env: MeshEnv,
                           spec: Optional[P]) -> torch.Tensor:
    """One token of attention against this rank's cache (written in
    place first) -> (B, 1, Hq_local, hd), before ``wo``.  ``spec`` is
    the cache's (:func:`cache_specs`; None on one process): heads over
    the model axis, or replicated, attend with the local q heads; a
    cache length sharded over ``spec[1]`` takes every q head (gathered
    over the model axis), a float32 partial over its own slots and the
    online-softmax merge over ``spec[1]``, then the local heads."""
    q, k, v = _project_qkv(cfg, p, x, pos[:, None], layer_type, env)
    axis = None if spec is None else spec[1]
    L = cache["k"].shape[1]
    n = env.axis_size(axis) if axis is not None else 1
    first = env.axis_index(axis) * L if axis is not None else 0
    for name, new in _kv_rows(k, v, "k_scale" in cache,
                              cache["k"].dtype).items():
        _write_decode_rows(cache[name], new, pos, ring=bool(W), first=first,
                           length=L * n)
    ck, cv, ks, vs = (cache["k"], cache["v"], cache.get("k_scale"),
                      cache.get("v_scale"))
    if axis is None:
        ck, cv, ks, vs = _read_kv(cfg, env, q.shape[2], ck, cv, ks, vs)
        return attn_lib.decode_attention(q, ck, cv, pos, window=W,
                                         k_scale=ks, v_scale=vs)
    if env.tp > 1:
        q = env.all_gather(q, 2, env.model_axis)
    m, l, o = attn_lib.decode_attention_partial(
        q, ck, cv, pos, window=W, first=first, length=L * n, k_scale=ks,
        v_scale=vs)
    out = _merge_partials(m, l, o, env, axis).to(q.dtype)
    return env.local_slice(out, 2, env.model_axis) if env.tp > 1 else out


def _out_proj(p: Params, out: torch.Tensor, env: MeshEnv) -> torch.Tensor:
    """(B, S, Hq_local, hd) through ``wo``, summed over the model axis."""
    B, S = out.shape[:2]
    Hq, hd, d = p["wo"].shape
    out = out.reshape(B, S, Hq * hd) @ p["wo"].reshape(Hq * hd, d)
    return env.psum(out, env.model_axis) if env.tp > 1 else out


def apply_attention(cfg: ModelConfig, p: Params, x: torch.Tensor, *,
                    mode: str, positions, cache: Optional[dict],
                    cache_len: int = 0, layer_type: str = ATTN_GLOBAL,
                    kv_quant: bool = False, env: MeshEnv = CPU_ENV,
                    cache_spec: Optional[P] = None):
    """x (B, S, d) normalised input -> (out (B, S, d), cache).

    mode ``prefill``: positions (B, S); returns a new cache: for a global
    block of length max(cache_len, S) holding k/v at [0, S), for a
    sliding-window block a ring of min(window, max(cache_len, S)) slots;
    int8 codes and their scales when ``kv_quant``.
    mode ``decode``: S = 1, positions an int or (B,) tensor; writes into
    ``cache`` in place (quantizing the new rows when the cache holds
    scales).
    mode ``encode``: non-causal attention over the whole sequence (the
    encoder), no cache.
    mode ``train``: causal attention over the whole sequence (windowed
    on a local layer), no cache.
    With ``env.tp > 1`` attention runs on this rank's q heads
    (:func:`_project_qkv`) and the output is summed over the model axis;
    ``cache_spec`` (the k/v spec of :func:`cache_specs`) says which
    piece of the cache this rank keeps at prefill (its kv heads, its
    slots of the cache length, or all) and reads at decode
    (:func:`_decode_self_attention`)."""
    B, S, d = x.shape
    W = cfg.window_size if layer_type == ATTN_LOCAL else 0
    if mode == "decode":
        pos = torch.as_tensor(positions, device=x.device)
        pos = pos.expand(B) if pos.dim() == 0 else pos
        out = _decode_self_attention(cfg, p, x, pos, cache, W, layer_type,
                                     env, cache_spec)
        return _out_proj(p, out, env), cache
    if mode not in ("prefill", "encode", "train"):
        raise ValueError(f"mode {mode!r}: 'prefill', 'decode', 'encode' or "
                         "'train'")
    q, k, v = _project_qkv(cfg, p, x, positions, layer_type, env)
    out = flash_ops.flash_attention(q, *_read_kv(cfg, env, q.shape[2], k, v),
                                    causal=mode != "encode", window=W)
    new_cache = None
    if mode == "prefill":
        L = min(W, max(cache_len, S)) if W else max(cache_len, S)
        new_cache = _length_shard(
            {n: _to_ring(t, L) for n, t in
             _kv_rows(k, v, kv_quant, param_dtype(cfg)).items()},
            cache_spec, env)
    return _out_proj(p, out, env), new_cache


def cross_kv(cfg: ModelConfig, p: Params, kv_memory: torch.Tensor,
             env: MeshEnv = CPU_ENV) -> dict:
    """The cross cache {"k", "v"} (B, Ss, Hkv, hd) of one decoder block:
    the encoder output through its ``cross`` wk/wv, in the model dtype.
    With ``env.tp > 1``, this rank's kv heads when they shard, else
    every kv head; the replicated encoder output, and replicated wk/wv,
    enter through ``psum_grad``."""
    B, Ss, d = kv_memory.shape
    dt = param_dtype(cfg)
    wk, wv = p["wk"], p["wv"]
    if env.tp > 1:
        model = env.model_axis
        kv_memory = env.psum_grad(kv_memory, model)
        if not kv_sharded(cfg, env):
            wk, wv = env.psum_grad(wk, model), env.psum_grad(wv, model)

    def proj(w):
        return (kv_memory @ w.reshape(d, -1)).reshape(
            B, Ss, w.shape[1], w.shape[2]).to(dt)

    return {"k": proj(wk), "v": proj(wv)}


def apply_cross_attention(cfg: ModelConfig, p: Params, x: torch.Tensor,
                          cache: dict, env: MeshEnv = CPU_ENV,
                          cache_spec: Optional[P] = None) -> torch.Tensor:
    """Cross attention of x (B, S, d) to the encoder's k/v in ``cache``
    (:func:`cross_kv`): non-causal, no RoPE, no qk-norm.  With
    ``env.tp > 1`` on this rank's q heads, the output summed over the
    model axis.  A cache whose source length is sharded (``cache_spec``
    of :func:`cache_specs`) takes every q head (gathered over the model
    axis), row 3's forward with its log-sum-exp over the local source
    rows, and the online-softmax merge over ``cache_spec[1]``."""
    B, S, d = x.shape
    if env.tp > 1:
        x = env.psum_grad(x, env.model_axis)
    q = (x @ p["wq"].reshape(d, -1)).reshape(B, S, p["wq"].shape[1],
                                             p["wq"].shape[2])
    axis = None if cache_spec is None else cache_spec[1]
    if axis is None:
        out = flash_ops.flash_attention(
            q, *_read_kv(cfg, env, q.shape[2], cache["k"], cache["v"]),
            causal=False)
        return _out_proj(p, out, env)
    if env.tp > 1:
        q = env.all_gather(q, 2, env.model_axis)
    out, lse, out_lo = flash_ops.flash_attention_lse(q, cache["k"],
                                                     cache["v"])
    o = out.float() if out_lo is None else out.float() + out_lo.float()
    m = (lse * math.log(2.0)).transpose(1, 2)[..., None]     # (B, S, H, 1)
    out = _merge_partials(m, torch.ones_like(m), o, env, axis).to(q.dtype)
    if env.tp > 1:
        out = env.local_slice(out, 2, env.model_axis)
    return _out_proj(p, out, env)


def apply_block(cfg: ModelConfig, p: Params, h: torch.Tensor, *, mode: str,
                positions, cache=None, cache_len: int = 0,
                layer_type: str = ATTN_GLOBAL,
                capacity_factor: float = CAPACITY_FACTOR,
                kv_memory: Optional[torch.Tensor] = None,
                kv_quant: bool = False, env: MeshEnv = CPU_ENV,
                cache_spec: Optional[dict] = None):
    """Residual block: the mixer (attention, RWKV-6 time mix or RG-LRU),
    in a decoder block with ``cross`` then cross attention to the encoder
    output (its k/v built from ``kv_memory`` at prefill, read from the
    cache at decode), then the FFN (SwiGLU MLP, MoE or RWKV-6 channel
    mix), each behind an RMSNorm.
    Returns (h, cache); mode ``train`` returns (h, aux) instead: the
    mean of the MoE's per-token load-balance loss (float32; 0 for a block
    without experts), as the reference's ``apply_block``.  Serving drops
    the aux.  Mode ``encode`` (an encoder block) returns no cache.
    ``cache_spec``: the block's entry of :func:`cache_specs` on a mesh
    (which piece of its k/v and cross caches this rank keeps), else
    None."""
    if mode not in ("prefill", "decode", "encode", "train"):
        raise ValueError(f"mode {mode!r}: 'prefill', 'decode', 'encode' or "
                         "'train'")
    x = rms_norm(h, p["ln1"], cfg.norm_eps)
    if layer_type == RWKV6:
        st = cache if mode == "decode" else {"mix": None, "ffn": None}
        out, mix_state = apply_time_mix(cfg, p["mix"], x, st["mix"], env=env)
        h = h + out
        x = rms_norm(h, p["ln2"], cfg.norm_eps)
        out, ffn_state = apply_channel_mix(cfg, p["ffn"], x, st["ffn"],
                                           env=env)
        if mode == "train":
            return h + out, _no_aux(h)
        return h + out, {"mix": mix_state, "ffn": ffn_state}
    if layer_type == RGLRU:
        if mode == "decode":
            out, st = apply_rglru_decode(cfg, p["mix"], x, cache["mix"],
                                         env=env)
        else:
            out, st = apply_rglru_seq(cfg, p["mix"], x, env=env)
        new_cache = {"mix": st}
    else:
        out, new_cache = apply_attention(cfg, p["mix"], x, mode=mode,
                                         positions=positions, cache=cache,
                                         cache_len=cache_len,
                                         layer_type=layer_type,
                                         kv_quant=kv_quant, env=env,
                                         cache_spec=(cache_spec or {}).get(
                                             "k"))
    h = h + out
    if "cross" in p:
        xc = rms_norm(h, p["ln_cross"], cfg.norm_eps)
        cross_spec = (cache_spec or {}).get("cross", {}).get("k")
        if mode == "decode":
            cross = cache["cross"]
            h = h + apply_cross_attention(cfg, p["cross"], xc, cross, env,
                                          cross_spec)
        else:
            cross = cross_kv(cfg, p["cross"], kv_memory, env)
            h = h + apply_cross_attention(cfg, p["cross"], xc, cross, env)
            cross = _length_shard(cross, cross_spec, env)
        if new_cache is not None:
            new_cache["cross"] = cross
    x = rms_norm(h, p["ln2"], cfg.norm_eps)
    aux = None
    if cfg.num_experts:
        out, aux_tok = apply_moe(cfg, p["ffn"], x,
                                 capacity_factor=capacity_factor, env=env)
        aux = torch.mean(aux_tok)
    else:
        out = apply_mlp(p["ffn"], x, env=env)
    if mode == "train":
        return h + out, _no_aux(h) if aux is None else aux
    return h + out, new_cache


def _no_aux(h: torch.Tensor) -> torch.Tensor:
    return torch.zeros((), dtype=torch.float32, device=h.device)


def apply_stack(cfg: ModelConfig, params: Params, h: torch.Tensor, *,
                mode: str, positions, caches: Optional[List] = None,
                cache_len: int = 0, lo: int = 0, hi: Optional[int] = None,
                capacity_factor: float = CAPACITY_FACTOR,
                kv_memory: Optional[torch.Tensor] = None,
                kv_quant: bool = False, remat: bool = False,
                env: MeshEnv = CPU_ENV, specs: Optional[List[dict]] = None):
    """Blocks [lo, hi) (default: all).  ``caches`` holds one cache per
    block of the range (decode), and ``specs`` on a mesh the spec of
    each one's cache (:func:`cache_specs`); returns (h, caches of the
    range), or in mode ``train`` (h, aux): the blocks' MoE aux losses summed in block
    order (float32).  ``remat`` (modes ``train`` and ``encode``, the
    encoder under training): each block runs under
    ``torch.utils.checkpoint`` (non-reentrant), which keeps only its input
    and recomputes the rest in the backward."""
    hi = cfg.num_layers if hi is None else hi
    if remat and mode not in ("train", "encode"):
        raise ValueError(f"remat is for modes 'train' and 'encode', not "
                         f"{mode!r}")
    types = cfg.layer_types()
    new_caches = []
    aux = _no_aux(h) if mode == "train" else None
    for i in range(lo, hi):
        c = caches[i - lo] if caches is not None else None
        # bound now: a checkpointed block is recomputed in the backward,
        # after this loop has moved on
        block = functools.partial(
            apply_block, cfg, params["layers"][i], mode=mode,
            positions=positions, cache=c, cache_len=cache_len,
            layer_type=types[i], capacity_factor=capacity_factor,
            kv_memory=kv_memory, kv_quant=kv_quant, env=env,
            cache_spec=specs[i - lo] if specs is not None else None)
        h, nc = (checkpoint(block, h, use_reentrant=False) if remat
                 else block(h))
        if aux is not None:
            aux = aux + nc
        else:
            new_caches.append(nc)
    return h, (aux if aux is not None else new_caches)


# ===========================================================================
# Caches
# ===========================================================================
def _kv_spec(env: MeshEnv, batch: int, L: int, Hkv: int) -> P:
    """The reference's sharding of a (B, L, Hkv, hd) k/v cache: over the
    model axis, (1) its heads when they divide TP, (2) else its length
    when that divides TP, over the batch axes and the model axis together
    when the batch does not shard (long_500k's B 1) and the length
    divides them all, (3) else nothing; the batch over the batch axes
    when it divides them."""
    b_ax = env.batch_if(batch)
    if env.tp > 1 and Hkv % env.tp == 0:
        return P(b_ax, None, "model", None)
    if env.tp > 1 and L % env.tp == 0:
        if b_ax is None and env.dp > 1 and L % (env.dp * env.tp) == 0:
            return P(None, tuple(env.batch_axes) + ("model",), None, None)
        return P(b_ax, "model", None, None)
    return P(b_ax, None, None, None)


def _layer_len(cfg: ModelConfig, layer_type: str, cache_len: int) -> int:
    return (min(cfg.window_size, cache_len) if layer_type == ATTN_LOCAL
            else cache_len)


def layer_cache_specs(cfg: ModelConfig, env: MeshEnv, layer_type: str,
                      batch: int, cache_len: int, cross_len: int = 0,
                      kv_quant: bool = False) -> dict:
    """The reference's specs of one block's cache, in the port's tree
    (:func:`init_layer_cache`): k/v by :func:`_kv_spec`, their int8
    scales by its first three entries; the RG-LRU's ``h`` (B, r) and
    ``conv`` (B, K-1, r) by channels when d_rnn divides TP; RWKV-6's
    ``s`` by heads when they divide TP, ``tm`` and ``cm`` by rows only;
    a cross cache by :func:`_kv_spec` of its source length."""
    b = env.batch_if(batch)
    if layer_type == RWKV6:
        h = "model" if heads_sharded(cfg, env) else None
        s = {"mix": {"s": P(b, h, None, None), "tm": P(b, None)},
             "ffn": {"cm": P(b, None)}}
    elif layer_type == RGLRU:
        r = "model" if env.tp > 1 and cfg.d_rnn % env.tp == 0 else None
        s = {"mix": {"h": P(b, r), "conv": P(b, None, r)}}
    else:
        sp = _kv_spec(env, batch, _layer_len(cfg, layer_type, cache_len),
                      cfg.num_kv_heads)
        s = {"k": sp, "v": sp}
        if kv_quant:
            s["k_scale"] = s["v_scale"] = P(*sp[:3])
    if cfg.enc_dec and cross_len:
        sp = _kv_spec(env, batch, cross_len, cfg.num_kv_heads)
        s["cross"] = {"k": sp, "v": sp}
    return s


def cache_specs(cfg: ModelConfig, env: MeshEnv, batch: int, cache_len: int,
                cross_len: int = 0, kv_quant: bool = False) -> List[dict]:
    """The spec of every block's cache (:func:`layer_cache_specs`): what
    the reference's ``init_caches`` returns as its specs, one entry a
    block where the reference stacks its tail and scan blocks."""
    return [layer_cache_specs(cfg, env, lt, batch, cache_len, cross_len,
                              kv_quant) for lt in cfg.layer_types()]


def _local_shape(shape, spec: P, env: MeshEnv) -> tuple:
    return tuple(n // env.axis_size(e) for n, e in
                 zip(shape, tuple(spec) + (None,) * (len(shape) - len(spec))))


def init_layer_cache(cfg: ModelConfig, batch: int, cache_len: int,
                     device, kv_quant: bool = False,
                     layer_type: str = ATTN_GLOBAL,
                     cross_len: int = 0, env: MeshEnv = CPU_ENV) -> dict:
    """Zero cache of one block: {"k", "v"} of (batch, L, Hkv, hd) in the
    model's dtype for attention, L = cache_len for a global block and
    min(window, cache_len) for a sliding-window ring, int8 with float32
    {"k_scale", "v_scale"} of (batch, L, Hkv) when ``kv_quant``;
    {"mix": {"s", "tm"}, "ffn": {"cm"}} in float32 for RWKV-6 and
    {"mix": {"h", "conv"}} for RG-LRU (no cache-length axis).  An
    encoder-decoder block with ``cross_len`` also gets "cross": {"k",
    "v"} of (batch, cross_len, Hkv, hd) in the model's dtype.  On a mesh
    (``env``; ``batch`` the global batch) this rank's piece of each,
    under :func:`layer_cache_specs`.  ``device="meta"`` allocates
    nothing."""
    dt = param_dtype(cfg)
    kv_shape = (cfg.num_kv_heads, cfg.head_dim)
    if layer_type == RWKV6:
        H, n = cfg.rwkv_num_heads, cfg.rwkv_head_dim
        c = {"mix": {"s": ((batch, H, n, n), torch.float32),
                     "tm": ((batch, cfg.d_model), torch.float32)},
             "ffn": {"cm": ((batch, cfg.d_model), torch.float32)}}
    elif layer_type == RGLRU:
        r, K = cfg.d_rnn, cfg.conv_width
        c = {"mix": {"h": ((batch, r), torch.float32),
                     "conv": ((batch, K - 1, r), dt)}}
    else:
        L = _layer_len(cfg, layer_type, cache_len)
        c = {n: ((batch, L) + kv_shape, torch.int8 if kv_quant else dt)
             for n in ("k", "v")}
        if kv_quant:
            c.update({n: ((batch, L, cfg.num_kv_heads), torch.float32)
                      for n in ("k_scale", "v_scale")})
    if cfg.enc_dec and cross_len:
        c["cross"] = {n: ((batch, cross_len) + kv_shape, dt)
                      for n in ("k", "v")}
    specs = layer_cache_specs(cfg, env, layer_type, batch, cache_len,
                              cross_len, kv_quant)

    def alloc(entry, spec):
        if isinstance(entry, dict):
            return {k: alloc(v, spec[k]) for k, v in entry.items()}
        shape, dtype = entry
        return torch.zeros(_local_shape(shape, spec, env), dtype=dtype,
                           device=device)

    return alloc(c, specs)


def init_caches(cfg: ModelConfig, batch: int, cache_len: int, device,
                kv_quant: bool = False, cross_len: int = 0,
                env: MeshEnv = CPU_ENV) -> List[dict]:
    """Zero caches of every block (this rank's pieces on a mesh)."""
    return [init_layer_cache(cfg, batch, cache_len, device, kv_quant, lt,
                             cross_len, env)
            for lt in cfg.layer_types()]


# ===========================================================================
# Top-level model functions
# ===========================================================================
def _embed_tokens(cfg: ModelConfig, params: Params, tokens: torch.Tensor,
                  env: MeshEnv = CPU_ENV) -> torch.Tensor:
    h = embed_lookup(params["embed"], tokens, env=env)
    return h * torch.tensor(math.sqrt(cfg.d_model), dtype=h.dtype)


def _positions(tokens: torch.Tensor) -> torch.Tensor:
    B, S = tokens.shape[:2]
    return torch.arange(S, device=tokens.device)[None, :].expand(B, S)


def _assemble_inputs(cfg: ModelConfig, params: Params, batch: dict,
                     env: MeshEnv = CPU_ENV) -> torch.Tensor:
    """The reference's ``_assemble_inputs``: the scaled token embeddings,
    with a VLM's ``patch_embeds`` (B, P, d) prepended (cast to their
    dtype) when ``cfg.frontend == "vit"``."""
    h = _embed_tokens(cfg, params, batch["tokens"], env)
    if cfg.frontend == "vit" and "patch_embeds" in batch:
        pe = batch["patch_embeds"].to(device=h.device, dtype=h.dtype)
        h = torch.cat([pe, h], dim=1)
    return h


def _encode(cfg: ModelConfig, params: Params, src_embeds: torch.Tensor,
            remat: bool = False, env: MeshEnv = CPU_ENV) -> torch.Tensor:
    """The encoder: src_embeds (B, Ss, d), cast to the model dtype,
    through the non-causal encoder blocks (positions 0..Ss-1) and
    ``enc_norm``, under ``env`` as the decoder; ``remat`` recomputes each
    block in the backward (the training loss)."""
    h = src_embeds.to(device=params["embed"].device,
                      dtype=params["embed"].dtype)
    h, _ = apply_stack(encoder_cfg(cfg), {"layers": params["encoder"]}, h,
                       mode="encode", positions=_positions(h), remat=remat,
                       env=env)
    return rms_norm(h, params["enc_norm"], cfg.norm_eps)


def head(cfg: ModelConfig, params: Params, h: torch.Tensor,
         env: MeshEnv = CPU_ENV):
    """Final norm, unembedding and greedy pick of (B, 1, d) hidden states:
    (logits (B, Vp), next token (B,)); with ``env.tp > 1`` the logits
    are this rank's vocab shard (B, Vp/tp) and the token the greedy pick
    over every shard."""
    h = rms_norm(h, params["final_norm"], cfg.norm_eps)
    table = params["embed"] if cfg.tie_embeddings else params["unembed"]
    logits = unembed_logits(h, table, transpose_table=cfg.tie_embeddings,
                            valid_vocab=cfg.vocab_size, env=env)[:, 0]
    return logits, sharded_argmax(logits, env=env)


def loss_fn(cfg: ModelConfig, params: Params, batch: dict, *,
            remat: bool = True,
            capacity_factor: float = CAPACITY_FACTOR,
            env: MeshEnv = CPU_ENV) -> tuple:
    """batch = {"tokens": (B, S), "labels": (B, S)}, with ``"patch_embeds"``
    (B, P, d) for a ``vit`` frontend (prepended; its positions are
    cropped before the loss) and ``"src_embeds"`` (B, Ss, d) for an
    encoder-decoder (encoded, then read by every decoder block's cross
    attention).  Returns (total, {"loss", "aux"}): the mean token cross
    entropy (float32) and the MoE aux loss summed over the blocks (0
    without experts), with ``total = loss + MOE_AUX_WEIGHT * aux``, as the
    reference's ``loss_fn``.  ``remat`` recomputes each block, the
    encoder's included, in the backward.  ``capacity_factor`` is the
    MoE's.  On a mesh (``env``), ``params`` are this rank's slices
    (:func:`param_specs`) and every rank of a model group returns the
    same loss; ``batch`` is this rank's rows (``src_embeds`` and
    ``patch_embeds`` included), and the loss their mean; ``aux`` is the
    MoE's, global on a data mesh and this data shard's with tp > 1, as
    the reference's (:func:`.moe.apply_moe`)."""
    check_supported(cfg, env)
    kv_memory = (_encode(cfg, params, batch["src_embeds"], remat=remat,
                         env=env) if cfg.enc_dec else None)
    h = _assemble_inputs(cfg, params, batch, env)
    offset = h.shape[1] - batch["tokens"].shape[1]
    h, aux = apply_stack(cfg, params, h, mode="train",
                         positions=_positions(h), remat=remat,
                         capacity_factor=capacity_factor,
                         kv_memory=kv_memory, env=env)
    h = rms_norm(h, params["final_norm"], cfg.norm_eps)
    if offset:
        h = h[:, offset:]
    table = params["embed"] if cfg.tie_embeddings else params["unembed"]
    tok_loss = fused_unembed_xent(h, table, batch["labels"],
                                  transpose_table=cfg.tie_embeddings,
                                  valid_vocab=cfg.vocab_size, env=env)
    loss = tok_loss.mean()
    return loss + MOE_AUX_WEIGHT * aux, {"loss": loss, "aux": aux}


def serving_rows(batch: dict, env: MeshEnv) -> tuple:
    """(this rank's rows of a global serving batch, the env its model
    code runs under).  The rows shard over the batch axes when the batch
    divides them (the reference's ``b_ax``); otherwise every data rank
    takes every row and runs as a replica, under an env without batch
    axes (so that an MoE's capacity counts the rows once)."""
    B = next(iter(batch.values())).shape[0]
    if env.dp <= 1:
        return batch, env
    if env.batch_if(B) is None:
        return batch, dataclasses.replace(env, batch_axes=())
    return {k: (env.local_slice(v, 0, env.batch())
                if torch.is_tensor(v) and v.dim() else v)
            for k, v in batch.items()}, env


def prefill(cfg: ModelConfig, params: Params, batch: dict, *,
            cache_len: int, kv_quant: bool = False, triangular: bool = False,
            env: MeshEnv = CPU_ENV):
    """batch = {"tokens": (B, S)}, with ``"patch_embeds"`` (B, P, d) for a
    ``vit`` frontend: the patches come first and positions run over all
    P + S; for an encoder-decoder, ``"src_embeds"`` (B, Ss, d), which the
    encoder reads and every decoder block's cross cache keeps.
    ``kv_quant``: int8 k/v caches with per-row scales.  ``triangular``
    is the reference's flag for skipping the kv blocks that the causal
    mask leaves out entirely; the attention kernel always skips them, so
    it changes nothing.  Returns (last-position logits (B, Vp), caches).

    On a mesh (``env``), ``params`` are this rank's slices and ``batch``
    the global batch, of which the rank takes its rows
    (:func:`serving_rows`); it returns its rows' logits over its vocab
    shard and its piece of every cache under :func:`cache_specs` of (B,
    max(cache_len, S + P), Ss, kv_quant)."""
    check_supported(cfg, env)
    B = batch["tokens"].shape[0]
    rows, renv = serving_rows(batch, env)
    kv_memory = (_encode(cfg, params, rows["src_embeds"], env=renv)
                 if cfg.enc_dec else None)
    h = _assemble_inputs(cfg, params, rows, renv)
    specs = None
    if env.is_spmd:
        specs = cache_specs(cfg, env, B, max(cache_len, h.shape[1]),
                            kv_memory.shape[1] if cfg.enc_dec else 0,
                            kv_quant)
    h, caches = apply_stack(cfg, params, h, mode="prefill",
                            positions=_positions(h), cache_len=cache_len,
                            kv_memory=kv_memory, kv_quant=kv_quant, env=renv,
                            specs=specs)
    logits, _ = head(cfg, params, h[:, -1:], renv)
    return logits, caches


def decode_step(cfg: ModelConfig, params: Params, token: torch.Tensor, pos,
                caches: List[dict], env: MeshEnv = CPU_ENV,
                specs: Optional[List[dict]] = None):
    """token (B, 1); pos: the position of this token, an int or (B,)
    per-sequence positions.  Returns (logits (B, Vp), next token (B,),
    caches) — the caches updated in place (an encoder-decoder's cross
    caches are read, not written).

    On a mesh (``env``), ``token`` and a (B,) ``pos`` are the global
    batch's, ``caches`` this rank's pieces and ``specs`` their
    :func:`cache_specs` (required: a piece's shape does not say which
    layout it is a piece of); the rank steps its rows and returns their
    logits over its vocab shard and their next tokens."""
    check_supported(cfg, env)
    if env.is_spmd and specs is None:
        raise ValueError("decode_step on a mesh needs the caches' specs "
                         "(cache_specs)")
    pos = torch.as_tensor(pos, device=token.device)
    inputs = {"token": token}
    if pos.dim():
        inputs["pos"] = pos
    rows, renv = serving_rows(inputs, env)
    h = _embed_tokens(cfg, params, rows["token"], renv)
    h, caches = apply_stack(cfg, params, h, mode="decode",
                            positions=rows.get("pos", pos), caches=caches,
                            capacity_factor=DECODE_CAPACITY_FACTOR,
                            env=renv, specs=specs)
    logits, nxt = head(cfg, params, h, renv)
    return logits, nxt, caches


__all__ = ["MOE_AUX_WEIGHT", "Params", "apply_attention",
           "apply_block", "apply_cross_attention", "apply_stack",
           "block_specs", "cache_specs", "check_supported", "cross_kv",
           "decode_step", "encoder_cfg", "head", "init_block", "init_caches",
           "init_layer_cache", "init_lm", "layer_cache_specs", "loss_fn",
           "param_specs", "prefill", "serving_rows"]
