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
cover the dense decoder family in :func:`loss_fn` (ROADMAP item 8a):
each rank holds its slice of every parameter under
:func:`param_specs` (the reference's rules: q heads, padded to divide
TP, and k/v heads when they divide it over the model axis; ``wg``/``wu``
column- and ``wd`` row-parallel; the vocab of ``embed`` and ``unembed``
over the model axis); attention runs on the local heads, RMSNorm on the
replicated residual, and ``wo`` and ``wd`` end in an all-reduce over the
model axis.  The reference's sequence-sharded residual between blocks
is a GSPMD layout choice that does not change the numbers and is not
reproduced.  Any other family on a mesh raises
:class:`NotImplementedError` naming ROADMAP item 8b.
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
from .layers import (apply_mlp, apply_rope, attention_specs, init_attention,
                     init_mlp, init_norm, kv_sharded, mlp_specs, param_dtype,
                     rms_norm)
from .moe import apply_moe, init_moe
from .rglru import (apply_rglru_decode, apply_rglru_seq, init_rglru,
                    init_rglru_state)
from .rwkv import (apply_channel_mix, apply_time_mix, init_rwkv_channel_mix,
                   init_rwkv_state, init_rwkv_time_mix)
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


#: what a mesh other than one process waits for, for a family other
#: than the dense decoder
MESH_DEFERRED = ("{}: tensor and data parallelism for this family wait "
                 "for ROADMAP item 8b (only the dense decoder family runs "
                 "on a mesh)")


def _dense(cfg: ModelConfig) -> bool:
    """The dense decoder family: global/local attention with a SwiGLU
    MLP, no experts, no encoder, no frontend."""
    return (set(cfg.layer_types()) <= {ATTN_GLOBAL, ATTN_LOCAL}
            and not cfg.num_experts and not cfg.enc_dec and not cfg.frontend)


def check_supported(cfg: ModelConfig, env: MeshEnv = CPU_ENV) -> None:
    """Raise ``ValueError`` for a layer type the port does not know, and
    ``NotImplementedError`` for a family other than the dense decoder
    (global/local attention with a SwiGLU MLP, no experts, no encoder,
    no frontend) on a mesh with ``tp > 1`` or ``dp > 1``, or for the
    reference's context-parallel attention (ROADMAP item 8b)."""
    for lt in set(cfg.layer_types()):
        if lt not in (ATTN_GLOBAL, ATTN_LOCAL, RGLRU, RWKV6):
            raise ValueError(f"unknown layer type {lt!r}")
    if (env.tp > 1 or env.dp > 1) and not _dense(cfg):
        raise NotImplementedError(MESH_DEFERRED.format(cfg.name))
    if env.context_parallel_attn and env.tp > 1:
        raise NotImplementedError("context-parallel attention waits for "
                                  "ROADMAP item 8b")


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
    attention (an encoder-decoder stack).  ``env`` pads an attention
    block's q heads for its TP size."""
    rwkv = layer_type == RWKV6
    if layer_type in (RWKV6, RGLRU):
        init_mix = {RWKV6: init_rwkv_time_mix, RGLRU: init_rglru}[layer_type]
        mix = init_mix(cfg, gen, device)
    else:
        mix = init_attention(cfg, gen, device, env=env)
    p = {"ln1": init_norm(cfg, device), "mix": mix}
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
    slice is ``interop.shard_lm_params`` of them."""
    check_supported(cfg, env)
    device = gen.device if device is None else torch.device(device)
    dt = param_dtype(cfg)
    Vp = padded_vocab(cfg.vocab_size, env.tp)
    scale = 1.0 / math.sqrt(cfg.d_model)

    def table(shape):
        w = torch.randn(shape, generator=gen, device=gen.device,
                        dtype=torch.float32) * scale
        return w.to(device=device, dtype=dt)

    params: Params = {"embed": table((Vp, cfg.d_model)),
                      "final_norm": init_norm(cfg, device),
                      "layers": [init_block(cfg, gen, device, lt,
                                            cross=cfg.enc_dec, env=env)
                                 for lt in cfg.layer_types()]}
    if not cfg.tie_embeddings:
        params["unembed"] = table((cfg.d_model, Vp))
    if cfg.enc_dec:
        ecfg = encoder_cfg(cfg)
        params["encoder"] = [init_block(ecfg, gen, device, lt)
                             for lt in ecfg.layer_types()]
        params["enc_norm"] = init_norm(cfg, device)
    return params


def block_specs(cfg: ModelConfig, env: MeshEnv) -> dict:
    """The reference's specs of one dense block, global or local
    (``init_block``)."""
    return {"ln1": P(None), "mix": attention_specs(cfg, env),
            "ln2": P(None), "ffn": mlp_specs(cfg, env)}


def param_specs(cfg: ModelConfig, env: MeshEnv) -> Params:
    """The reference's ``PartitionSpec`` of every parameter of the dense
    family under ``env``, in the port's tree (``layers`` one block
    each, where the reference stacks its scan blocks): ``embed`` P("model", None), ``unembed`` P(None, "model"),
    norms replicated, attention and MLP as ``models.layers`` says.  Other
    families raise (ROADMAP item 8b)."""
    if not _dense(cfg):
        raise NotImplementedError(MESH_DEFERRED.format(cfg.name))
    specs = {"embed": P("model", None), "final_norm": P(None),
             "layers": [block_specs(cfg, env)
                        for _ in range(cfg.num_layers)]}
    if not cfg.tie_embeddings:
        specs["unembed"] = P(None, "model")
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
    are this rank's; replicated k/v are cut to the heads the local q
    heads read.  A replicated tensor that only part of each rank's
    computation uses (x, replicated wk/wv, the qk-norm weights) enters
    through ``psum_grad``, so its gradient is the sum over the model
    axis."""
    B, S, d = x.shape
    wk, wv = p["wk"], p["wv"]
    q_norm, k_norm = p.get("q_norm"), p.get("k_norm")
    tp = env.tp > 1
    if tp:
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
    q = apply_rope(q, positions, theta)
    k = apply_rope(k, positions, theta)
    if tp and not kv_sharded(cfg, env):
        heads = _local_kv_heads(cfg, env, q.shape[2], k.device)
        k, v = k.index_select(2, heads), v.index_select(2, heads)
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
                    kv_quant: bool = False, env: MeshEnv = CPU_ENV):
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
    on a local layer), no cache; with ``env.tp > 1`` on this rank's
    heads (:func:`_project_qkv`), the output summed over the model
    axis."""
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
    elif mode in ("prefill", "encode", "train"):
        q, k, v = _project_qkv(cfg, p, x, positions, layer_type, env)
        out = flash_ops.flash_attention(q, k, v, causal=mode != "encode",
                                        window=W)
        new_cache = None
        if mode == "prefill":
            L = min(W, max(cache_len, S)) if W else max(cache_len, S)
            new_cache = {n: _to_ring(t, L) for n, t in
                         _kv_rows(k, v, kv_quant, param_dtype(cfg)).items()}
    else:
        raise ValueError(f"mode {mode!r}: 'prefill', 'decode', 'encode' or "
                         "'train'")
    Hq, hd = p["wo"].shape[:2]
    out = out.reshape(B, S, Hq * hd) @ p["wo"].reshape(Hq * hd, d)
    if env.tp > 1:
        out = env.psum(out, env.model_axis)
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
                kv_quant: bool = False, env: MeshEnv = CPU_ENV):
    """Residual block: the mixer (attention, RWKV-6 time mix or RG-LRU),
    in a decoder block with ``cross`` then cross attention to the encoder
    output (its k/v built from ``kv_memory`` at prefill, read from the
    cache at decode), then the FFN (SwiGLU MLP, MoE or RWKV-6 channel
    mix), each behind an RMSNorm.
    Returns (h, cache); mode ``train`` returns (h, aux) instead: the
    mean of the MoE's per-token load-balance loss (float32; 0 for a block
    without experts), as the reference's ``apply_block``.  Serving drops
    the aux.  Mode ``encode`` (an encoder block) returns no cache."""
    if mode not in ("prefill", "decode", "encode", "train"):
        raise ValueError(f"mode {mode!r}: 'prefill', 'decode', 'encode' or "
                         "'train'")
    x = rms_norm(h, p["ln1"], cfg.norm_eps)
    if layer_type == RWKV6:
        st = cache if mode == "decode" else {"mix": None, "ffn": None}
        out, mix_state = apply_time_mix(cfg, p["mix"], x, st["mix"])
        h = h + out
        x = rms_norm(h, p["ln2"], cfg.norm_eps)
        out, ffn_state = apply_channel_mix(cfg, p["ffn"], x, st["ffn"])
        if mode == "train":
            return h + out, _no_aux(h)
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
                                         kv_quant=kv_quant, env=env)
    h = h + out
    if "cross" in p:
        cross = (cache["cross"] if mode == "decode"
                 else cross_kv(cfg, p["cross"], kv_memory))
        h = h + apply_cross_attention(
            cfg, p["cross"], rms_norm(h, p["ln_cross"], cfg.norm_eps), cross)
        if new_cache is not None:
            new_cache["cross"] = cross
    x = rms_norm(h, p["ln2"], cfg.norm_eps)
    aux = None
    if cfg.num_experts:
        out, aux_tok = apply_moe(cfg, p["ffn"], x,
                                 capacity_factor=capacity_factor)
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
                env: MeshEnv = CPU_ENV):
    """Blocks [lo, hi) (default: all).  ``caches`` holds one cache per
    block of the range (decode); returns (h, caches of the range), or in
    mode ``train`` (h, aux): the blocks' MoE aux losses summed in block
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
            kv_memory=kv_memory, kv_quant=kv_quant, env=env)
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
            remat: bool = False) -> torch.Tensor:
    """The encoder: src_embeds (B, Ss, d), cast to the model dtype,
    through the non-causal encoder blocks (positions 0..Ss-1) and
    ``enc_norm``; ``remat`` recomputes each block in the backward (the
    training loss)."""
    h = src_embeds.to(device=params["embed"].device,
                      dtype=params["embed"].dtype)
    h, _ = apply_stack(encoder_cfg(cfg), {"layers": params["encoder"]}, h,
                       mode="encode", positions=_positions(h), remat=remat)
    return rms_norm(h, params["enc_norm"], cfg.norm_eps)


def head(cfg: ModelConfig, params: Params, h: torch.Tensor):
    """Final norm, unembedding and greedy pick of (B, 1, d) hidden states:
    (logits (B, Vp), next token (B,))."""
    h = rms_norm(h, params["final_norm"], cfg.norm_eps)
    table = params["embed"] if cfg.tie_embeddings else params["unembed"]
    logits = unembed_logits(h, table, transpose_table=cfg.tie_embeddings,
                            valid_vocab=cfg.vocab_size)[:, 0]
    return logits, sharded_argmax(logits)


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
    MoE's.  With a tensor-parallel ``env`` (dense family only),
    ``params`` are this rank's slices (:func:`param_specs`) and every
    rank of a model group returns the same loss; ``batch`` is this
    rank's rows, and the loss their mean."""
    check_supported(cfg, env)
    kv_memory = (_encode(cfg, params, batch["src_embeds"], remat=remat)
                 if cfg.enc_dec else None)
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


__all__ = ["MESH_DEFERRED", "MOE_AUX_WEIGHT", "Params", "apply_attention",
           "apply_block", "apply_cross_attention", "apply_stack",
           "block_specs", "check_supported", "cross_kv", "decode_step",
           "encoder_cfg", "head", "init_block", "init_caches",
           "init_layer_cache", "init_lm", "loss_fn", "param_specs",
           "prefill"]
