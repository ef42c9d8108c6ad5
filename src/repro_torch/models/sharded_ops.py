"""Vocab-sharded embedding, unembedding, training loss and greedy
sampling.

The port of the JAX package's ``repro/models/sharded_ops.py``.  With
the vocabulary sharded over the ``model`` axis no rank holds a whole
(V, d) table or (B, S, V) logits:

* ``embed_lookup``: a masked local gather, then an all-reduce (each
  rank gathers the ids of its vocab shard, the others add zeros);
* ``fused_unembed_xent``: per-rank (B, S, V/tp) logits and three (B, S)
  all-reduces (max, sum-exp, the label's logit);
* ``sharded_argmax``: the greedy token of vocab-sharded logits, a tie
  going to the smallest global index.

``env`` defaults to one process; every op is then the plain
single-device one (``tp <= 1``).  The vocabulary stays padded to a
multiple of lcm(tp, 128), so a reference parameter tree converts as it
is, and phantom ids are masked wherever logits are consumed.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.runtime.meshenv import CPU_ENV, MeshEnv

NEG_INF = -1e30


def padded_vocab(V: int, tp: int = 1) -> int:
    """Vocab padded to a multiple of lcm(tp, 128), as the reference pads
    it (one device: tp = 1)."""
    unit = 128
    while unit % max(tp, 1):
        unit += 128
    return -(-V // unit) * unit


def _shard_range(env: MeshEnv, n_local: int, device) -> tuple:
    """(first global id of this rank's vocab shard, its global ids)."""
    lo = env.axis_index(env.model_axis) * n_local
    return lo, lo + torch.arange(n_local, device=device)


def embed_lookup(table: torch.Tensor, ids: torch.Tensor, *,
                 env: MeshEnv = CPU_ENV) -> torch.Tensor:
    """table (Vp, d), or this rank's (Vp/tp, d) rows; ids (B, S) ->
    (B, S, d)."""
    if env.tp <= 1:
        return table[ids]
    n = table.shape[0]
    lo, _ = _shard_range(env, n, table.device)
    local = ids.long() - lo
    ok = (local >= 0) & (local < n)
    out = table[local.clamp(0, n - 1)]
    out = torch.where(ok[..., None], out, 0)
    return env.psum(out, env.model_axis)


def _mask_phantoms(logits: torch.Tensor, gids: torch.Tensor,
                   V: int) -> torch.Tensor:
    return torch.where(gids < V, logits,
                       torch.full((), NEG_INF, dtype=logits.dtype,
                                  device=logits.device))


def unembed_logits(h: torch.Tensor, table: torch.Tensor, *,
                   transpose_table: bool,
                   valid_vocab: Optional[int] = None,
                   env: MeshEnv = CPU_ENV) -> torch.Tensor:
    """h (B, S, d) -> logits (B, S, Vp) in h's dtype, or this rank's
    (B, S, Vp/tp) when the vocab is sharded; padded vocab ids get -1e30
    so that sampling ignores them."""
    w = table.t() if transpose_table else table
    if env.tp > 1:
        h = env.psum_grad(h, env.model_axis)
    logits = h @ w.to(h.dtype)
    n = logits.shape[-1]
    if env.tp > 1:
        _, gids = _shard_range(env, n, logits.device)
    else:
        gids = torch.arange(n, device=logits.device)
    if valid_vocab and valid_vocab < n * env.tp:
        logits = _mask_phantoms(logits, gids, valid_vocab)
    return logits


def fused_unembed_xent(h: torch.Tensor, table: torch.Tensor,
                       labels: torch.Tensor, *, transpose_table: bool,
                       valid_vocab: Optional[int] = None,
                       env: MeshEnv = CPU_ENV) -> torch.Tensor:
    """Per-token cross entropy: h (B, S, d); ``table`` (Vp, d) when
    ``transpose_table`` (tied embeddings) else (d, Vp), or this rank's
    vocab shard of it; labels (B, S) -> loss (B, S) float32.

    One rank: float32 logits of ``h @ table``, padded vocab rows past
    ``valid_vocab`` masked to -1e30, ``logsumexp`` minus the label's
    logit.  Vocab-sharded (``env.tp > 1``): the same from three (B, S)
    reductions over the model axis; the max stabiliser carries no
    gradient (its contribution cancels in lse - ll, the reference's
    ``stop_gradient``), and full logits never exist on a rank."""
    w = table.t() if transpose_table else table
    if env.tp <= 1:
        logits = (h @ w).float()
        Vp = logits.shape[-1]
        V = valid_vocab or Vp
        if V < Vp:
            logits = _mask_phantoms(
                logits, torch.arange(Vp, device=logits.device), V)
        lse = torch.logsumexp(logits, dim=-1)
        ll = torch.gather(logits, -1, labels.long()[..., None])[..., 0]
        return lse - ll
    model = env.model_axis
    h = env.psum_grad(h, model)
    logits = (h @ w).float()                        # (B, S, V_loc)
    n = logits.shape[-1]
    lo, gids = _shard_range(env, n, logits.device)
    logits = _mask_phantoms(logits, gids, valid_vocab or n * env.tp)
    gmax = env.pmax(logits.detach().amax(dim=-1), model)
    sumexp = env.psum(torch.exp(logits - gmax[..., None]).sum(dim=-1),
                      model)
    lse = torch.log(sumexp) + gmax
    local = labels.long() - lo
    ok = (local >= 0) & (local < n)
    ll = torch.gather(logits, -1, local.clamp(0, n - 1)[..., None])[..., 0]
    ll = env.psum(torch.where(ok, ll, 0.0), model)
    return lse - ll


def sharded_argmax(logits: torch.Tensor, *,
                   env: MeshEnv = CPU_ENV) -> torch.Tensor:
    """Greedy token (..., V) -> (...,) int64: the first index of the max,
    as ``jnp.argmax`` picks it; over vocab-sharded logits, the smallest
    global index that reaches the global max."""
    if env.tp <= 1:
        return torch.argmax(logits, dim=-1)
    model = env.model_axis
    lo, _ = _shard_range(env, logits.shape[-1], logits.device)
    lmax = logits.amax(dim=-1)
    larg = torch.argmax(logits, dim=-1) + lo
    gmax = env.pmax(lmax, model)
    cand = torch.where(lmax >= gmax, larg, torch.iinfo(torch.int64).max)
    return env.pmin(cand, model)


__all__ = ["embed_lookup", "fused_unembed_xent", "padded_vocab",
           "sharded_argmax", "unembed_logits"]
