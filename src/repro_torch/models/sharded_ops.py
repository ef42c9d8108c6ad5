"""Embedding, unembedding, the training loss and greedy sampling on one
card.

The single-device counterparts of the JAX package's
``repro/models/sharded_ops.py`` (whose ops reduce to these when the mesh
has one device): the vocabulary stays padded to a multiple of 128 so
that a reference parameter tree converts as it is, and phantom ids are
masked wherever logits are consumed.  Vocab sharding over a
``DeviceMesh`` waits for the tensor-parallel ROADMAP item.
"""
from __future__ import annotations

from typing import Optional

import torch


def padded_vocab(V: int, tp: int = 1) -> int:
    """Vocab padded to a multiple of lcm(tp, 128), as the reference pads
    it (one device: tp = 1)."""
    unit = 128
    while unit % max(tp, 1):
        unit += 128
    return -(-V // unit) * unit


def embed_lookup(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """table (Vp, d); ids (B, S) -> (B, S, d)."""
    return table[ids]


def unembed_logits(h: torch.Tensor, table: torch.Tensor, *,
                   transpose_table: bool,
                   valid_vocab: Optional[int] = None) -> torch.Tensor:
    """h (B, S, d) -> logits (B, S, Vp) in h's dtype; padded vocab ids
    get -1e30 so that sampling ignores them."""
    w = table.t() if transpose_table else table
    logits = h @ w.to(h.dtype)
    Vp = logits.shape[-1]
    if valid_vocab and valid_vocab < Vp:
        ids = torch.arange(Vp, device=logits.device)
        logits = torch.where(ids < valid_vocab, logits,
                             torch.tensor(-1e30, dtype=logits.dtype,
                                          device=logits.device))
    return logits


def fused_unembed_xent(h: torch.Tensor, table: torch.Tensor,
                       labels: torch.Tensor, *, transpose_table: bool,
                       valid_vocab: Optional[int] = None,
                       tp: int = 1) -> torch.Tensor:
    """Per-token cross entropy: h (B, S, d); ``table`` (Vp, d) when
    ``transpose_table`` (tied embeddings) else (d, Vp); labels (B, S) ->
    loss (B, S) float32.  The reference's single-device branch: float32
    logits of ``h @ table``, padded vocab rows past ``valid_vocab`` masked
    to -1e30, ``logsumexp`` minus the label's logit.  The vocab-sharded
    branch (``tp > 1``: no device holds the whole logits) waits for the
    mesh."""
    if tp > 1:
        raise NotImplementedError(
            "fused_unembed_xent with tp > 1 (vocab-sharded logits) waits "
            "for ROADMAP item 8 (the mesh)")
    w = table.t() if transpose_table else table
    logits = (h @ w).float()
    Vp = logits.shape[-1]
    V = valid_vocab or Vp
    if V < Vp:
        ids = torch.arange(Vp, device=logits.device)
        logits = torch.where(ids < V, logits,
                             torch.tensor(-1e30, device=logits.device))
    lse = torch.logsumexp(logits, dim=-1)
    ll = torch.gather(logits, -1, labels.long()[..., None])[..., 0]
    return lse - ll


def sharded_argmax(logits: torch.Tensor) -> torch.Tensor:
    """Greedy token (..., V) -> (...,) int64: the first index of the max,
    as ``jnp.argmax`` picks it."""
    return torch.argmax(logits, dim=-1)


__all__ = ["embed_lookup", "fused_unembed_xent", "padded_vocab",
           "sharded_argmax", "unembed_logits"]
