"""Mixture-of-Experts FFN on one card: router, capacity-bounded dispatch,
the fused expert SwiGLU and the combine.

The port of the JAX package's ``repro/models/moe.py`` on its
single-device path (``e0 = 0``, every expert local): the router runs in
float32 (softmax, top-k, renormalised gates), tokens are dispatched to
an (E, capacity, d) buffer by the reference's sort-based Switch dispatch
(a stable sort by expert, so the rank within an expert is token order,
and assignments past ``capacity`` drop), the experts' SwiGLU runs through
the fused kernel (:mod:`repro_torch.kernels.moe_gemm`), and each token
gathers its k expert outputs back, weighted by gate and keep, and sums
them in float32.  Expert parallelism over a mesh, with the reference's
capacity rule (global on a pure data mesh, per data shard with tp > 1),
waits for ROADMAP item 8b.

Two departures, neither of which changes a float32 result: the buffer is
built with one index write (each kept (expert, rank) pair is unique, so
no accumulation is needed; dropped assignments land in a spare row that
is cut off), and the combine gathers instead of scatter-adding, so it
needs no atomics and gives the same bits from run to run.  In bfloat16
the combine sums in float32 where the reference sums in bfloat16, and
the expert products keep float32 until the output (the fused kernel's
contract).
"""
from __future__ import annotations

import math
from typing import Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.moe_gemm import ops as moe_ops
from .layers import dense_init, param_dtype

Params = dict


def init_moe(cfg: ModelConfig, gen: torch.Generator, device) -> Params:
    """Router (d, E) in float32; expert weights wg/wu (E, d, ff) and wd
    (E, ff, d) in the model's dtype."""
    d, ff, E = cfg.d_model, cfg.d_ff, cfg.num_experts
    dt = param_dtype(cfg)
    return {"router": dense_init(gen, (d, E), d, torch.float32, device),
            "wg": dense_init(gen, (E, d, ff), d, dt, device),
            "wu": dense_init(gen, (E, d, ff), d, dt, device),
            "wd": dense_init(gen, (E, ff, d), ff, dt, device)}


def capacity_for(tokens: int, cfg: ModelConfig, factor: float) -> int:
    """Rows per expert for ``tokens`` tokens: ceil(tokens·k/E·factor)."""
    return max(1, math.ceil(tokens * cfg.experts_per_token
                            / cfg.num_experts * factor))


def _moe_local(x_flat: torch.Tensor, router: torch.Tensor,
               wg: torch.Tensor, wu: torch.Tensor, wd: torch.Tensor, *,
               num_experts: int, top_k: int, capacity: int
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Dispatch + expert compute + combine for x_flat (T, d) over all E
    experts.  Returns (y (T, d) in x's dtype, aux (T,) float32: the
    Switch load-balance loss, the same for every token)."""
    T, d = x_flat.shape
    E, k = num_experts, top_k
    dev = x_flat.device

    logits = x_flat.float() @ router                          # (T, E)
    gates = torch.softmax(logits, dim=-1)
    g_top, idx_top = torch.topk(gates, k, dim=-1)             # (T, k)
    g_top = g_top / torch.sum(g_top, -1, keepdim=True).clamp_min(1e-9)

    flat_e = idx_top.reshape(-1)                              # (T*k,)
    # an integer index_add, exact in any order (bincount on CUDA would
    # wait for the device to size its output)
    counts = torch.zeros((E,), dtype=flat_e.dtype, device=dev).index_add_(
        0, flat_e, torch.ones_like(flat_e))
    # Switch load-balance loss E·Σ f_e·p_e, broadcast per token
    me = gates.mean(dim=0)                                    # (E,)
    ce = counts.float() / (T * k)
    aux = (E * torch.sum(me * ce)).expand(T)

    order = torch.sort(flat_e, stable=True).indices
    se = flat_e[order]
    ssrc = order // k
    offsets = torch.cumsum(counts, 0) - counts                # exclusive
    rank = torch.arange(T * k, device=dev) - offsets[se]
    keep = rank < capacity
    # row of each sorted assignment in the flat (E*capacity) buffer; the
    # dropped ones go to the spare row E*capacity
    dst = torch.where(keep, se * capacity + rank,
                      torch.full_like(rank, E * capacity))

    xbuf = torch.zeros((E * capacity + 1, d), dtype=x_flat.dtype, device=dev)
    xbuf[dst] = x_flat[ssrc]
    ybuf = moe_ops.moe_swiglu(xbuf[:E * capacity].view(E, capacity, d),
                              wg, wu, wd)

    # back to (T, k) order: inverse of the sort, then a gather
    row = torch.empty_like(dst)
    row[order] = dst
    yflat = torch.cat([ybuf.reshape(E * capacity, d),
                       torch.zeros((1, d), dtype=ybuf.dtype, device=dev)])
    gate = torch.where(row < E * capacity, g_top.reshape(-1), 0.0)
    y = (yflat[row].float() * gate[:, None]).reshape(T, k, d).sum(dim=1)
    return y.to(x_flat.dtype), aux


def apply_moe(cfg: ModelConfig, p: Params, x: torch.Tensor, *,
              capacity_factor: float = 1.25
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (B, S, d) -> (y (B, S, d), aux loss per token (B, S))."""
    B, S, d = x.shape
    cap = capacity_for(B * S, cfg, capacity_factor)
    y, aux = _moe_local(x.reshape(B * S, d), p["router"], p["wg"], p["wu"],
                        p["wd"], num_experts=cfg.num_experts,
                        top_k=cfg.experts_per_token, capacity=cap)
    return y.reshape(B, S, d), aux.reshape(B, S)


__all__ = ["apply_moe", "capacity_for", "init_moe"]
