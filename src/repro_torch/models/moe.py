"""Mixture-of-Experts FFN: router, capacity-bounded dispatch, the fused
expert SwiGLU and the combine, on one card or with expert parallelism
over a mesh.

The port of the JAX package's ``repro/models/moe.py``: the router runs
in float32 (softmax, top-k, renormalised gates), tokens are dispatched
to an (E, capacity, d) buffer by the reference's sort-based Switch
dispatch (a stable sort by expert, so the rank within an expert is token
order, and assignments past ``capacity`` drop), the experts' SwiGLU runs
through the fused kernel (:mod:`repro_torch.kernels.moe_gemm`), and each
token gathers its k expert outputs back, weighted by gate and keep, and
sums them in float32.

On a mesh (``env``), the reference's two capacity rules:

* ``tp > 1`` (expert parallelism): model rank m owns experts [m·E/tp,
  (m+1)·E/tp) (:func:`moe_specs`); it routes the model-replicated tokens
  of its data shard, dispatches only the assignments to its experts,
  runs the kernel on its (E/tp, C, d) buffer, and the partial outputs
  are summed over the model axis.  Capacity and the aux loss are per
  data shard, ``capacity_for((B // dp_shards)·S)``, as the reference's
  ``shard_map`` has them.  Its gradients are the reference's transpose:
  the router's and x's summed over the model axis, the aux loss's taken
  once (its cotangent divided by tp before that sum).
* ``tp <= 1`` on a data mesh: the reference routes the global batch
  under GSPMD, so capacity comes from the global token count, an
  assignment's rank within its expert counts the assignments of every
  earlier data rank (global token order), and the aux loss's ``me`` and
  ``ce`` are global means.  The port gathers each data rank's E
  per-expert counts and sums the gate columns over the batch axes
  (:meth:`MeshEnv.psum_both`: every rank uses the global aux whole, so
  the backward sums too); tokens are not gathered, since a kept token's
  output depends only on its own row, and each rank's buffer holds
  ``min(capacity, T_local)`` rows an expert.

Two departures, neither of which changes a float32 result: the buffer is
built with one index write (each kept (expert, rank) pair is unique, so
no accumulation is needed; dropped assignments land in a spare row that
is cut off), and the combine gathers instead of scatter-adding, so it
needs no atomics and gives the same bits from run to run.  In bfloat16
the combine sums in float32 where the reference sums in bfloat16 (and
the model axis's partial outputs are summed in float32 too), and the
expert products keep float32 until the output (the fused kernel's
contract).
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.moe_gemm import ops as moe_ops
from repro_torch.runtime.meshenv import CPU_ENV, MeshEnv, P
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


def moe_specs(cfg: ModelConfig, env: MeshEnv) -> dict:
    """The reference's MoE specs: the router replicated, the experts
    over the model axis (E must divide TP)."""
    if env.tp > 1 and cfg.num_experts % env.tp:
        raise ValueError(f"experts {cfg.num_experts} must divide EP size "
                         f"{env.tp}")
    return {"router": P(None, None), "wg": P("model", None, None),
            "wu": P("model", None, None), "wd": P("model", None, None)}


def capacity_for(tokens: int, cfg: ModelConfig, factor: float) -> int:
    """Rows per expert for ``tokens`` tokens: ceil(tokens·k/E·factor)."""
    return max(1, math.ceil(tokens * cfg.experts_per_token
                            / cfg.num_experts * factor))


class _ScaleGrad(torch.autograd.Function):
    """Identity forward, the gradient times ``scale`` backward."""

    @staticmethod
    def forward(ctx, x, scale):
        ctx.scale = scale
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g * ctx.scale, None


def _moe_local(x_flat: torch.Tensor, router: torch.Tensor,
               wg: torch.Tensor, wu: torch.Tensor, wd: torch.Tensor, *,
               num_experts: int, top_k: int, capacity: int,
               rows: Optional[int] = None, e0: int = 0,
               env: MeshEnv = CPU_ENV, data_axis=None
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Dispatch + expert compute + combine for x_flat (T, d) over the
    local experts [e0, e0 + E_local) (E_local = ``wg.shape[0]``), in a
    buffer of ``rows`` (default ``capacity``) rows an expert.  With
    ``data_axis`` the tokens are one data rank's share of a batch routed
    as a whole (the global capacity rule and global aux means).  Returns
    (y (T, d) float32, partial over the local experts; aux (T,) float32:
    the Switch load-balance loss, the same for every token)."""
    T, d = x_flat.shape
    E, k = num_experts, top_k
    E_local = wg.shape[0]
    rows = capacity if rows is None else rows
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
    gate_sum, total, tokens = gates.sum(dim=0), counts, T
    before = torch.zeros_like(counts)
    if data_axis is not None:
        parts = env.gather_parts(counts, data_axis)
        i = env.axis_index(data_axis)
        if i:
            before = torch.stack(parts[:i]).sum(dim=0)
        total = torch.stack(parts).sum(dim=0)
        tokens = T * len(parts)
        gate_sum = env.psum_both(gate_sum, data_axis)
    # Switch load-balance loss E·Σ f_e·p_e, broadcast per token
    me = gate_sum / tokens                                    # (E,)
    ce = total.float() / (tokens * k)
    aux = (E * torch.sum(me * ce)).expand(T)

    order = torch.sort(flat_e, stable=True).indices
    se = flat_e[order]
    ssrc = order // k
    offsets = torch.cumsum(counts, 0) - counts                # exclusive
    rank = torch.arange(T * k, device=dev) - offsets[se]
    keep = rank + before[se] < capacity
    if E_local != E:
        keep = keep & (se >= e0) & (se < e0 + E_local)
    # row of each sorted assignment in the flat (E_local*rows) buffer;
    # the dropped ones and other ranks' experts go to the spare row
    dst = torch.where(keep, (se - e0) * rows + rank,
                      torch.full_like(rank, E_local * rows))

    xbuf = torch.zeros((E_local * rows + 1, d), dtype=x_flat.dtype,
                       device=dev)
    xbuf[dst] = x_flat[ssrc]
    ybuf = moe_ops.moe_swiglu(xbuf[:E_local * rows].view(E_local, rows, d),
                              wg, wu, wd)

    # back to (T, k) order: inverse of the sort, then a gather
    row = torch.empty_like(dst)
    row[order] = dst
    yflat = torch.cat([ybuf.reshape(E_local * rows, d),
                       torch.zeros((1, d), dtype=ybuf.dtype, device=dev)])
    gate = torch.where(row < E_local * rows, g_top.reshape(-1), 0.0)
    y = (yflat[row].float() * gate[:, None]).reshape(T, k, d).sum(dim=1)
    return y, aux


def apply_moe(cfg: ModelConfig, p: Params, x: torch.Tensor, *,
              capacity_factor: float = 1.25, env: MeshEnv = CPU_ENV
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (B, S, d) -> (y (B, S, d), aux loss per token (B, S)).  On a
    mesh, x is this rank's rows of the global batch (replicated over the
    model axis) and ``p`` its slices (:func:`moe_specs`)."""
    B, S, d = x.shape
    E, k = cfg.num_experts, cfg.experts_per_token
    kw = dict(num_experts=E, top_k=k, env=env)
    if env.tp > 1:
        # B is this data shard's rows: the shard's tokens are what the
        # reference's capacity counts when the batch is sharded
        model = env.model_axis
        cap = capacity_for(B * S, cfg, capacity_factor)
        x_flat = env.psum_grad(x.reshape(B * S, d), model)
        router = env.psum_grad(p["router"], model)
        y, aux = _moe_local(x_flat, router, p["wg"], p["wu"], p["wd"],
                            capacity=cap,
                            e0=env.axis_index(model) * (E // env.tp), **kw)
        y = env.psum(y, model)
        aux = _ScaleGrad.apply(aux, 1.0 / env.tp)
    elif env.dp > 1:
        cap = capacity_for(B * env.dp * S, cfg, capacity_factor)
        y, aux = _moe_local(x.reshape(B * S, d), p["router"], p["wg"],
                            p["wu"], p["wd"], capacity=cap,
                            rows=min(cap, B * S), data_axis=env.batch(),
                            **kw)
    else:
        cap = capacity_for(B * S, cfg, capacity_factor)
        y, aux = _moe_local(x.reshape(B * S, d), p["router"], p["wg"],
                            p["wu"], p["wd"], capacity=cap, **kw)
    return y.to(x.dtype).reshape(B, S, d), aux.reshape(B, S)


__all__ = ["apply_moe", "capacity_for", "init_moe", "moe_specs"]
