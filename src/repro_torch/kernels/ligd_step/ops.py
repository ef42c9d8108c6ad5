"""Public entry points of the fused sweep and the single-split steps:
dispatch on the tensor's device.

A CUDA tensor goes to the hand-written kernel (:func:`.kernel.sweep_cuda`,
:func:`.steps.ligd_steps_grouped_cuda`) or raises; a CPU tensor goes to
the plain PyTorch version (:mod:`.ref`).
There is no other route and no fallback.

The batch axis carries no meaning of its own: callers may tile it per
(user, candidate) as long as every feature row is gathered per lane.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from .kernel import sweep_cuda
from .ref import (check_groups, edge_tuple_of, ligd_steps_grouped_ref,
                  ligd_sweep_ref, mligd_sweep_ref, table_tensor)
from .steps import ligd_steps_grouped_cuda


def ligd_steps(feat, x0, edge: dict, *, iters: int = 64, lr: float = 0.15):
    """``iters`` projected-GD steps at one split point per row: feat
    (X, NF), x0 (X, 2), ``edge`` the server's constants (dict of floats
    or 0-d tensors) -> (x (X, 2), U (X,)).  The one-group case of
    :func:`ligd_steps_grouped`."""
    return ligd_steps_grouped(feat, x0, (0, feat.shape[0]), (edge,),
                              iters=iters, lr=lr)


def ligd_steps_grouped(feats, x0s, offsets, edges, *, iters: int = 64,
                       lr: float = 0.15):
    """The steps for G groups of users, each against its own edge server,
    in one launch on the card: feats (X, NF) and x0s (X, 2) hold the
    groups' rows concatenated, group j at ``offsets[j]:offsets[j + 1]``
    (G + 1 non-decreasing host ints from 0 to X), ``edges`` G dicts of
    constants.  Returns (x (X, 2), U (X,)), each row what
    :func:`ligd_steps` returns for its group alone.  On the CPU: the
    plain version, group by group (the same checks of the groups)."""
    ets = [edge_tuple_of(e) for e in edges]
    if feats.device.type == "cuda":
        return ligd_steps_grouped_cuda(feats, x0s, offsets, ets,
                                       iters=iters, lr=lr)
    if feats.device.type == "cpu":
        start = check_groups(offsets, ets, feats.shape[0])
        return ligd_steps_grouped_ref(feats, x0s, start,
                                      [dict(et) for et in ets],
                                      iters=iters, lr=lr)
    raise ValueError(f"ligd_steps: unsupported device {feats.device}")


class SweepResult(NamedTuple):
    """Whole-sweep solve, layer-major: per-layer tensors are (M1, X)."""
    u_layers: torch.Tensor       # utility per split
    xB_layers: torch.Tensor      # normalized B per split
    xr_layers: torch.Tensor      # normalized r per split
    iters_layers: torch.Tensor   # per-lane GD iterations per split (f32)
    best_s: torch.Tensor         # (X,) int32 — argmin over splits
    best_x: tuple                # K× (X,) normalized optimum at best_s
    best_u: torch.Tensor         # (X,)


def _sweep(feat, x0, tables, *, joint, lr, eps, max_iters, chunk,
           warm_start, init) -> SweepResult:
    tab = table_tensor(tables, feat.device)
    if feat.device.type == "cuda":
        u, xB, xr, it, best = sweep_cuda(
            feat, x0, tab, joint=joint, lr=lr, eps=eps, max_iters=max_iters,
            warm_start=warm_start, init=init)
        best_s, best_u = best[0], best[1]
        best_x = tuple(best[2 + i] for i in range(x0.shape[0]))
    elif feat.device.type == "cpu":
        ref = mligd_sweep_ref if joint else ligd_sweep_ref
        u, (xB, xr, *_rest), it, best_s, best_x, best_u = ref(
            feat, x0, tab, lr=lr, eps=eps, max_iters=max_iters,
            chunk=chunk, warm_start=warm_start, init=init)
    else:
        raise ValueError(f"fused sweep: unsupported device {feat.device}")
    return SweepResult(u, xB, xr, it, best_s.to(torch.int32), best_x, best_u)


def ligd_sweep(feat, x0, tables, *, lr=0.15, eps=1e-5, max_iters=400,
               chunk=16, warm_start=True, init=(0.5, 0.5)) -> SweepResult:
    """Fused whole-sweep Li-GD over x = (B, r)."""
    return _sweep(feat, x0, tables, joint=False, lr=lr, eps=eps,
                  max_iters=max_iters, chunk=chunk, warm_start=warm_start,
                  init=init)


def mligd_sweep(feat, x0, tables, *, lr=0.15, eps=1e-5, max_iters=400,
                chunk=16, warm_start=True, init=(0.5, 0.5, 0.5, 0.5)
                ) -> SweepResult:
    """Fused whole-sweep MLi-GD joint (B, r, R, B_back) solve."""
    return _sweep(feat, x0, tables, joint=True, lr=lr, eps=eps,
                  max_iters=max_iters, chunk=chunk, warm_start=warm_start,
                  init=init)
