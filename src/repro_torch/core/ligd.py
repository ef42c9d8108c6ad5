"""Li-GD: Loop-iteration Gradient Descent (paper Algorithm 1), batched.

The split point ``s`` is discrete, so a GD solve over the continuous
(B, r) runs once per candidate split, each warm-started from the
previous split's optimum (Corollary 4).  Variables live in normalized
coordinates x ∈ [0,1]² with projection onto the box constraints.

The batched solve is the fused whole-sweep solver of
:mod:`repro_torch.kernels.ligd_step`: the CUDA kernel for tensors on the
card, the plain PyTorch version for CPU tensors.  The JAX package's
autodiff oracle (``solve_ligd`` / ``_gd_solve``) is not ported yet:
``solver="autodiff"`` raises (ROADMAP, queue 1, item 4).
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Tuple

import torch

from repro_torch.kernels.ligd_step import (ligd_sweep, pack_sweep_features,
                                           sweep_tables, table_tensor)
from .costs import LayerProfile, utility

AUTODIFF_DEFERRED = ("the autodiff oracle (solver='autodiff') is not "
                     "ported yet: ROADMAP, queue 1, item 4")


@dataclasses.dataclass(frozen=True)
class LiGDConfig:
    lr: float = 0.15             # step size λ (normalized coordinates)
    eps: float = 1e-5            # accuracy threshold ε
    max_iters: int = 400         # per-layer iteration cap
    init: Tuple[float, float] = (0.5, 0.5)   # cold-start (B, r) normalized
    warm_start: bool = True      # Li-GD warm start (False = plain GD ×M)
    solver: str = "fused"        # batched backend: "fused" | "autodiff"
    chunk: int = 1               # plain version: GD steps between checks
                                 # for a live lane (the CUDA kernel stops
                                 # each lane on its own and ignores it)


class LiGDResult(NamedTuple):
    """Per-user solution, (X,) tensors; per-layer fields are (X, M+1)."""
    split: torch.Tensor          # s* ∈ [0, M] (int32)
    B: torch.Tensor              # B* (Hz)
    r: torch.Tensor              # r* (units)
    U: torch.Tensor              # utility at optimum
    T: torch.Tensor              # delay at optimum (s)
    E: torch.Tensor              # device energy (J)
    C: torch.Tensor              # renting cost per round ($)
    iters_per_layer: torch.Tensor  # (X, M+1) GD iterations per split
    U_per_layer: torch.Tensor    # (X, M+1)
    B_per_layer: torch.Tensor    # (X, M+1)
    r_per_layer: torch.Tensor    # (X, M+1)


def _denorm(edge, x):
    B = edge["B_min"] + x[0] * (edge["B_max"] - edge["B_min"])
    r = edge["r_min"] + x[1] * (edge["r_max"] - edge["r_min"])
    return B, r


def make_split_utility(dev, edge, f_l, f_e, w, m_bits):
    """U(s, x) for normalized x; s (a long tensor) indexes the prefix
    tables."""
    def u_fn(s, x):
        B, r = _denorm(edge, x)
        return utility(dev, edge, f_l[s], f_e[s], w[s], m_bits, B, r)
    return u_fn


def init_block(init, X: int, device) -> torch.Tensor:
    """(len(init), X) float32 starting point, filled on the device (no
    host-to-device copy)."""
    return torch.stack([torch.full((X,), float(v), dtype=torch.float32,
                                   device=device) for v in init])


def _solve_ligd_fused(profile: LayerProfile, devs, edge,
                      cfg: LiGDConfig) -> LiGDResult:
    """One fused launch for all users × all splits.  devs leaves are
    (X,); edge leaves are (X,) or shared 0-d tensors."""
    X = devs["c_dev"].shape[0]
    device = devs["c_dev"].device
    tables = table_tensor(sweep_tables(profile), device)   # (M1, 4)
    f_l, f_e, w = tables[:, 0], tables[:, 1], tables[:, 2]
    m_bits = float(profile.result_bits)

    feat = pack_sweep_features(devs, edge, m_bits, X)
    res = ligd_sweep(feat, init_block(cfg.init, X, device), tables,
                     lr=cfg.lr, eps=cfg.eps, max_iters=cfg.max_iters,
                     chunk=cfg.chunk, warm_start=cfg.warm_start,
                     init=cfg.init)

    B_span = edge["B_max"] - edge["B_min"]
    r_span = edge["r_max"] - edge["r_min"]
    B, r = _denorm(edge, res.best_x)
    u_fn = make_split_utility(devs, edge, f_l, f_e, w, m_bits)
    _, (T, E, C) = u_fn(res.best_s.long(), res.best_x)
    return LiGDResult(
        split=res.best_s, B=B, r=r, U=res.best_u, T=T, E=E, C=C,
        iters_per_layer=res.iters_layers.T.to(torch.int32),
        U_per_layer=res.u_layers.T,
        B_per_layer=(edge["B_min"] + res.xB_layers * B_span).T,
        r_per_layer=(edge["r_min"] + res.xr_layers * r_span).T)


def solve_ligd_batch(profile: LayerProfile, devs, edge,
                     cfg: LiGDConfig = LiGDConfig()) -> LiGDResult:
    """Batched solve over users: ``devs`` leaves have a leading X axis;
    ``edge`` may be shared (0-d) or per-user ((X,)).  PyTorch runs
    eagerly, so there is no compile cache to key (the reference's
    ``solve_ligd_batch_jit``)."""
    if cfg.solver == "fused":
        return _solve_ligd_fused(profile, devs, edge, cfg)
    if cfg.solver == "autodiff":
        raise NotImplementedError(AUTODIFF_DEFERRED)
    raise ValueError(f"unknown LiGDConfig.solver: {cfg.solver!r}")
