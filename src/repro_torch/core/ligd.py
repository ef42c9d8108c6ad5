"""Li-GD: Loop-iteration Gradient Descent (paper Algorithm 1), batched.

The split point ``s`` is discrete, so a GD solve over the continuous
(B, r) runs once per candidate split, each warm-started from the
previous split's optimum (Corollary 4).  Variables live in normalized
coordinates x ∈ [0,1]² with projection onto the box constraints.

Two batched backends sit behind ``LiGDConfig.solver``:

* ``"fused"`` (default) — the fused whole-sweep solver of
  :mod:`repro_torch.kernels.ligd_step`: the CUDA kernel for tensors on
  the card, the plain PyTorch version for CPU tensors.
* ``"autodiff"`` — the oracle: ``torch.autograd.grad`` of the Eq. (19)
  utility, a loop over splits carrying the warm start, and the inner
  projected GD of :func:`_gd_solve` with the paper's stopping rules.

``solve_ligd`` (single user) always runs the oracle.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple, Tuple

import torch

from repro_torch.kernels.ligd_step import (ligd_sweep, pack_sweep_features,
                                           sweep_tables, table_tensor)
from .costs import LayerProfile, utility


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


def _value_and_grad(u_lanes: Callable, x: torch.Tensor):
    """(U (X,), dU/dx (K, X)) at x (K, X): the gradient of the lanes'
    summed utility, which is each lane's own gradient (lanes share no
    variable)."""
    with torch.enable_grad():
        xg = x.detach().requires_grad_(True)
        u = u_lanes(xg)
        (g,) = torch.autograd.grad(u.sum(), xg)
    return u.detach(), g


def _gd_solve(u_lanes: Callable, x0: torch.Tensor, cfg: "LiGDConfig"):
    """Projected GD with the paper's stopping rules for X independent
    lanes: u_lanes maps x (K, X) to U (X,).  Returns (x*, U*, iters),
    iters (X,) int32.

    The reference's ``_gd_solve`` under ``vmap``: a ``lax.while_loop``
    whose carry is (x, U(x), ∇U(x)).  Each iteration steps with the
    carried gradient and evaluates ``value_and_grad`` once at the new
    point; a lane stops when ‖g‖ < eps, |ΔU| < eps or max|Δx| < eps
    (g the carried gradient).  Every lane steps until all have stopped
    or ``max_iters`` is reached, and a lane that has stopped keeps its
    carry unchanged, as a vmapped while loop does."""
    x = x0.to(torch.float32)
    u, g = _value_and_grad(u_lanes, x)
    it = torch.zeros(x.shape[1], dtype=torch.int32, device=x.device)
    done = torch.zeros(x.shape[1], dtype=torch.bool, device=x.device)
    for _ in range(cfg.max_iters):
        if bool(done.all()):
            break
        x_new = torch.clamp(x - cfg.lr * g, 0.0, 1.0)
        u_new, g_new = _value_and_grad(u_lanes, x_new)
        stop = ((torch.linalg.vector_norm(g, dim=0) < cfg.eps)
                | ((u_new - u).abs() < cfg.eps)
                | ((x_new - x).abs().amax(dim=0) < cfg.eps))
        live = ~done
        x = torch.where(live, x_new, x)
        u = torch.where(live, u_new, u)
        g = torch.where(live, g_new, g)
        it = it + live.to(torch.int32)
        done = done | stop
    return x, u, it


def prefix_tensors(profile: LayerProfile, device):
    """(f_l, f_e, w) float32 (M+1,) tensors of the profile's prefix
    tables, as the reference's oracle rounds them."""
    return tuple(torch.as_tensor(t, dtype=torch.float32, device=device)
                 for t in profile.prefix_tables())


def _solve_ligd_autodiff(profile: LayerProfile, devs, edge,
                         cfg: LiGDConfig) -> LiGDResult:
    """The oracle for X lanes: devs leaves (X,), edge leaves (X,) or
    shared 0-d.  The reference's ``solve_ligd`` vmapped over users: a
    scan over the M + 1 splits, each a :func:`_gd_solve` from the
    previous split's optimum (or ``cfg.init``), then the argmin split."""
    X = devs["c_dev"].shape[0]
    device = devs["c_dev"].device
    f_l, f_e, w = prefix_tensors(profile, device)
    m_bits = torch.tensor(float(profile.result_bits), dtype=torch.float32,
                          device=device)
    u_fn = make_split_utility(devs, edge, f_l, f_e, w, m_bits)
    x_init = init_block(cfg.init, X, device)
    x = x_init
    U_all, B_all, r_all, iters = [], [], [], []
    for s in range(len(f_l)):
        x0 = x if cfg.warm_start else x_init
        x, u, it = _gd_solve(lambda xx, s=s: u_fn(s, xx)[0], x0, cfg)
        B, r = _denorm(edge, x)
        U_all.append(u)
        B_all.append(B)
        r_all.append(r)
        iters.append(it)
    U_all, B_all, r_all = (torch.stack(t, dim=1)
                           for t in (U_all, B_all, r_all))  # (X, M+1)
    best = torch.argmin(U_all, dim=1)
    pick = lambda t: t.gather(1, best[:, None])[:, 0]        # noqa: E731
    B_b, r_b = pick(B_all), pick(r_all)
    x_best = torch.stack([
        (B_b - edge["B_min"]) / (edge["B_max"] - edge["B_min"]),
        (r_b - edge["r_min"]) / (edge["r_max"] - edge["r_min"])])
    _, (T, E, C) = u_fn(best, x_best)
    return LiGDResult(split=best.to(torch.int32), B=B_b, r=r_b,
                      U=pick(U_all), T=T, E=E, C=C,
                      iters_per_layer=torch.stack(iters, dim=1),
                      U_per_layer=U_all, B_per_layer=B_all,
                      r_per_layer=r_all)


def lane(tree: dict) -> dict:
    """One user's 0-d leaves as a batch of one lane ((1,) leaves)."""
    return {k: torch.as_tensor(v).reshape(1) if torch.as_tensor(v).dim()
            == 0 else v for k, v in tree.items()}


def solve_ligd(profile: LayerProfile, dev, edge,
               cfg: LiGDConfig = LiGDConfig()) -> LiGDResult:
    """Solve one user's (s, B, r) — paper Algorithm 1, the autodiff
    oracle.  dev/edge: dicts of 0-d float32 tensors (``costs.dev_dict`` /
    ``costs.edge_dict``).  Fields are 0-d, per-layer fields (M+1,)."""
    res = _solve_ligd_autodiff(profile, lane(dev), edge, cfg)
    return LiGDResult(*(f[0] for f in res))


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
    ``edge`` may be shared (0-d) or per-user ((X,)).  Dispatches on
    ``cfg.solver`` (fused sweep vs. the autodiff oracle).  PyTorch runs
    eagerly, so there is no compile cache to key (the reference's
    ``solve_ligd_batch_jit``)."""
    if cfg.solver == "fused":
        return _solve_ligd_fused(profile, devs, edge, cfg)
    if cfg.solver == "autodiff":
        return _solve_ligd_autodiff(profile, devs, edge, cfg)
    raise ValueError(f"unknown LiGDConfig.solver: {cfg.solver!r}")
