"""MLi-GD: Mobility-aware Li-GD (paper Algorithm 2, §5), batched.

When a user moves into a new edge server's coverage it chooses between
R=0, re-solving (s, B, r) against the NEW server, and R=1, keeping the
original split/server and relaying back over the new AP's bandwidth
B_back and H₂ backhaul hops (Eq. 41–43).  R is relaxed to [0,1]; the
joint U = (1-R)·U₁ + R·U₂ is affine in R, so after the joint GD both
vertices are evaluated and the smaller wins (Corollary 7).

The joint solve dispatches on ``LiGDConfig.solver``: ``"fused"`` runs
the 4-variable variant of the fused sweep (CUDA kernel on the card,
plain PyTorch on the CPU), and nothing on that path moves a result to
the host, so under async replanning the solve stays in flight until the
planner applies it; ``"autodiff"`` runs the oracle, the warm-started
scan over splits around :func:`.ligd._gd_solve` on the joint utility.
Either way the vertex pick runs on the same device right after it.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.kernels.ligd_step import (mligd_sweep, pack_sweep_features,
                                           sweep_tables, table_tensor)
from .costs import (LayerProfile, energy_compute, energy_transmit, rent_cost,
                    t_device, t_server)
from .ligd import (LiGDConfig, LiGDResult, _denorm, _gd_solve, init_block,
                   lane, make_split_utility, prefix_tensors)


class MLiGDResult(NamedTuple):
    R: torch.Tensor              # 0 = re-solve at new server, 1 = relay back
    split: torch.Tensor          # s* (new split if R=0, original if R=1)
    B: torch.Tensor              # bandwidth at the serving AP (Hz)
    r: torch.Tensor              # compute units at the serving server
    U: torch.Tensor
    T: torch.Tensor
    E: torch.Tensor
    C: torch.Tensor
    U_recalc: torch.Tensor       # vertex utilities (diagnostics)
    U_back: torch.Tensor
    iters_per_layer: torch.Tensor


def u_transmit_back(dev, edge_new, orig, m_bits, B_back, hops_back):
    """U₂ (Eq. 41–43): original device+edge terms are constant; only the
    relay transmission through the new AP varies.  ``orig`` holds the
    frozen original strategy {f_l, f_e, w, r, B, rent}."""
    w = orig["w"]
    T = (t_device(dev, orig["f_l"])
         + t_server(dev, edge_new, orig["f_e"], orig["r"])
         + (w + m_bits) / B_back
         + hops_back * (w + m_bits) / edge_new["B_backhaul"])
    E = (energy_compute(dev, orig["f_l"])
         + energy_transmit(dev, edge_new, w, m_bits, B_back))
    # original server rent is unchanged; the new AP's bandwidth is rented.
    gB = edge_new["rho_B"] * torch.pow(
        B_back / edge_new["B0"], edge_new["gamma_B"])
    C = (orig["rent"] + gB) / dev["k_rounds"]
    U = dev["w_T"] * T + dev["w_E"] * E + dev["w_C"] * C
    return U, (T, E, C)


def _vertex_pick(devs, edge_new, origs, hops_back, m_bits, u1_fn, best_s,
                 x_best, iters) -> MLiGDResult:
    """Corollary 7: both vertices of R at the solved continuous variables
    x_best (4, X) and split best_s; the smaller utility wins (relay back
    only when strictly smaller)."""
    xB, xr, xR, xBb = x_best
    u1_star, (T1, E1, C1) = u1_fn(best_s.long(), (xB, xr))
    B_back = edge_new["B_min"] + xBb * (edge_new["B_max"]
                                        - edge_new["B_min"])
    u2_star, (T2, E2, C2) = u_transmit_back(devs, edge_new, origs, m_bits,
                                            B_back, hops_back)
    take_back = u2_star < u1_star                       # strict
    B1, r1 = _denorm(edge_new, (xB, xr))
    return MLiGDResult(
        R=take_back.to(torch.int32),
        split=torch.where(take_back, origs["split"], best_s),
        B=torch.where(take_back, B_back, B1),
        r=torch.where(take_back, origs["r"], r1),
        U=torch.minimum(u1_star, u2_star),
        T=torch.where(take_back, T2, T1),
        E=torch.where(take_back, E2, E1),
        C=torch.where(take_back, C2, C1),
        U_recalc=u1_star, U_back=u2_star, iters_per_layer=iters)


def _solve_mligd_autodiff(profile: LayerProfile, devs, edge_new, origs,
                          hops_back, cfg: LiGDConfig) -> MLiGDResult:
    """The oracle for X lanes (the reference's ``solve_mligd`` vmapped
    over users): x = (B, r, R, B_back) normalised, a scan over the M + 1
    splits, each a :func:`_gd_solve` of the joint utility (1 - R)·U₁ +
    R·U₂ from the previous split's optimum (or the cold start), then the
    argmin split and the vertex pick."""
    X = devs["c_dev"].shape[0]
    device = devs["c_dev"].device
    f_l, f_e, w = prefix_tensors(profile, device)
    m_bits = torch.tensor(float(profile.result_bits), dtype=torch.float32,
                          device=device)
    u1_fn = make_split_utility(devs, edge_new, f_l, f_e, w, m_bits)

    def joint_u(s, x4):
        u1, _ = u1_fn(s, x4[:2])
        B_back = edge_new["B_min"] + x4[3] * (edge_new["B_max"]
                                              - edge_new["B_min"])
        u2, _ = u_transmit_back(devs, edge_new, origs, m_bits, B_back,
                                hops_back)
        R = x4[2]
        return (1.0 - R) * u1 + R * u2

    x_init = init_block((*cfg.init, 0.5, 0.5), X, device)
    x = x_init
    U_all, X_all, iters = [], [], []
    for s in range(len(f_l)):
        x0 = x if cfg.warm_start else x_init
        x, u, it = _gd_solve(lambda xx, s=s: joint_u(s, xx), x0, cfg)
        U_all.append(u)
        X_all.append(x)
        iters.append(it)
    U_all = torch.stack(U_all, dim=1)                        # (X, M+1)
    best_s = torch.argmin(U_all, dim=1)
    x_best = torch.stack(X_all)[best_s, :, torch.arange(X, device=device)]
    return _vertex_pick(devs, edge_new, origs, hops_back, m_bits, u1_fn,
                        best_s.to(torch.int32), x_best.T,
                        torch.stack(iters, dim=1))


def solve_mligd(profile: LayerProfile, dev, edge_new, orig, hops_back,
                cfg: LiGDConfig = LiGDConfig()) -> MLiGDResult:
    """Joint (s, B, r, R, B_back) solve for one user after a handoff —
    the autodiff oracle.  dev/edge_new: 0-d leaves (dev's ``hops`` the
    hop count to the NEW server); orig: the frozen original strategy
    (:func:`orig_strategy_dict`, 0-d leaves); hops_back: H₂ hops from the
    new AP back to the ORIGINAL server."""
    res = _solve_mligd_autodiff(profile, lane(dev), edge_new, lane(orig),
                                torch.as_tensor(hops_back).reshape(1), cfg)
    return MLiGDResult(*(f[0] for f in res))


def _solve_mligd_fused(profile: LayerProfile, devs, edge_new, origs,
                       hops_back, cfg: LiGDConfig) -> MLiGDResult:
    """Batched fused joint sweep + the Corollary-7 vertex pick.  Every
    input is on the solve's device before the launch, so nothing after
    it copies from the host (a blocking copy would wait for the solve)."""
    X = devs["c_dev"].shape[0]
    device = devs["c_dev"].device
    tables = table_tensor(sweep_tables(profile), device)
    f_l, f_e, w = tables[:, 0], tables[:, 1], tables[:, 2]
    m_bits = float(profile.result_bits)

    init4 = (*cfg.init, 0.5, 0.5)
    feat = pack_sweep_features(devs, edge_new, m_bits, X, orig=origs,
                               hops_back=hops_back)
    res = mligd_sweep(feat, init_block(init4, X, device), tables,
                      lr=cfg.lr, eps=cfg.eps, max_iters=cfg.max_iters,
                      chunk=cfg.chunk, warm_start=cfg.warm_start,
                      init=init4)

    u1_fn = make_split_utility(devs, edge_new, f_l, f_e, w, m_bits)
    return _vertex_pick(devs, edge_new, origs, hops_back, m_bits, u1_fn,
                        res.best_s, res.best_x,
                        res.iters_layers.T.to(torch.int32))


def orig_strategy_dict(profile: LayerProfile, edge_orig, res: LiGDResult):
    """Freeze a Li-GD solution into the ``orig`` dict MLi-GD consumes."""
    tables = table_tensor(sweep_tables(profile), res.split.device)
    s = res.split.long()
    return {
        "split": res.split,
        "f_l": tables[:, 0][s],
        "f_e": tables[:, 1][s],
        "w": tables[:, 2][s],
        "r": res.r,
        "B": res.B,
        "rent": rent_cost(edge_orig, res.r, res.B),
    }


def solve_mligd_batch(profile: LayerProfile, devs, edge_new, origs,
                      hops_back, cfg: LiGDConfig = LiGDConfig()
                      ) -> MLiGDResult:
    """Batched handoff solve; ``edge_new`` may be shared or per-user.
    Dispatches on ``cfg.solver`` (fused sweep vs. the autodiff oracle)."""
    if cfg.solver == "fused":
        return _solve_mligd_fused(profile, devs, edge_new, origs,
                                  hops_back, cfg)
    if cfg.solver == "autodiff":
        return _solve_mligd_autodiff(profile, devs, edge_new, origs,
                                     hops_back, cfg)
    raise ValueError(f"unknown LiGDConfig.solver: {cfg.solver!r}")
