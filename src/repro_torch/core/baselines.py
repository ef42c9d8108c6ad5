"""Comparison baselines from the paper's §6: Device-Only, Edge-Only,
Neurosurgeon [29], and DNN-Surgery/DADS [14], on tensors.

The port of the JAX package's ``repro/core/baselines.py``.  None of these
optimize the (B, r) allocation — that is MCSA's contribution.  They
receive a *static* fair allocation: bandwidth at ``B_max`` and compute
units proportional to the offloaded model fraction,

    r_base(s) = r_min + (r_max - r_min) · f_e(s)/f_total,

so Edge-Only (s=0) rents the most units and partial offloads rent
proportionally.  DNN-Surgery additionally caps the rentable units (its
resource-limitation assumption).

Every evaluator is batched over users: ``dev`` leaves are (X,) tensors,
``edge`` leaves (X,) or shared 0-d.  Where the reference ``vmap``s over
the split points, the latency-greedy baselines evaluate an (X, M+1)
block through :func:`repro_torch.core.costs.utility` and take the first
minimum over T (``torch.argmin``, like ``jnp.argmin``).  This is plain
tensor code on the caller's device: the reference has no Pallas kernel
here.  ``repro_torch.api.policies`` re-homes these as fleet policies.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from .costs import LayerProfile, utility


class BaselineResult(NamedTuple):
    split: torch.Tensor
    B: torch.Tensor
    r: torch.Tensor
    U: torch.Tensor
    T: torch.Tensor
    E: torch.Tensor
    C: torch.Tensor


def _tables(profile: LayerProfile, device):
    f_l, f_e, w = profile.prefix_tables()
    as_t = lambda a: torch.as_tensor(a, dtype=torch.float32,  # noqa: E731
                                     device=device)
    return as_t(f_l), as_t(f_e), as_t(w), as_t(profile.result_bits)


def _device_of(dev) -> torch.device:
    return dev["c_dev"].device


def _num_users(dev) -> int:
    return dev["c_dev"].shape[0]


def _default_B(edge):
    """Latency-greedy baselines grab the full bandwidth: they optimize
    nothing and are cost-oblivious."""
    return edge["B_max"]


def _r_base(edge, f_e, f_total, cap=None):
    r = edge["r_min"] + (edge["r_max"] - edge["r_min"]) * f_e / f_total
    if cap is not None:
        r = torch.minimum(r, cap)
    return torch.clamp(r, edge["r_min"], edge["r_max"])


def _per_user(edge, X: int) -> dict:
    """Edge leaves broadcast to (X,) (shared 0-d leaves repeat)."""
    return {k: v.expand(X) for k, v in edge.items()}


def eval_split(profile: LayerProfile, dev, edge, s: int, B, r
               ) -> BaselineResult:
    """Every user at the same split ``s`` with allocation (B, r)."""
    f_l, f_e, w, m = _tables(profile, _device_of(dev))
    X = _num_users(dev)
    U, (T, E, C) = utility(dev, edge, f_l[s], f_e[s], w[s], m, B, r)
    split = torch.full((X,), int(s), dtype=torch.int32,
                       device=_device_of(dev))
    return BaselineResult(split=split, B=B, r=r, U=U, T=T, E=E, C=C)


def device_only(profile: LayerProfile, dev, edge) -> BaselineResult:
    edge = _per_user(edge, _num_users(dev))
    return eval_split(profile, dev, edge, profile.num_layers,
                      _default_B(edge), edge["r_min"])


def edge_only(profile: LayerProfile, dev, edge) -> BaselineResult:
    edge = _per_user(edge, _num_users(dev))
    return eval_split(profile, dev, edge, 0, _default_B(edge),
                      edge["r_max"])


def _min_latency_split(profile: LayerProfile, dev, edge, cap=None
                       ) -> BaselineResult:
    """Every split point of every user as one (X, M+1) block, then the
    first split of least T per user."""
    X = _num_users(dev)
    f_l, f_e, w, m = _tables(profile, _device_of(dev))
    f_total = f_l[-1]
    dev2 = {k: v.reshape(X, 1) for k, v in dev.items()}
    edge2 = {k: v.reshape(X, 1) for k, v in _per_user(edge, X).items()}
    cap2 = None if cap is None else cap.expand(X).reshape(X, 1)
    B = _default_B(edge2)
    r_all = _r_base(edge2, f_e, f_total, cap2)                # (X, M+1)
    U_all, (T_all, E_all, C_all) = utility(dev2, edge2, f_l, f_e, w, m,
                                           B, r_all)
    best = torch.argmin(T_all, dim=1)           # latency-only objective
    pick = lambda a: a.gather(1, best[:, None])[:, 0]  # noqa: E731
    return BaselineResult(split=best.to(torch.int32), B=B[:, 0],
                          r=pick(r_all), U=pick(U_all), T=pick(T_all),
                          E=pick(E_all), C=pick(C_all))


def neurosurgeon(profile: LayerProfile, dev, edge) -> BaselineResult:
    """Latency-optimal single split, no allocation optimization [29]."""
    return _min_latency_split(profile, dev, edge, cap=None)


def dnn_surgery(profile: LayerProfile, dev, edge,
                r_cap_frac: float = 0.5) -> BaselineResult:
    """DNN-Surgery/DADS [14]: latency-optimal split under an edge
    compute cap (resource-limited edge server)."""
    cap = edge["r_min"] + r_cap_frac * (edge["r_max"] - edge["r_min"])
    return _min_latency_split(profile, dev, edge, cap=cap)


BASELINES = {
    "device_only": device_only,
    "edge_only": edge_only,
    "neurosurgeon": neurosurgeon,
    "dnn_surgery": dnn_surgery,
}


def run_baseline_batch(name: str, profile: LayerProfile, devs, edge
                       ) -> BaselineResult:
    """A baseline over users (``devs`` leaves (X,); ``edge`` shared 0-d
    or (X,)).  PyTorch runs eagerly, so there is no compile cache to key
    (the reference's ``_CACHE`` of jitted vmaps)."""
    return BASELINES[name](profile, devs, edge)
