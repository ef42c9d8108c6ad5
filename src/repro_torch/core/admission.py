"""Multi-server admission control: water-filling greedy over candidate sets.

The paper's MCSA planner pins every user to the one server behind its AP.
Under per-server budgets (``Topology.r_capacity`` / ``B_capacity``) that
assignment can oversubscribe a popular server, so the planner instead
solves Li-GD once per (user, candidate) pair — candidates come from
``Topology.candidates(K)`` — and this module admits each user to its
cheapest candidate that still has room.  The service-placement view
follows Lin et al. (arXiv:2011.05708); the communication/computation
trade-off that makes the K>1 choice non-trivial is the one analyzed by
Shao & Zhang (arXiv:2006.02166).

Algorithm (``admit_waterfill``) — deterministic, vectorized numpy:

  round 0..K-1:
    every unadmitted user proposes its best not-yet-tried candidate
    (columns pre-sorted by solved utility U, ties toward the nearer
    candidate);
    per server, proposals are ranked by (U, user id) and the cheapest
    PREFIX whose cumulative (r, B) demand fits the remaining budget is
    admitted — the water level;
    everyone past the water level spills to their next candidate.
  users still unadmitted after K rounds fall back to device-only
  execution (split s = M: no offload, no rent, no bandwidth).

Both the proposal order and the per-server ranking are total orders
(np.lexsort with user id as the final key), so the assignment is a pure
function of (candidates, U, demands, budgets) — replanning the same fleet
twice yields the identical assignment.

The port's copy of the JAX package's ``repro/core/admission.py``: plain
numpy, the same sorts in the same order, so the same inputs give the
same assignment bit for bit.  Admission turns on from the front door via
``repro_torch.api.Scenario`` (``candidates_k`` / ``r_capacity`` /
``B_capacity`` fields — e.g. the ``capacitated_k3`` preset).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np


@dataclasses.dataclass
class AdmissionReport:
    """Outcome of one admission round over X users and Z servers.

    candidates : (X, K) int   — per-user candidate server ids, nearest-first
                                (``Topology.candidates(K)`` gathered at the
                                user's AP)
    U          : (X, K) float — solved Li-GD utility of serving user x from
                                candidate column k
    choice     : (X,) int     — admitted candidate COLUMN per user
                                (-1 = rejected everywhere → device-only)
    server     : (X,) int     — admitted server id; rejected users keep
                                their nearest candidate as the association
                                (they run device-only and consume nothing)
    rejected   : (X,) bool    — spilled off every candidate
    spills     : (X,) int     — saturated candidates skipped before
                                admission (0 = first choice; K = rejected)
    r_load     : (Z,) float   — admitted compute-unit demand per server
    B_load     : (Z,) float   — admitted bandwidth demand per server (Hz)
    users_per_server : (Z,) int
    """
    candidates: np.ndarray
    U: np.ndarray
    choice: np.ndarray
    server: np.ndarray
    rejected: np.ndarray
    spills: np.ndarray
    r_load: np.ndarray
    B_load: np.ndarray
    users_per_server: np.ndarray


def _segmented_running_sum(seg_start: np.ndarray, values: np.ndarray
                           ) -> np.ndarray:
    """Inclusive running sum of ``values`` restarting at each True in
    ``seg_start`` (first element must be a segment start)."""
    c = np.cumsum(values)
    base = (c - values)[seg_start]                # cumsum before each segment
    seg_id = np.cumsum(seg_start) - 1
    return c - base[seg_id]


def admit_waterfill(candidates: np.ndarray, U: np.ndarray,
                    r_demand: np.ndarray, B_demand: np.ndarray,
                    num_servers: int,
                    r_capacity: Optional[np.ndarray] = None,
                    B_capacity: Optional[np.ndarray] = None
                    ) -> AdmissionReport:
    """Admit X users to Z capacitated servers from per-user candidate sets.

    candidates/U/r_demand/B_demand: (X, K) arrays — candidate server ids
    and the PER-CANDIDATE solved utility / resource demands (one Li-GD
    solve per pair).  ``r_capacity`` / ``B_capacity``: (Z,) budgets or
    None for uncapacitated (every user gets its argmin-U candidate).
    Returns an :class:`AdmissionReport`; no admitted load ever exceeds a
    budget.
    """
    cand = np.asarray(candidates, np.int64)
    U = np.asarray(U, np.float64)
    r_dem = np.asarray(r_demand, np.float64)
    B_dem = np.asarray(B_demand, np.float64)
    X, K = cand.shape
    Z = int(num_servers)
    rem_r = (np.full(Z, np.inf) if r_capacity is None
             else np.asarray(r_capacity, np.float64).copy())
    rem_B = (np.full(Z, np.inf) if B_capacity is None
             else np.asarray(B_capacity, np.float64).copy())

    # per-user preference: utility-ascending columns, ties toward the
    # nearer candidate (stable sort keeps the hop order of Topology.
    # candidates for equal U)
    pref = np.argsort(U, axis=1, kind="stable")

    choice = np.full(X, -1, np.int64)
    rank = np.zeros(X, np.int64)                  # next pref column to try
    for _ in range(K):
        active = np.nonzero((choice < 0) & (rank < K))[0]
        if active.size == 0:
            break
        k_sel = pref[active, rank[active]]
        srv = cand[active, k_sel]
        cost = U[active, k_sel]
        rd = r_dem[active, k_sel]
        Bd = B_dem[active, k_sel]
        # server-major, cheapest-first, user id as the deterministic final
        # tie-break
        order = np.lexsort((active, cost, srv))
        srv_o = srv[order]
        seg = np.empty(len(order), bool)
        seg[0] = True
        seg[1:] = srv_o[1:] != srv_o[:-1]
        run_r = _segmented_running_sum(seg, rd[order])
        run_B = _segmented_running_sum(seg, Bd[order])
        fits = (run_r <= rem_r[srv_o]) & (run_B <= rem_B[srv_o])
        acc = order[fits]
        choice[active[acc]] = k_sel[acc]
        np.subtract.at(rem_r, srv[acc], rd[acc])
        np.subtract.at(rem_B, srv[acc], Bd[acc])
        rank[active[order[~fits]]] += 1

    rejected = choice < 0
    col = np.where(rejected, 0, choice)           # rejected: keep nearest
    server = cand[np.arange(X), col]
    r_load = np.zeros(Z)
    B_load = np.zeros(Z)
    users = np.zeros(Z, np.int64)
    adm = np.nonzero(~rejected)[0]
    np.add.at(r_load, server[adm], r_dem[adm, choice[adm]])
    np.add.at(B_load, server[adm], B_dem[adm, choice[adm]])
    np.add.at(users, server[adm], 1)
    return AdmissionReport(candidates=cand, U=U, choice=choice,
                           server=server, rejected=rejected, spills=rank,
                           r_load=r_load, B_load=B_load,
                           users_per_server=users)
