"""MCSA planner: ties the Li-GD/MLi-GD solvers to a network of users,
APs and heterogeneous edge servers (the paper's Fig. 1 system).

The port of the JAX package's ``repro/core/planner.py`` on its K=1,
uncapacitated, fault-free path:

  * static planning — per-user (s, B, r) via ONE batched Li-GD solve
    against each user's serving server (per-user edge rows gathered from
    a per-topology table);
  * incremental replanning — a step's handoffs go through the dirty set
    (:mod:`repro_torch.core.events`) and ONE batched MLi-GD solve over
    only the dirty rows, then the argmin-U reduction and a sparse scatter
    into :class:`FleetState`;
  * async replanning — the solve is launched on the current CUDA stream
    and left in flight (nothing on that path moves a result to the
    host), so the caller's next mobility step overlaps it; the result is
    applied up to ``async_horizon`` calls later or at :meth:`drain`;
  * strategy-calculation-time feedback — the observed iteration count
    feeds the CBR term T_Ag/k of the next solve (Eq. 6/7).

Plans live on the host (float64/int64 numpy columns, as in the
reference); solves run on ``device`` (the card unless the caller asks
for the CPU).  Results cross to the host in exactly two places,
:meth:`FleetState.from_static`/:meth:`FleetState.scatter` and
:meth:`MCSAPlanner._apply_one`, one copy per field.

Not ported yet, and raising ``NotImplementedError`` instead: admission
control (``candidates_k > 1`` or a capacitated topology), the fault path
(a faulted topology, ``StepEvents.faults``), the
``shard_map`` static path (``env``), and ``run_baseline`` — ROADMAP,
queue 1, items 2 and 4.
"""
from __future__ import annotations

import dataclasses
from types import SimpleNamespace
from typing import List, Optional

import numpy as np
import torch

from repro_torch._device import resolve_device
from .costs import (Devices, LayerProfile, apply_congestion, device_columns,
                    rent_cost, rows_to_device, stack_edges_np)
from .events import HANDOFF, DirtySet, EventOutcome, StepEvents
from .ledger import BudgetLedger
from .ligd import LiGDConfig, LiGDResult, solve_ligd_batch
from .mligd import MLiGDResult, solve_mligd_batch

ADMISSION_DEFERRED = ("admission control (candidates_k > 1 or a "
                      "capacitated topology) is not ported yet: ROADMAP, "
                      "queue 1, item 2")
FAULTS_DEFERRED = ("the fault path (faulted topology, StepEvents.faults) "
                   "is not ported yet: ROADMAP, queue 1, item 2")
SHARDED_DEFERRED = ("the sharded static plan (env / shard_map) is not "
                    "ported yet: ROADMAP, queue 1, item 4")
BASELINES_DEFERRED = ("baseline policies are not ported yet: ROADMAP, "
                      "queue 1, item 2")


def _host(a) -> np.ndarray:
    """A result field on the host: one device-to-host copy for a tensor."""
    return a.cpu().numpy() if torch.is_tensor(a) else np.asarray(a)


@dataclasses.dataclass
class FleetState:
    """Array-resident plan table: one (X,) numpy array per planned
    quantity, row x = user x's current strategy.

    Columns
    -------
    server : int64   — serving edge server id
    split  : int64   — split point s* ∈ [0, M]; s = M means device-only
    B      : float64 — allocated uplink bandwidth at the serving AP (Hz)
    r      : float64 — rented edge compute units
    U      : float64 — utility ω_T·T + ω_E·E + ω_C·CBR_C at the optimum
    T      : float64 — end-to-end inference delay (s)
    E      : float64 — device energy per inference (J)
    C      : float64 — renting cost per round ($)
    R      : int64   — last MLi-GD mobility decision (0 = re-split at the
                       new server, 1 = relay back); 0 after a static plan
    """
    server: np.ndarray
    split: np.ndarray
    B: np.ndarray
    r: np.ndarray
    U: np.ndarray
    T: np.ndarray
    E: np.ndarray
    C: np.ndarray
    R: np.ndarray

    @classmethod
    def from_static(cls, servers: np.ndarray, res: LiGDResult
                    ) -> "FleetState":
        """The plan table of a static solve; copies each result field to
        the host (which also waits for the solve)."""
        return cls(server=np.asarray(servers, np.int64),
                   split=_host(res.split).astype(np.int64),
                   B=_host(res.B).astype(np.float64),
                   r=_host(res.r).astype(np.float64),
                   U=_host(res.U).astype(np.float64),
                   T=_host(res.T).astype(np.float64),
                   E=_host(res.E).astype(np.float64),
                   C=_host(res.C).astype(np.float64),
                   R=np.zeros(len(np.atleast_1d(servers)), np.int64))

    def __len__(self) -> int:
        return len(self.server)

    def __getitem__(self, i: int) -> "UserPlan":
        return UserPlan(**{name: getattr(self, name)[i].item()
                           for name in PLAN_FIELDS})

    def scatter(self, users: np.ndarray, server: np.ndarray, res,
                R=None) -> None:
        """Write one result batch into rows ``users``: ``server`` from
        the argument, every other column from the same-named field of
        ``res`` (host arrays or tensors; a tensor is copied to the host
        once), ``R`` from the override when given."""
        self.server[users] = np.asarray(server, np.int64)
        for name in PLAN_FIELDS:
            if name == "server":
                continue
            col = getattr(self, name)
            val = R if name == "R" and R is not None \
                else getattr(res, name)
            col[users] = _host(val).astype(col.dtype)

    def __iter__(self):
        for i in range(len(self)):
            yield self[i]


#: Plan-table column names, in declaration order (UserPlan is generated
#: from it).
PLAN_FIELDS = tuple(f.name for f in dataclasses.fields(FleetState))

UserPlan = dataclasses.make_dataclass(
    "UserPlan",
    [(name, object, dataclasses.field(default=0)) for name in PLAN_FIELDS])
UserPlan.__doc__ = ("Scalar view of one user's plan — one native int/float "
                    "per FleetState column (display only).")


@dataclasses.dataclass
class _PendingReplan:
    """A launched-but-unapplied MLi-GD solve (async replanning).  ``res``
    holds device tensors that may still be in flight; they are copied to
    the host when the replan is applied.  Up to
    ``MCSAPlanner.async_horizon`` of these are outstanding; they apply
    FIFO, so a later dispatch's rows win per user."""
    res: MLiGDResult
    users: np.ndarray            # (E,) fleet rows the decisions scatter to
    orig_servers: np.ndarray     # (E,) pre-solve servers (relay-back target)
    new_server: np.ndarray       # (E,) new server per row
    stayed: int = 0              # hysteresis holds counted at apply time


class MCSAPlanner:
    """MCSA control plane for one fleet (see the module docstring).

    Parameters
    ----------
    profile       : the model's per-layer LayerProfile
    topo          : Topology (uncapacitated, unfaulted in this port)
    cfg           : LiGDConfig — GD hyper-parameters
    per_iter_time : seconds per GD iteration, feeds the T_Ag CBR estimate
    candidates_k  : candidate-set size K; only 1 is ported
    async_replanning : default ``sync`` polarity of :meth:`on_events`
    async_horizon : how many launched-but-unapplied replans may be
                    outstanding at once
    hysteresis    : relative switch margin — a moved user keeps its plan
                    row when the re-split does not beat the relay-back
                    vertex by this fraction (0 = always the argmin)
    device        : where the solves run; None means ``cuda`` and raises
                    when CUDA is unavailable (no fallback)
    """

    def __init__(self, profile: LayerProfile, topo,
                 cfg: LiGDConfig = LiGDConfig(),
                 per_iter_time: float = 5e-5,
                 candidates_k: int = 1,
                 async_replanning: bool = False,
                 async_horizon: int = 1,
                 hysteresis: float = 0.0,
                 device=None):
        if int(candidates_k) > 1 or topo.capacitated:
            raise NotImplementedError(ADMISSION_DEFERRED)
        self.device = resolve_device(device)
        self.profile = profile
        self.topo = topo
        self.cfg = cfg
        self.per_iter_time = per_iter_time
        self.candidates_k = 1
        self.async_replanning = async_replanning
        self.async_horizon = max(1, int(async_horizon))
        self.hysteresis = float(hysteresis)
        self.t_ag_estimate = 0.0
        self.ledger = BudgetLedger(topo)
        self.dirty = DirtySet()
        self._inflight: List[_PendingReplan] = []
        # (Z, field) edge table — gathered per user by server id
        self._edge_table = stack_edges_np(topo.edges)
        # observed-load view of the same table: pointer-equal to
        # _edge_table until update_load() sees a non-identity snapshot
        self._edge_table_eff = self._edge_table
        self.load = None

    # ------------------------------------------------------------------
    def _check_topology(self) -> None:
        if self.topo.capacitated:
            raise NotImplementedError(ADMISSION_DEFERRED)
        if self.topo.faulted:
            raise NotImplementedError(FAULTS_DEFERRED)

    def _edges_for(self, servers: np.ndarray) -> dict:
        """Per-user edge dict gathered from the (congestion-adjusted)
        per-topology table, moved to the device in one copy."""
        servers = np.asarray(servers)
        return rows_to_device({k: v[servers] for k, v in
                               self._edge_table_eff.items()},
                              self.device, len(servers))

    def update_load(self, snapshot) -> None:
        """Price later solves against a congestion snapshot (an object
        with ``compute_mult`` / ``backhaul_mult`` (Z,) arrays); None or
        an identity snapshot restores the static table exactly."""
        self.load = snapshot
        if snapshot is None:
            self._edge_table_eff = self._edge_table
            return
        self._edge_table_eff = apply_congestion(
            self._edge_table, snapshot.compute_mult,
            snapshot.backhaul_mult)
        if self._edge_table_eff is self._edge_table:
            self.load = None

    def _device_rows(self, devices: Devices, idx, hops: np.ndarray) -> dict:
        """Device dict of fleet rows ``idx`` (None = all) with this
        solve's hop counts and T_Ag estimate, in one copy."""
        X = len(hops)
        cols = device_columns(devices, idx)
        cols["hops"] = np.asarray(hops, np.float64)
        cols["t_ag"] = np.full(X, self.t_ag_estimate)
        return rows_to_device(cols, self.device, X)

    # ------------------------------------------------------------------
    def plan(self, devices: Devices, user_aps: np.ndarray,
             env=None) -> FleetState:
        """The Policy entry point: plan every user, return the table."""
        return self.plan_static(devices, user_aps, env=env)[2]

    def plan_static(self, devices: Devices, user_aps: np.ndarray,
                    env=None, candidates_k: Optional[int] = None) -> tuple:
        """Plan every user in one batched Li-GD solve (K = 1).

        Returns ``(res, servers, fleet)``: the LiGDResult with (X,)
        tensors on the planner's device (per-layer fields (X, M+1)), the
        (X,) server ids, and the host :class:`FleetState`.  Any in-flight
        async replan is dropped (a fresh plan supersedes it) and the
        budget ledger is re-derived from the new table."""
        if env is not None:
            raise NotImplementedError(SHARDED_DEFERRED)
        if candidates_k is not None and int(candidates_k) > 1:
            raise NotImplementedError(ADMISSION_DEFERRED)
        self._check_topology()
        self._inflight.clear()
        user_aps = np.asarray(user_aps)
        servers = self.topo.ap_server[user_aps]
        hops = self.topo.hops[user_aps, servers]
        devs_s = self._device_rows(devices, None, hops)
        edges_s = self._edges_for(servers)
        res = solve_ligd_batch(self.profile, devs_s, edges_s, self.cfg)
        fleet = FleetState.from_static(servers, res)   # waits for the solve
        self._update_t_ag(res)
        self.ledger.reset_from_fleet(fleet, self.profile.num_layers)
        return res, servers, fleet

    def _update_t_ag(self, res: LiGDResult) -> None:
        # Eq. 6/7 feedback: observed per-user strategy time for future CBR.
        iters = float(np.mean(np.sum(_host(res.iters_per_layer), -1)))
        self.t_ag_estimate = iters * self.per_iter_time

    # ------------------------------------------------------------------
    def on_events(self, events, devices: Devices, fleet: FleetState,
                  user_aps: Optional[np.ndarray] = None,
                  sync: Optional[bool] = None) -> EventOutcome:
        """Replan everything one step dirtied, in one fused solve.

        ``events`` is a :class:`~repro_torch.core.events.StepEvents` (or
        a bare HandoffBatch).  Pipeline: apply in-flight replans down to
        the async horizon, enqueue the handoffs, flush the dirty set
        (last-wins per user), ONE MLi-GD solve over the dirty rows, the
        argmin-U reduction, then either the sparse scatter (sync) or a
        pending entry left in flight (async)."""
        if not isinstance(events, StepEvents):
            events = StepEvents.from_handoffs(events)
        if events.faults is not None:
            raise NotImplementedError(FAULTS_DEFERRED)
        self._check_topology()
        if sync is None:
            sync = not self.async_replanning
        t = float(events.t)
        # bring the table within the async horizon before freezing
        # originals (horizon 1 applies everything: one-step-stale)
        self._apply_inflight(fleet, keep=self.async_horizon - 1)
        self.dirty.enqueue_handoffs(events.handoffs)
        dirty = self.dirty.flush()
        n_hand = dirty.count(HANDOFF)

        if len(dirty) == 0:
            outcome = EventOutcome(t=t, result=None, dirty=dirty,
                                   relays=0, resplits=0, stays=0)
        else:
            sol = self._solve_dirty(dirty, devices, fleet)
            p = _PendingReplan(res=sol.res, users=dirty.user,
                               orig_servers=sol.orig_servers,
                               new_server=sol.new_server)
            self._inflight.append(p)
            if sync:
                res = self._apply_inflight(fleet, keep=0)
                relays = int(res.R.astype(bool).sum()) + p.stayed
                outcome = EventOutcome(
                    t=t, result=res, dirty=dirty, relays=relays,
                    resplits=n_hand - relays, stays=p.stayed)
            else:
                outcome = EventOutcome(t=t, result=p.res, dirty=dirty,
                                       in_flight=True)
        return outcome

    def on_handoffs(self, events, devices: Devices, fleet: FleetState,
                    sync: Optional[bool] = None) -> Optional[MLiGDResult]:
        """One MLi-GD solve over all of this step's handoff events — a
        thin consumer of :meth:`on_events`.  Returns the result (host
        arrays when applied, device tensors while in flight), or None
        when there were no events."""
        return self.on_events(events, devices, fleet, sync=sync).result

    def _solve_dirty(self, dirty, devices: Devices,
                     fleet: FleetState) -> SimpleNamespace:
        """ONE batched MLi-GD solve over the dirty rows, left in flight.

        Every input is gathered on the host and copied to the device
        BEFORE the launch; nothing after it reads a result on the host,
        so the solve overlaps whatever the caller does next.  The rows
        are not padded: the reference pads to a power of two only to
        bound XLA's compile cache, and the rows are independent, so the
        padding changes no result."""
        users = dirty.user
        n = len(users)
        new_server = np.asarray(dirty.new_server, np.int64)

        dev_b = self._device_rows(devices, users, dirty.hops_new)
        edges_new = self._edges_for(new_server)

        # Frozen original strategies, gathered straight from the table
        # (the batched equivalent of mligd.orig_strategy_dict).
        f_l_np, f_e_np, w_np = self.profile.prefix_tables()
        s = fleet.split[users]
        # device-only plans carry r = 0: their rent prices the true r,
        # but U₂'s f_e_o/(λ(r_o)·c_min) would hit 0/0 (f_e = 0 at s = M),
        # so λ sees a unit stand-in that the zero f_e multiplies away
        r_raw = fleet.r[users]
        orig_servers = fleet.server[users]
        o = rows_to_device({
            "f_l": f_l_np[s], "f_e": f_e_np[s], "w": w_np[s],
            "r": np.where(r_raw > 0, r_raw, 1.0), "r_true": r_raw,
            "B": fleet.B[users], "hops_back": dirty.hops_back,
        }, self.device, n)
        edges_orig = self._edges_for(orig_servers)
        origs = {
            "split": torch.from_numpy(s.astype(np.int32)).to(self.device),
            "f_l": o["f_l"], "f_e": o["f_e"], "w": o["w"], "r": o["r"],
            "B": o["B"],
            "rent": rent_cost(edges_orig, o["r_true"], o["B"]),
        }
        res = solve_mligd_batch(self.profile, dev_b, edges_new, origs,
                                o["hops_back"], self.cfg)
        return SimpleNamespace(res=res, new_server=new_server,
                               orig_servers=orig_servers)

    # ------------------------------------------------------------------
    @property
    def pending(self) -> bool:
        """True while an async replan is launched but not yet applied to
        the table — the Policy in-flight signal."""
        return len(self._inflight) > 0

    def drain(self, fleet: FleetState):
        """Apply ALL in-flight replans; returns the last applied result
        (host arrays), or None when nothing was pending."""
        return self._apply_inflight(fleet, keep=0)

    def engine_slots(self, r_per_slot: float, min_slots: int = 2,
                     max_slots: int = 512) -> np.ndarray:
        """(Z,) int — per-server serving slot counts from the ledger's
        admitted r usage (see ``BudgetLedger.slot_counts``)."""
        return self.ledger.slot_counts(r_per_slot, min_slots=min_slots,
                                       max_slots=max_slots)

    def _apply_inflight(self, fleet: FleetState, keep: int = 0):
        """Apply in-flight replans FIFO until at most ``keep`` remain."""
        res = None
        while len(self._inflight) > max(0, keep):
            res = self._apply_one(self._inflight.pop(0), fleet)
        return res

    def _apply_one(self, p: _PendingReplan, fleet: FleetState
                   ) -> MLiGDResult:
        """Copy one replan to the host (one copy per field, which waits
        for the solve) and scatter it; returns the host result."""
        res = MLiGDResult(*(_host(a) for a in p.res))
        users = p.users
        take_back = res.R.astype(bool)
        server = np.where(take_back, p.orig_servers, p.new_server)
        if self.hysteresis > 0.0:
            # keep the frozen plan row when the re-split doesn't beat the
            # stay/relay continuation by the margin
            stay = ~take_back & (res.U_back.astype(np.float64)
                                 <= res.U_recalc.astype(np.float64)
                                 * (1.0 + self.hysteresis))
            p.stayed = int(stay.sum())
            if stay.any():
                idx = np.nonzero(~stay)[0]
                fleet.scatter(users[idx], server[idx],
                              MLiGDResult(*(a[idx] for a in res)))
                return res
        fleet.scatter(users, server, res)
        return res

    # ------------------------------------------------------------------
    def run_baseline(self, name: str, devices: Devices,
                     user_aps: np.ndarray):
        raise NotImplementedError(BASELINES_DEFERRED)
