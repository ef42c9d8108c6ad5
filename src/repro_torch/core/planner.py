"""MCSA planner: ties the Li-GD/MLi-GD solvers to a network of users,
APs and heterogeneous edge servers (the paper's Fig. 1 system).

The port of the JAX package's ``repro/core/planner.py``:

  * static planning — per-user (s, B, r) via ONE batched Li-GD solve
    against each user's serving server (per-user edge rows gathered from
    a per-topology table);
  * admission control — with ``candidates_k > 1``, a capacitated or a
    faulted topology the static plan solves Li-GD once per (user,
    candidate) in the same one launch over X·K user-major rows, and the
    water-filling greedy of :mod:`repro_torch.core.admission` admits
    each user to its cheapest candidate under the per-server budgets
    (device-only when every candidate is full); the headroom lives in a
    :class:`~repro_torch.core.ledger.BudgetLedger`;
  * incremental replanning — a step's handoffs, fault evacuations and
    capacity drains go through the dirty set
    (:mod:`repro_torch.core.events`) and ONE batched MLi-GD solve over
    only the dirty rows (D·K rows with K > 1), then either the argmin-U
    reduction (uncapacitated pure-handoff steps) or the ledger-aware
    waterfill, and a sparse scatter into :class:`FleetState`;
  * faults — the preamble of a fault-bearing step decays the recovery
    hold, retries stale async rows, re-associates device-only users and
    enqueues EVACUATE / DRAIN rows; those steps always run synchronously;
  * async replanning — the solve is launched on the current CUDA stream
    and left in flight (nothing on that path moves a result to the
    host), so the caller's next mobility step overlaps it; the result is
    applied up to ``async_horizon`` calls later or at :meth:`drain`;
  * strategy-calculation-time feedback — the observed iteration count
    feeds the CBR term T_Ag/k of the next solve (Eq. 6/7).

Plans live on the host (float64/int64 numpy columns, as in the
reference); solves run on ``device`` (the card unless the caller asks
for the CPU).  Every input of a solve is on the device before its
launch; results cross to the host where the reference forces them: the
static plan, the admission of the dirty rows (:meth:`_admit_dirty`) and
the application of a pending replan (:meth:`_apply_one`).

The static plan shards users over a mesh (``env``, a
``runtime.meshenv.MeshEnv``): when the solve's rows divide the
data-parallel size, each batch rank solves its contiguous slice of the
X (or X·K) rows and the ranks gather the results, so every rank ends
with the whole ``LiGDResult`` (the reference's ``shard_map`` path;
independent solves, no cross-user reduction).
"""
from __future__ import annotations

import dataclasses
from types import SimpleNamespace
from typing import List, Optional

import numpy as np
import torch

from repro_torch._device import resolve_device
from .admission import AdmissionReport, admit_waterfill
from .baselines import run_baseline_batch
from .costs import (Devices, LayerProfile, apply_congestion, device_columns,
                    rent_cost, rows_to_device, stack_edges_np)
from .events import (DRAIN, HANDOFF, DirtyBatch, DirtySet, EventOutcome,
                     StepEvents)
from .faults import EvacuationReport, FaultBatch, clamp_hops
from .ledger import BudgetLedger
from .ligd import LiGDConfig, LiGDResult, solve_ligd_batch
from .mligd import MLiGDResult, solve_mligd_batch
from .mobility import HandoffBatch

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
    new_server: object           # (E,) new server (host array or tensor)
    batch: Optional[DirtyBatch] = None   # the triggering dirty batch —
                                 # kept so a fault can retry stale rows
    attempts: int = 0            # fault-retry count for this dispatch
    stayed: int = 0              # hysteresis holds counted at apply time


class MCSAPlanner:
    """MCSA control plane for one fleet (see the module docstring).

    Parameters
    ----------
    profile       : the model's per-layer LayerProfile
    topo          : Topology (optionally capacitated, optionally faulted)
    cfg           : LiGDConfig — GD hyper-parameters
    per_iter_time : seconds per GD iteration, feeds the T_Ag CBR estimate
    candidates_k  : candidate-set size K for admission control; 1 (the
                    default) is the paper's one-server-per-AP model
    async_replanning : default ``sync`` polarity of :meth:`on_events`
    async_horizon : how many launched-but-unapplied replans may be
                    outstanding at once
    hysteresis    : relative switch margin — a moved user keeps its plan
                    row when the re-split does not beat the relay-back
                    vertex by this fraction (0 = always the argmin)
    recovery_hold_steps : how many fault-preamble runs a just-recovered
                    server stays out of the evacuation targets
    max_replan_retries : cap on re-dispatching one stale async replan
                    against the updated topology before its rows fall
                    through to the evacuation/degradation path
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
                 recovery_hold_steps: int = 2,
                 max_replan_retries: int = 3,
                 device=None):
        self.device = resolve_device(device)
        self.profile = profile
        self.topo = topo
        self.cfg = cfg
        self.per_iter_time = per_iter_time
        self.candidates_k = max(1, int(candidates_k))
        self.async_replanning = async_replanning
        self.async_horizon = max(1, int(async_horizon))
        self.hysteresis = float(hysteresis)
        self.recovery_hold_steps = int(recovery_hold_steps)
        self.max_replan_retries = int(max_replan_retries)
        self.t_ag_estimate = 0.0
        self.last_admission: Optional[AdmissionReport] = None
        self.last_evacuation: Optional[EvacuationReport] = None
        self.last_outcome: Optional[EventOutcome] = None
        self.replan_retries = 0      # stale async rows retried, cumulative
        self.ledger = BudgetLedger(topo)   # per-server budget residuals
        self.dirty = DirtySet()            # this step's event queue
        self._inflight: List[_PendingReplan] = []
        self._hold = np.zeros(topo.num_servers, np.int64)  # hysteresis
        self._last_user_aps: Optional[np.ndarray] = None
        # (Z, field) edge table — gathered per user by server id
        self._edge_table = stack_edges_np(topo.edges)
        # observed-load view of the same table: pointer-equal to
        # _edge_table until update_load() sees a non-identity snapshot
        self._edge_table_eff = self._edge_table
        self.load = None

    # ------------------------------------------------------------------
    def _edges_for(self, servers: np.ndarray) -> dict:
        """Per-user edge dict gathered from the (congestion-adjusted)
        per-topology table, moved to the device in one copy."""
        servers = np.asarray(servers)
        return rows_to_device({k: v[servers] for k, v in
                               self._edge_table_eff.items()},
                              self.device, len(servers))

    def update_load(self, snapshot) -> None:
        """Price later solves against a congestion snapshot (an object
        with ``compute_mult`` / ``backhaul_mult`` (Z,) arrays), and
        shrink the waterfill residuals of :meth:`_admit_dirty` by the
        same multipliers; None or an identity snapshot restores the
        static table exactly."""
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
        """Plan every user in one batched Li-GD solve.

        Returns ``(res, servers, fleet)``: the LiGDResult with (X,)
        leaves (per-layer fields (X, M+1)) — tensors on the planner's
        device on the K = 1 path, host arrays of each user's admitted row
        on the candidate path — the (X,) admitted server ids, and the
        host :class:`FleetState`.

        With K = 1 on an uncapacitated, unfaulted topology this is the
        paper's one-server-per-AP plan.  Otherwise Li-GD is solved once
        per (user, candidate) in one launch over X·K rows and the
        water-filling greedy assigns servers under the per-server
        budgets; the outcome is kept in ``self.last_admission``.  Any
        in-flight async replan is dropped (a fresh plan supersedes it)
        and the budget ledger is re-derived from the new table.

        ``env``: an optional MeshEnv; when it has more than one batch
        rank and they divide the solve's rows, the rows are sharded
        across them (:meth:`_solve_static`)."""
        self._inflight.clear()
        K = self.candidates_k if candidates_k is None else max(
            1, int(candidates_k))
        K = min(K, self.topo.num_servers)
        user_aps = np.asarray(user_aps)
        self._last_user_aps = user_aps
        # a faulted topology always takes the candidate path: it masks
        # down/unreachable servers and owns the device-only degrade
        if K == 1 and not self.topo.capacitated and not self.topo.faulted:
            self.last_admission = None
            servers = self.topo.ap_server[user_aps]
            hops = self.topo.hops[user_aps, servers]
            devs_s = self._device_rows(devices, None, hops)
            edges_s = self._edges_for(servers)
            res = self._solve_static(devs_s, edges_s, env)
            fleet = FleetState.from_static(servers, res)  # waits for it
            self._update_t_ag(res)
            self.ledger.reset_from_fleet(fleet, self.profile.num_layers)
            return res, servers, fleet
        return self._plan_admission(devices, user_aps, K, env)

    def _solve_static(self, devs: dict, edges: dict, env) -> LiGDResult:
        """One Li-GD solve of every row; with ``env`` of ``dp > 1`` batch
        ranks dividing the X rows, each rank solves its contiguous X/dp
        rows and every rank gathers every rank's result (one broadcast
        from each)."""
        X = devs["c_dev"].shape[0]
        if env is None or not env.is_spmd or env.dp <= 1 or X % env.dp:
            return solve_ligd_batch(self.profile, devs, edges, self.cfg)
        axis = env.batch()
        part = solve_ligd_batch(
            self.profile, {k: env.local_slice(v, 0, axis)
                           for k, v in devs.items()},
            {k: env.local_slice(v, 0, axis) for k, v in edges.items()},
            self.cfg)
        return LiGDResult(*(env.all_gather(a, 0, axis) for a in part))

    def _update_t_ag(self, res: LiGDResult) -> None:
        # Eq. 6/7 feedback: observed per-user strategy time for future CBR.
        iters = float(np.mean(np.sum(_host(res.iters_per_layer), -1)))
        self.t_ag_estimate = iters * self.per_iter_time

    def _plan_admission(self, devices: Devices, user_aps: np.ndarray,
                        K: int, env=None) -> tuple:
        """Candidate-set static plan: one Li-GD solve per (user, candidate)
        row — user-major tiling, row x·K+k is user x's k-th candidate —
        then water-filling admission under the per-server budgets."""
        topo = self.topo
        X = len(user_aps)
        cand = topo.candidates(K)[user_aps]                     # (X, K)
        K = cand.shape[1]
        hops = topo.hops[user_aps[:, None], cand]               # (X, K)
        reachable = None
        if topo.faulted:
            # mask candidates that are down or unreachable: invalid
            # slots are filled with the row's first valid candidate (a
            # duplicate proposal is an admission no-op), rows with no
            # valid candidate are forced device-only after admission
            up = topo.server_available()
            valid = up[cand] & np.isfinite(np.asarray(hops, np.float64))
            reachable = valid.any(axis=1)
            rows_i = np.arange(X)
            first = np.argmax(valid, axis=1)
            cand = np.where(valid, cand, cand[rows_i, first][:, None])
            hops = np.where(valid, hops, hops[rows_i, first][:, None])
            hops = clamp_hops(hops)
        t_ag_used = self.t_ag_estimate
        dev_rows = self._device_rows(devices, np.repeat(np.arange(X), K),
                                     hops.reshape(-1))
        edge_rows = self._edges_for(cand.reshape(-1))
        res = self._solve_static(dev_rows, edge_rows, env)
        res = LiGDResult(*(_host(a) for a in res))    # waits for the solve
        self._update_t_ag(res)

        # a candidate whose solved optimum is device-only (s = M) rents
        # nothing — its demand on the server is zero, whatever (B, r)
        # values the GD iterate happened to stop at
        offl = res.split.reshape(X, K) < self.profile.num_layers
        report = admit_waterfill(
            cand, res.U.astype(np.float64).reshape(X, K),
            res.r.astype(np.float64).reshape(X, K) * offl,
            res.B.astype(np.float64).reshape(X, K) * offl,
            topo.num_servers, topo.r_capacity, topo.B_capacity)
        if reachable is not None and not reachable.all():
            # no up server in reach of these users' APs: force the
            # device-only fallback and keep the association off the
            # dead server (nearest up server, for later re-admission)
            report.rejected = report.rejected | ~reachable
            choice = report.choice.copy()
            choice[~reachable] = -1
            report.choice = choice
            srv = report.server.copy()
            srv[~reachable] = self._nearest_up(
                user_aps[~reachable], topo.server_available())
            report.server = srv
        self.last_admission = report

        # gather each user's admitted row out of the (X*K,) solve
        flat = np.arange(X) * K + np.where(report.rejected, 0, report.choice)
        res_sel = LiGDResult(*(a[flat] for a in res))
        res_sel = self._zero_device_only(res_sel)
        if report.rejected.any():
            res_sel = self._device_only_fallback(
                res_sel, devices, report.rejected, t_ag_used)
        fleet = FleetState.from_static(report.server, res_sel)
        self.ledger.reset_from_fleet(fleet, self.profile.num_layers)
        return res_sel, report.server, fleet

    def _zero_device_only(self, res_sel):
        """Device-only rows (s = M) hold no resources: zero their B and r
        (U/T/E/C are already offload-free at s = M)."""
        dev_only = res_sel.split >= self.profile.num_layers
        if not dev_only.any():
            return res_sel
        B = np.array(res_sel.B)
        r = np.array(res_sel.r)
        B[dev_only] = 0.0
        r[dev_only] = 0.0
        return res_sel._replace(B=B, r=r)

    def _device_only_plan(self, devices: Devices, idx: np.ndarray,
                          t_ag: float) -> tuple:
        """(T, E, U) of the device-only plan (s = M) for fleet rows
        ``idx`` — nothing offloaded: no bandwidth, no rent, no admission
        load.  The device columns are rounded to float32 first, as the
        reference's float32 gather rounds them, then priced in float64."""
        d = {k: v.astype(np.float32).astype(np.float64)
             for k, v in device_columns(devices, idx).items()}
        f_l_M = float(self.profile.prefix_tables()[0][-1])
        T = f_l_M / d["c_dev"] + t_ag / d["k_rounds"]
        E = d["xi"] * d["c_dev"] ** 2 * d["phi"] * f_l_M
        U = d["w_T"] * T + d["w_E"] * E
        return T, E, U

    def _device_only_fallback(self, res, devices: Devices,
                              rejected: np.ndarray, t_ag: float,
                              rows: Optional[np.ndarray] = None):
        """Overwrite rejected users' rows of a host result with the
        device-only plan (s = M).  ``rows`` maps result rows to fleet
        rows when ``res`` covers a subset; None means result row i is
        fleet row i.  Zeroes the relay decision R of an MLiGDResult."""
        idx = np.nonzero(rejected)[0]
        dev_idx = idx if rows is None else np.asarray(rows)[idx]
        T, E, U = self._device_only_plan(devices, dev_idx, t_ag)
        out = {f: np.array(getattr(res, f)) for f in res._fields}
        out["split"][idx] = self.profile.num_layers
        out["B"][idx] = 0.0
        out["r"][idx] = 0.0
        out["U"][idx] = U
        out["T"][idx] = T
        out["E"][idx] = E
        out["C"][idx] = 0.0
        if "R" in out:
            out["R"][idx] = 0
        return type(res)(**out)

    # ------------------------------------------------------------------
    # The incremental event pipeline: handoffs, fault evacuations and
    # capacity drains all flow through ONE dirty-set solve per step.
    # ------------------------------------------------------------------
    def on_events(self, events, devices: Devices, fleet: FleetState,
                  user_aps: Optional[np.ndarray] = None,
                  sync: Optional[bool] = None,
                  _attempts: int = 0) -> EventOutcome:
        """Replan everything one step dirtied, in one fused solve.

        ``events`` is a :class:`~repro_torch.core.events.StepEvents` (or
        a bare HandoffBatch).  Pipeline, the reference's: (1) the fault
        preamble when ``events.faults`` is not None, else the in-flight
        replans applied down to the async horizon; (2) the handoffs
        enqueued; (3) the dirty set flushed, last-wins per user; (4) ONE
        MLi-GD solve over the dirty rows; (5) the argmin-U reduction on
        uncapacitated pure-handoff steps, or the water-filling admission
        under the ledger's residuals when the topology is capacitated or
        fault rows are present; (6) the sparse scatter (sync) or a
        pending entry left in flight (async).  Fault-bearing calls always
        run synchronously — an evacuation must land within its step."""
        if not isinstance(events, StepEvents):
            events = StepEvents.from_handoffs(events)
        if sync is None:
            sync = not self.async_replanning
        t = float(events.t)
        pre = None
        if events.faults is not None:
            sync = True               # evacuations must land this step
            pre = self._fault_preamble(events.faults, devices, fleet,
                                       user_aps)
        else:
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
            use_admission = self.topo.capacitated or \
                bool((dirty.kind != HANDOFF).any())
            sol = self._solve_dirty(dirty, devices, fleet,
                                    reduce=not use_admission)
            if use_admission:
                result, relays, stays, admission = self._admit_dirty(
                    dirty, devices, fleet, sol)
                outcome = EventOutcome(
                    t=t, result=result, dirty=dirty, relays=relays,
                    resplits=n_hand - relays, stays=stays)
                if pre is not None:
                    pre.admission = admission
            else:
                p = _PendingReplan(res=sol.res, users=dirty.user,
                                   orig_servers=sol.orig_servers,
                                   new_server=sol.new_server,
                                   batch=dirty, attempts=_attempts)
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

        if pre is not None:
            outcome.evacuation = self._evacuation_report(pre, fleet, t)
        self.last_outcome = outcome
        return outcome

    def on_handoffs(self, events, devices: Devices, fleet: FleetState,
                    sync: Optional[bool] = None,
                    _attempts: int = 0) -> Optional[MLiGDResult]:
        """One MLi-GD solve over all of this step's handoff events — a
        thin consumer of :meth:`on_events`.  Returns the result (host
        arrays when applied, device tensors while in flight), or None
        when there were no events."""
        return self.on_events(events, devices, fleet, sync=sync,
                              _attempts=_attempts).result

    def _fault_preamble(self, batch: FaultBatch, devices: Devices,
                        fleet: FleetState,
                        user_aps: Optional[np.ndarray]) -> SimpleNamespace:
        """Fault bookkeeping + dirty-set producers (no solve here): hold
        decay, stale-pending retry, device-only re-association, EVACUATE
        rows for users offloading to down/unreachable servers, DRAIN
        rows for capacity-churn overflow."""
        topo = self.topo
        up = topo.server_available()
        t = float(getattr(batch, "t", 0.0))

        self._hold = np.maximum(self._hold - 1, 0)
        if len(batch.server_up):
            self._hold[np.asarray(batch.server_up, np.int64)] = \
                self.recovery_hold_steps

        retried = self._retry_stale_pending(devices, fleet, up)
        pre = SimpleNamespace(retried=retried, reassociated=0,
                              evac_idx=np.zeros(0, np.int64), drained=0,
                              admission=None)
        if user_aps is None:
            user_aps = self._last_user_aps
        if user_aps is None:          # never planned: nothing to evacuate
            return pre
        user_aps = np.asarray(user_aps)

        offl = fleet.split < self.profile.num_layers
        on_down = ~up[fleet.server]
        unreachable = offl & ~np.isfinite(np.asarray(
            topo.hops[user_aps, fleet.server], np.float64))
        affected = (on_down & offl) | unreachable
        assoc_only = on_down & ~offl

        if assoc_only.any() and up.any():
            fleet.server[assoc_only] = self._nearest_up(
                user_aps[assoc_only], up)
            pre.reassociated = int(assoc_only.sum())

        pre.evac_idx = np.nonzero(affected)[0]
        if len(pre.evac_idx):
            aps_e = user_aps[pre.evac_idx]
            tgt = self._nearest_up(aps_e, up) if up.any() \
                else fleet.server[pre.evac_idx]
            self.dirty.enqueue_evacuations(
                pre.evac_idx, fleet.server[pre.evac_idx], tgt, aps_e,
                clamp_hops(topo.hops[aps_e, tgt]).astype(np.int64), t=t)

        if topo.capacitated:
            pre.drained = self._enqueue_drains(fleet, user_aps, affected,
                                               up, t)
        return pre

    def _enqueue_drains(self, fleet: FleetState, user_aps: np.ndarray,
                        affected: np.ndarray, up: np.ndarray,
                        t: float) -> int:
        """Capacity churn: servers whose LIVE effective capacity dropped
        below their ledger usage shed their most expensive plans back
        into the dirty set (per server, users are ranked by utility and
        the cheapest prefix that still fits is kept)."""
        topo = self.topo
        over = self.ledger.overloaded() & up
        if not over.any():
            return 0
        M = self.profile.num_layers
        r_cap = None if topo.r_capacity is None \
            else np.asarray(topo.r_capacity, np.float64)
        B_cap = None if topo.B_capacity is None \
            else np.asarray(topo.B_capacity, np.float64)
        offl = fleet.split < M
        drop_rows = []
        for z in np.nonzero(over)[0]:
            rows = np.nonzero(offl & (fleet.server == z) & ~affected)[0]
            if len(rows) == 0:
                continue
            order = rows[np.argsort(fleet.U[rows], kind="stable")]
            keep = np.ones(len(order), bool)
            if r_cap is not None:
                keep &= np.cumsum(fleet.r[order]) <= r_cap[z] + 1e-9
            if B_cap is not None:
                keep &= np.cumsum(fleet.B[order]) <= B_cap[z] + 1e-9
            if not keep.all():
                drop_rows.append(order[~keep])
        if not drop_rows:
            return 0
        idx = np.concatenate(drop_rows)
        aps_d = np.asarray(user_aps)[idx]
        tgt = self._nearest_up(aps_d, up)
        self.dirty.enqueue_evacuations(
            idx, fleet.server[idx], tgt, aps_d,
            clamp_hops(self.topo.hops[aps_d, tgt]).astype(np.int64),
            t=t, kind=DRAIN)
        return len(idx)

    def _evacuation_report(self, pre: SimpleNamespace, fleet: FleetState,
                           t: float) -> EvacuationReport:
        """Post-scatter accounting over the evacuated rows: re-admitted
        to a live server = evacuated, device-only = degraded (the two
        partition ``users`` exactly)."""
        evac_idx = pre.evac_idx
        evacuated = degraded = 0
        if len(evac_idx):
            up = self.topo.server_available()
            offl = fleet.split[evac_idx] < self.profile.num_layers
            evacuated = int((offl & up[fleet.server[evac_idx]]).sum())
            degraded = len(evac_idx) - evacuated
        rep = EvacuationReport(t=t, users=evac_idx, evacuated=evacuated,
                               degraded=degraded,
                               reassociated=pre.reassociated,
                               retried=pre.retried, drained=pre.drained,
                               admission=pre.admission)
        self.last_evacuation = rep
        return rep

    def _solve_dirty(self, dirty: DirtyBatch, devices: Devices,
                     fleet: FleetState, reduce: bool) -> SimpleNamespace:
        """ONE batched MLi-GD solve over the dirty rows (all kinds), left
        in flight.  With ``candidates_k > 1`` each row is solved per
        candidate of its AP (D·K user-major rows); EVACUATE/DRAIN rows
        carry ``hops_back = HOP_UNREACHABLE`` so the relay-back vertex
        never wins, and their candidates exclude held (just-recovered)
        servers unless nothing else survives.

        Every input is gathered on the host and copied to the device
        BEFORE the launch; nothing after it reads a result on the host.
        ``reduce=True`` (the uncapacitated pure-handoff path) takes the
        argmin-U candidate on the device, with ``+inf`` on invalid
        columns, so that path stays in flight; ``reduce=False`` returns
        the full (D·K,) result for :meth:`_admit_dirty`.  The rows are
        not padded: the reference pads to a power of two only to bound
        XLA's compile cache, and the rows are independent."""
        n = len(dirty)
        users = dirty.user
        K = min(self.candidates_k, self.topo.num_servers)
        faulted = self.topo.faulted
        up = self.topo.server_available() if faulted else None
        evacish = dirty.kind != HANDOFF

        cand = None
        cand_invalid = None
        if K > 1:
            cand = self.topo.candidates(K)[dirty.new_ap]         # (n, K)
            hops_new = self.topo.hops[dirty.new_ap[:, None], cand]
            if faulted:
                # down/unreachable candidates stay in the solve but are
                # priced out of the selection
                cand_invalid = ~up[cand] | ~np.isfinite(
                    np.asarray(hops_new, np.float64))
                hops_new = clamp_hops(hops_new)
            if evacish.any() and (self._hold > 0).any():
                # recovery hysteresis: evacuees avoid just-recovered
                # servers unless one is their only surviving candidate
                held = self._hold > 0
                base = cand_invalid if cand_invalid is not None \
                    else np.zeros(cand.shape, bool)
                strict = base | held[cand]
                use_strict = evacish & (~strict).any(axis=1)
                if use_strict.any():
                    cand_invalid = np.where(use_strict[:, None],
                                            strict, base)
            rows = np.repeat(np.arange(n), K)
            new_server_rows = cand.reshape(-1)
            hops_new_rows = hops_new.reshape(-1)
        else:
            rows = np.arange(n)
            new_server_rows = dirty.new_server
            hops_new_rows = dirty.hops_new
            if faulted:
                # the nearest-coverage target may be down: retarget
                # those events to the nearest up server so a handoff can
                # never land on a dead one
                tgt = np.asarray(new_server_rows, np.int64).copy()
                dead = ~up[tgt]
                if dead.any() and up.any():
                    tgt[dead] = self._nearest_up(dirty.new_ap[dead], up)
                    new_server_rows = tgt
                hops_new_rows = clamp_hops(
                    self.topo.hops[dirty.new_ap, new_server_rows])

        dev_b = self._device_rows(devices, users[rows], hops_new_rows)
        edges_new = self._edges_for(new_server_rows)

        # Frozen original strategies, gathered straight from the table
        # (the batched equivalent of mligd.orig_strategy_dict).
        f_l_np, f_e_np, w_np = self.profile.prefix_tables()
        s = fleet.split[users][rows]
        # device-only plans carry r = 0: their rent prices the true r,
        # but U₂'s f_e_o/(λ(r_o)·c_min) would hit 0/0 (f_e = 0 at s = M),
        # so λ sees a unit stand-in that the zero f_e multiplies away
        r_raw = fleet.r[users][rows]
        orig_servers = fleet.server[users]
        hops_back = dirty.hops_back[rows]
        if faulted:
            # a relay-back to a dead original server prices as
            # unreachable, never as a wrapped/NaN path
            hops_back = clamp_hops(hops_back)
        o = rows_to_device({
            "f_l": f_l_np[s], "f_e": f_e_np[s], "w": w_np[s],
            "r": np.where(r_raw > 0, r_raw, 1.0), "r_true": r_raw,
            "B": fleet.B[users][rows], "hops_back": hops_back,
        }, self.device, len(rows))
        edges_orig = self._edges_for(orig_servers[rows])
        origs = {
            "split": torch.from_numpy(s.astype(np.int32)).to(self.device),
            "f_l": o["f_l"], "f_e": o["f_e"], "w": o["w"], "r": o["r"],
            "B": o["B"],
            "rent": rent_cost(edges_orig, o["r_true"], o["B"]),
        }
        cand_dev = inf_cols = None
        if reduce and K > 1:
            # the reduction's inputs cross before the launch too
            cand_dev = torch.from_numpy(np.ascontiguousarray(
                cand, np.int64)).to(self.device)
            if cand_invalid is not None and cand_invalid.any():
                inf_cols = torch.from_numpy(np.where(
                    cand_invalid, np.float32(np.inf),
                    np.float32(0.0))).to(self.device)
        res = solve_mligd_batch(self.profile, dev_b, edges_new, origs,
                                o["hops_back"], self.cfg)

        new_server = None
        if reduce:
            if K > 1:
                # argmin-U candidate per event, on the device (the first
                # of equal minima, as jnp.argmin)
                U_eff = res.U.reshape(n, K)
                if inf_cols is not None:
                    U_eff = U_eff + inf_cols
                best_k = torch.argmin(U_eff, dim=1)
                ar = torch.arange(n, device=self.device)
                res = MLiGDResult(*(a.reshape(n, K, *a.shape[1:])[ar, best_k]
                                    for a in res))
                new_server = cand_dev.gather(1, best_k[:, None])[:, 0]
            else:
                new_server = np.asarray(new_server_rows, np.int64)

        return SimpleNamespace(res=res, cand=cand,
                               cand_invalid=cand_invalid,
                               new_server_rows=new_server_rows,
                               new_server=new_server,
                               orig_servers=orig_servers)

    def _reprice_T_physical(self, res_sel, devices: Devices,
                            rows: np.ndarray, servers: np.ndarray,
                            hops: np.ndarray, t_ag: float):
        """Recompute the selected rows' per-round delay T against the
        PHYSICAL (uncongested) edge table — Eqs. (1)/(3)/(5)/(7) at the
        already-chosen (split, B, r, server), in float64 on the host.
        Only called while a load snapshot is active: the congested table
        steers which plan wins, but the scattered T stays a service-time
        estimate."""
        M = self.profile.num_layers
        f_l, f_e, w = self.profile.prefix_tables()
        split = np.asarray(res_sel.split, np.int64)
        offl = split < M
        et = self._edge_table
        z = np.asarray(servers, np.int64)
        dv = device_columns(devices, np.asarray(rows))
        c_dev = dv["c_dev"].astype(np.float32).astype(np.float64)
        k_rounds = dv["k_rounds"].astype(np.float32).astype(np.float64)
        B = np.maximum(np.asarray(res_sel.B, np.float64), 1.0)
        r = np.maximum(np.asarray(res_sel.r, np.float64), 1e-9)
        h = np.asarray(clamp_hops(np.asarray(hops, np.float64)))
        h = np.where(np.isfinite(h), h, 1.0)
        payload = w[split] + float(self.profile.result_bits)
        t_dev = f_l[split] / c_dev + float(t_ag) / k_rounds
        t_srv = f_e[split] / (np.power(r, et["lam_a"][z])
                              * et["c_min"][z])
        t_tx = payload / B + h * payload / et["B_backhaul"][z]
        T = t_dev + np.where(offl, t_srv + t_tx, 0.0)
        return res_sel._replace(T=T)

    def _admit_dirty(self, dirty: DirtyBatch, devices: Devices,
                     fleet: FleetState, sol: SimpleNamespace) -> tuple:
        """Ledger-aware admission over the dirty solve: release what the
        replanned rows held, water-fill the per-(row, candidate) plans
        under the residual budgets (relay-back columns re-admit to the
        original server), degrade rejected rows to device-only, scatter,
        and charge the new holdings back to the ledger.  Returns
        ``(result, relays, stays, AdmissionReport-or-None)``."""
        topo = self.topo
        M = self.profile.num_layers
        n = len(dirty)
        users = dirty.user
        up = topo.server_available()
        t_ag = self.t_ag_estimate
        res_np = MLiGDResult(*(_host(a) for a in sol.res))  # waits for it

        if sol.cand is not None:
            cand = sol.cand
        else:
            cand = np.asarray(sol.new_server_rows, np.int64).reshape(n, 1)
        Kc = cand.shape[1]
        invalid = sol.cand_invalid
        if invalid is None:
            invalid = np.zeros((n, Kc), bool)
            if topo.faulted or not up.all():
                invalid |= ~up[cand]
        old_server = np.asarray(fleet.server[users], np.int64)

        split_m = res_np.split.reshape(n, Kc)
        offl_m = split_m < M
        Uv = res_np.U.astype(np.float64).reshape(n, Kc)
        R_mat = res_np.R.astype(bool).reshape(n, Kc)
        r_dem = res_np.r.astype(np.float64).reshape(n, Kc) * offl_m
        B_dem = res_np.B.astype(np.float64).reshape(n, Kc) * offl_m

        handoff = np.asarray(dirty.kind == HANDOFF)
        # switch hysteresis: a handoff-row user keeps its current plan
        # row untouched unless the best re-split beats the stay/relay
        # continuation by the margin (EVACUATE/DRAIN rows always move)
        stay = np.zeros(n, bool)
        if self.hysteresis > 0.0 and handoff.any():
            u1b = np.where(invalid, np.inf, res_np.U_recalc.astype(
                np.float64).reshape(n, Kc)).min(1)
            u2b = np.where(invalid, np.inf, res_np.U_back.astype(
                np.float64).reshape(n, Kc)).min(1)
            stay = handoff & up[old_server] \
                & (u2b <= u1b * (1.0 + self.hysteresis))
        stays = int(stay.sum())
        sel = np.nonzero(~stay)[0]
        if len(sel) == 0:
            return None, stays, stays, None

        # the replanned rows' current holdings come off the ledger first
        # — the waterfill must see their headroom as free
        self.ledger.release_rows(fleet, users[sel], M)

        cand_s = cand[sel]
        invalid_s = invalid[sel]
        # a relay-back column re-admits to the ORIGINAL server with the
        # relay demands
        serv_s = np.where(R_mat[sel], old_server[sel][:, None], cand_s)
        U_s = Uv[sel].copy()
        r_s = r_dem[sel]
        B_s = B_dem[sel]
        has_valid = (~invalid_s).any(axis=1)
        if invalid_s.any():
            # invalid columns become +inf-priced duplicates of the row's
            # first valid column (a duplicate proposal is an admission
            # no-op); all-invalid rows bypass admission entirely
            ri = np.arange(len(sel))
            first = np.where(has_valid, np.argmax(~invalid_s, axis=1), 0)
            serv_s = np.where(invalid_s, serv_s[ri, first][:, None],
                              serv_s)
            r_s = np.where(invalid_s, r_s[ri, first][:, None], r_s)
            B_s = np.where(invalid_s, B_s[ri, first][:, None], B_s)
            U_s[invalid_s] = np.inf

        res_r = self.ledger.residual_r()
        res_B = self.ledger.residual_B()
        if self.load is not None:
            # observed residual capacity: a congested server's headroom
            # shrinks by the multiplier that slowed its pricing
            if res_r is not None:
                res_r = res_r / np.maximum(self.load.compute_mult, 1.0)
            if res_B is not None:
                res_B = res_B / np.maximum(self.load.backhaul_mult, 1.0)
        report = admit_waterfill(serv_s, U_s, r_s, B_s, topo.num_servers,
                                 res_r, res_B)
        if not has_valid.all():
            report.rejected = report.rejected | ~has_valid
            choice = report.choice.copy()
            choice[~has_valid] = -1
            report.choice = choice

        gflat = sel * Kc + np.where(report.rejected, 0,
                                    np.maximum(report.choice, 0))
        res_sel = self._zero_device_only(MLiGDResult(*(a[gflat]
                                                       for a in res_np)))
        if report.rejected.any():
            res_sel = self._device_only_fallback(
                res_sel, devices, report.rejected, t_ag, rows=users[sel])

        final_srv = np.asarray(report.server, np.int64).copy()
        if not has_valid.all():
            nv = ~has_valid
            # nothing reachable: keep the association useful — nearest
            # up server, or the frozen one during a full blackout
            final_srv[nv] = self._nearest_up(dirty.new_ap[sel][nv], up) \
                if up.any() else old_server[sel][nv]
        if self.load is not None:
            # the table's T column stays a service-time estimate
            res_sel = self._reprice_T_physical(
                res_sel, devices, users[sel], final_srv,
                self.topo.hops[dirty.new_ap[sel], final_srv], t_ag)
        fleet.scatter(users[sel], final_srv, res_sel)

        offl_new = np.asarray(res_sel.split) < M
        self.ledger.charge(final_srv[offl_new],
                           np.asarray(res_sel.r)[offl_new],
                           np.asarray(res_sel.B)[offl_new])

        hand_sel = handoff[sel]
        relays = stays + int(np.asarray(res_sel.R,
                                        np.int64)[hand_sel].sum())
        return res_sel, relays, stays, report

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
        for the solve) and scatter it; returns the host result.  On a
        faulted topology nothing lands on a dead server, and nobody is
        held on one."""
        res = MLiGDResult(*(_host(a) for a in p.res))
        users = p.users
        take_back = res.R.astype(bool)
        server = np.where(take_back, p.orig_servers, _host(p.new_server))
        scatter = np.ones(len(users), bool)
        if self.hysteresis > 0.0:
            # keep the frozen plan row when the re-split doesn't beat the
            # stay/relay continuation by the margin — but never hold a
            # user on a server that has since died
            stay = ~take_back & (res.U_back.astype(np.float64)
                                 <= res.U_recalc.astype(np.float64)
                                 * (1.0 + self.hysteresis))
            if self.topo.faulted:
                stay &= self.topo.server_available()[
                    np.asarray(p.orig_servers, np.int64)]
            p.stayed = int(stay.sum())
            scatter &= ~stay
        if self.topo.faulted:
            # never scatter onto a dead server: stale rows keep their
            # frozen plan and the next fault preamble evacuates them
            scatter &= self.topo.server_available()[server]
        if scatter.all():
            fleet.scatter(users, server, res)
            return res
        idx = np.nonzero(scatter)[0]
        if len(idx):
            fleet.scatter(users[idx], server[idx],
                          MLiGDResult(*(a[idx] for a in res)))
        return res

    # ------------------------------------------------------------------
    # Fault handling: evacuation replanning
    # ------------------------------------------------------------------
    def on_faults(self, batch: FaultBatch, devices: Devices,
                  fleet: FleetState,
                  user_aps: Optional[np.ndarray] = None
                  ) -> EvacuationReport:
        """Failure-aware evacuation replan for one applied FaultBatch —
        a consumer of the :meth:`on_events` pipeline (EVACUATE/DRAIN
        rows, no handoffs).  Call AFTER ``topo.apply_faults(batch)``.

        Every user offloading to a down or unreachable server is
        re-admitted to a surviving candidate under the ledger's residual
        headroom, or degraded to device-only (split = M) when none is
        reachable or admissible; device-only users merely associated
        with a dead server are re-associated to the nearest up one.
        Servers recovered this step stay out of the evacuation targets
        for ``recovery_hold_steps`` calls, and stale async rows are
        re-dispatched (at most ``max_replan_retries`` times).  Returns
        the :class:`EvacuationReport`, also kept as
        ``self.last_evacuation``."""
        t = float(getattr(batch, "t", 0.0))
        events = StepEvents(t=t, handoffs=HandoffBatch.empty(t),
                            faults=batch)
        outcome = self.on_events(events, devices, fleet,
                                 user_aps=user_aps, sync=True)
        return outcome.evacuation

    def _nearest_up(self, aps: np.ndarray, up: np.ndarray) -> np.ndarray:
        """Nearest up & reachable server per AP (live hop counts); falls
        back to the lowest-id up server when nothing is reachable from
        an AP (blackout: server 0, deterministically)."""
        h = np.asarray(self.topo.hops[np.asarray(aps)], np.float64).copy()
        h[:, ~up] = np.inf
        best = np.argmin(h, axis=1)
        bad = ~np.isfinite(h[np.arange(len(best)), best])
        if bad.any():
            best[bad] = int(np.argmax(up))
        return best

    def _retry_stale_pending(self, devices: Devices, fleet: FleetState,
                             up: np.ndarray) -> int:
        """Async-dispatch fault safety: split every in-flight replan into
        rows whose decided server survived (applied as usual) and rows
        decided onto a now-dead server (re-dispatched synchronously
        against the updated topology; ``max_replan_retries`` bounds the
        retries, after which rows fall through to evacuation).  Returns
        the number of retried rows."""
        if not self._inflight or up.all():
            return 0
        entries, self._inflight = self._inflight, []
        retried = 0
        for p in entries:
            final = np.where(_host(p.res.R).astype(bool), p.orig_servers,
                             _host(p.new_server)).astype(np.int64)
            stale = ~up[final]
            if not stale.any():
                self._inflight.append(p)  # applies at the next call/drain
                continue
            res_np = MLiGDResult(*(_host(a) for a in p.res))
            good = np.nonzero(~stale)[0]
            if len(good):
                fleet.scatter(p.users[good], final[good],
                              MLiGDResult(*(a[good] for a in res_np)))
            if p.batch is None or p.attempts >= self.max_replan_retries \
                    or not up.any():
                continue              # out of retries: evacuation owns them
            bad = np.nonzero(stale)[0]
            new_ap = p.batch.new_ap[bad]
            tgt = self._nearest_up(new_ap, up)
            old = np.asarray(fleet.server[p.users[bad]], np.int64)
            retry = HandoffBatch(
                t=p.batch.t, user=p.users[bad],
                old_server=old,
                new_server=np.asarray(tgt, np.int64),
                new_ap=np.asarray(new_ap, np.int64),
                hops_new=clamp_hops(
                    self.topo.hops[new_ap, tgt]).astype(np.int64),
                hops_back=clamp_hops(
                    self.topo.hops[new_ap, old]).astype(np.int64))
            self.replan_retries += len(bad)
            retried += len(bad)
            self.on_handoffs(retry, devices, fleet, sync=True,
                             _attempts=p.attempts + 1)
        return retried

    # ------------------------------------------------------------------
    def run_baseline(self, name: str, devices: Devices,
                     user_aps: np.ndarray):
        """One §6 baseline (:mod:`repro_torch.core.baselines`) for every
        user at its AP's serving server, on the planner's device."""
        user_aps = np.asarray(user_aps)
        servers = self.topo.ap_server[user_aps]
        cols = device_columns(devices)
        cols["hops"] = np.asarray(self.topo.hops[user_aps, servers],
                                  np.float64)
        devs_s = rows_to_device(cols, self.device, len(user_aps))
        return run_baseline_batch(name, self.profile, devs_s,
                                  self._edges_for(servers))
