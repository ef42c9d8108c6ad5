"""The one stepped lifecycle of the MCSA system.

``Session(scenario, policy, device=...)`` builds the world a
:class:`Scenario` declares (topology, layer profile, device fleet,
mobility model, fault process), plans it with the policy, and owns the
per-step loop::

    faults.step -> mobility.step -> policy.on_events -> FleetState

including the async-replanning drain semantics (``run`` drains at the
end; ``step`` never does) and admission-aware handoff detection (on
exactly when admission control is active, unless the scenario says
otherwise: the mobility model then keys on the admitted servers).  The
step order is the reference's (``repro/api/session.py``): the fault
process and its evacuation first, then mobility, the replan and the
accounting.

Policies with ``on_events`` (the planner) get a step's handoffs AND
faults in one :class:`~repro_torch.core.events.StepEvents`; the rest
get ``on_faults`` or synthesized evacuation handoffs, then
``on_handoffs``.

When the scenario carries a
:class:`~repro_torch.serving.dataplane.ServeConfig` (or a prebuilt
``dataplane=`` is passed), each step then drives the closed-loop data
plane over the replanned table (so mid-stream failover lands on the
planner's evacuation targets), and with ``feedback=True`` harvests its
telemetry through a :class:`~repro_torch.telemetry.LoadEstimator` into
``policy.update_load`` every ``feedback_interval`` steps.  The policy
and the data plane's engines run on ``device``: None means the card,
and a missing card raises.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Optional

import numpy as np

from repro_torch._device import resolve_device
from repro_torch.core.events import StepEvents
from repro_torch.core.faults import clamp_hops
from repro_torch.core.ledger import slots_from_usage
from repro_torch.core.mobility import HandoffBatch
from repro_torch.serving.dataplane import (ServingDataPlane,
                                          default_engine_factory)
from repro_torch.serving.failover import FailoverReport
from repro_torch.telemetry import LoadEstimator

from .policies import Policy, make_policy
from .scenario import Scenario


@dataclasses.dataclass
class StepReport:
    """What one :meth:`Session.step` did.

    t         : simulation time at the START of the step (s)
    events    : the step's handoff batch (possibly empty)
    result    : the applied solver result when the policy replanned
                synchronously; None when there were no events or the
                solve is still in flight (async)
    in_flight : True while a replan is launched but not yet applied
    faults    : the step's FaultBatch when fault injection is active and
                something changed this step (None otherwise)
    evacuation: the step's EvacuationReport when the policy ran an
                evacuation replan (None otherwise)
    serving   : the data plane's track sample for this step (active /
                queued / completed streams) when the session serves
                (None otherwise)
    """
    t: float
    events: HandoffBatch
    result: Optional[object]
    in_flight: bool = False
    faults: Optional[object] = None
    evacuation: Optional[object] = None
    serving: Optional[dict] = None


@dataclasses.dataclass
class SessionMetrics:
    """Struct-of-arrays per-step accounting, one row per executed step
    (fleet aggregates are read after the step's replan was applied —
    one step stale under async replanning).

    t / handoffs        : (S,) step start times / handoff counts
    resplits / relays   : (S,) applied MLi-GD decisions (-1 while the
                          solve is in flight, or for a policy that
                          reports no per-event decisions)
    mean_T/mean_E/mean_C: (S,) fleet-mean delay (s) / device energy (J)
                          / renting cost ($/round)
    admission           : admission summary dict (spilled / rejected
                          counts, per-server loads) or None when
                          admission control was inactive
    availability        : (S,) fraction of servers up at the END of each
                          step (None when fault injection is off)
    evacuated/degraded  : (S,) per-step evacuation counts — users
                          re-admitted to a survivor / degraded to
                          device-only (None when fault injection is off)
    faults              : summary dict (min availability, totals,
                          per-outage time-to-recover) or None when fault
                          injection is off; when serving-side failovers
                          happened (the data plane's, or reports folded
                          in by :meth:`Session.record_failover`) it
                          carries ``serving_failovers``, even with fault
                          injection off
    serving             : the data plane's end-of-run summary
                          (:meth:`ServingDataPlane.summary`) or None
                          when the session does not serve
    telemetry           : the feedback loop's trace (estimator updates,
                          per-update max multipliers, the last
                          LoadSnapshot) when the scenario serves with
                          ``feedback=True``, else None
    """
    t: np.ndarray
    handoffs: np.ndarray
    resplits: np.ndarray
    relays: np.ndarray
    mean_T: np.ndarray
    mean_E: np.ndarray
    mean_C: np.ndarray
    admission: Optional[dict] = None
    availability: Optional[np.ndarray] = None
    evacuated: Optional[np.ndarray] = None
    degraded: Optional[np.ndarray] = None
    faults: Optional[dict] = None
    serving: Optional[dict] = None
    telemetry: Optional[dict] = None


def _fleet_mean(fleet, field: str) -> float:
    col = getattr(fleet, field, None)
    if isinstance(col, np.ndarray):
        return float(col.mean())
    return float("nan")


class Session:
    """One scenario, one policy, one fleet — stepped to completion.

    Parameters
    ----------
    scenario : the declarative world (see :class:`Scenario`)
    policy   : None (the MCSA planner), a registry name, a Policy class,
               or a prebuilt instance
    device   : where the policy solves and the data plane's engines
               run; None means ``cuda`` and raises when CUDA is
               unavailable — pass ``"cpu"`` for the plain PyTorch path
    topo / profile / devices / mobility : optional prebuilt components
               overriding the scenario's builders
    dataplane : optional prebuilt ServingDataPlane overriding the one
               the scenario's ``serving`` config would build (None and
               no ServeConfig keep the session analytic)

    Attributes: ``fleet`` (the live plan table), ``policy``, ``topo``,
    ``profile``, ``devices``, ``mobility``, ``fault_model``, ``device``,
    ``admission``, ``dataplane``, ``estimator``, ``load_snapshot``,
    ``steps_taken``, ``total_handoffs``, ``timings`` ({"plan_s",
    "steps_s", "drain_s", "faults_s", "serve_s", "telemetry_s"}
    cumulative host wall-clock inside the component calls).
    """

    def __init__(self, scenario: Scenario, policy=None, *, device=None,
                 topo=None, profile=None, devices=None, mobility=None,
                 dataplane=None):
        self.device = resolve_device(device)
        self.scenario = scenario
        self.topo = topo if topo is not None else scenario.build_topology()
        self.profile = (profile if profile is not None
                        else scenario.build_profile())
        self.devices = (devices if devices is not None
                        else scenario.build_devices())
        self.mobility = (mobility if mobility is not None
                         else scenario.build_mobility(self.topo))
        self.policy: Policy = make_policy(policy, scenario, self.profile,
                                          self.topo, device=self.device)
        aware = scenario.admission_aware_handoffs
        if aware is None:   # auto: exactly when admission control is on
            aware = scenario.candidates_k > 1 or self.topo.capacitated
        self._admission_aware = bool(aware)

        self.fault_model = scenario.build_faults(self.topo)
        self._down_since: dict = {}      # server id -> sim time it died
        self._recovery_times: list = []  # seconds down, per closed outage
        self._fault_reassociated = 0     # cumulative, across evacuations
        self._fault_retried = 0          # stale async replans re-dispatched

        self.steps_taken = 0
        self.total_handoffs = 0
        self.timings = {"plan_s": 0.0, "steps_s": 0.0, "drain_s": 0.0,
                        "faults_s": 0.0, "serve_s": 0.0,
                        "telemetry_s": 0.0}
        self._failover_reports: list = []   # via record_failover()
        self._log = {k: [] for k in ("t", "handoffs", "resplits", "relays",
                                     "mean_T", "mean_E", "mean_C",
                                     "availability", "evacuated",
                                     "degraded")}

        t0 = time.perf_counter()
        aps = self.topo.nearest_ap(self.mobility.positions())
        self.fleet = self.policy.plan(self.devices, aps)
        self.timings["plan_s"] = time.perf_counter() - t0
        self.admission = self._admission_summary()

        # closed-loop serving data plane, its engines on this device
        self.dataplane = dataplane
        if self.dataplane is None and scenario.serving is not None:
            self.dataplane = ServingDataPlane(
                scenario.serving, self.topo,
                num_layers=self.profile.num_layers,
                slots=self._serving_slots(),
                slots_fn=self._serving_slots,
                engine_factory=default_engine_factory(scenario.serving,
                                                      self.device))

        # telemetry feedback: only a ServeConfig with feedback=True builds
        # the estimator, so feedback-off sessions never touch the
        # planner's pricing
        self.estimator = None
        self.load_snapshot = None
        self._telemetry_log = {"t": [], "compute_mult_max": [],
                               "backhaul_mult_max": []}
        sv = scenario.serving
        if self.dataplane is not None and sv is not None and sv.feedback:
            self.estimator = LoadEstimator(
                self.topo.num_servers, alpha=sv.feedback_alpha,
                max_mult=sv.feedback_max_mult)

    def _serving_slots(self) -> np.ndarray:
        """(Z,) engine slots per server from the admission r-budgets: the
        policy's BudgetLedger when it keeps one, else an audit of the
        live fleet table (both through
        :func:`repro_torch.core.ledger.slots_from_usage`)."""
        sv = self.scenario.serving
        ledger = getattr(self.policy, "ledger", None)
        if ledger is not None:
            return ledger.slot_counts(sv.r_per_slot,
                                      min_slots=sv.min_slots,
                                      max_slots=sv.max_slots)
        Z = self.topo.num_servers
        srv = np.asarray(self.fleet.server)
        offl = np.asarray(self.fleet.split) < self.profile.num_layers
        r_used = np.bincount(srv[offl],
                             weights=np.asarray(self.fleet.r)[offl],
                             minlength=Z)
        return slots_from_usage(r_used, sv.r_per_slot,
                                min_slots=sv.min_slots,
                                max_slots=sv.max_slots)

    # ------------------------------------------------------------------
    def _admission_summary(self) -> Optional[dict]:
        rep = getattr(self.policy, "last_admission", None)
        if rep is None:
            return None
        return {
            "users_per_server": rep.users_per_server.tolist(),
            "spilled": int(((rep.spills > 0) & ~rep.rejected).sum()),
            "rejected": int(rep.rejected.sum()),
            "r_load": rep.r_load.tolist(),
            "B_load": rep.B_load.tolist(),
        }

    def refresh_admission(self) -> Optional[dict]:
        """Recompute :attr:`admission` from the LIVE fleet table:
        ``users_per_server`` / ``r_load`` / ``B_load`` from the current
        plan rows (device-only rows hold nothing) plus a ``degraded``
        count; ``spilled`` / ``rejected`` keep their static-plan values
        (they describe the admission decision, not a live load).  Called
        by :meth:`drain` and the fault path; returns the refreshed dict
        (also stored)."""
        base = self._admission_summary()
        srv = getattr(self.fleet, "server", None)
        split = getattr(self.fleet, "split", None)
        if base is None or not isinstance(srv, np.ndarray) \
                or not isinstance(split, np.ndarray):
            self.admission = base if base is not None else self.admission
            return self.admission
        Z = self.topo.num_servers
        offl = split < self.profile.num_layers
        s = srv[offl]
        base["users_per_server"] = np.bincount(
            s, minlength=Z).tolist()
        base["r_load"] = np.bincount(
            s, weights=np.asarray(self.fleet.r)[offl],
            minlength=Z).tolist()
        base["B_load"] = np.bincount(
            s, weights=np.asarray(self.fleet.B)[offl],
            minlength=Z).tolist()
        base["degraded"] = int((~offl).sum())
        self.admission = base
        return base

    @property
    def t(self) -> float:
        """Simulation time at the start of the NEXT step (s)."""
        return self.steps_taken * self.scenario.dt

    # ------------------------------------------------------------------
    def step(self) -> StepReport:
        """One lifecycle step: advance the fault process (when chaos is
        on), advance mobility, replan, record accounting.  Returns a
        :class:`StepReport`."""
        sc = self.scenario
        t = self.t

        on_events = getattr(self.policy, "on_events", None)
        fault_batch = None
        evacuation = None
        if self.fault_model is not None:
            t0 = time.perf_counter()
            fault_batch = self.fault_model.step(sc.dt, t)
            if fault_batch:
                self.topo.apply_faults(fault_batch)
                if on_events is None:
                    # policies without the event pipeline evacuate
                    # BEFORE mobility, so detection never keys on a
                    # dead server
                    evacuation = self._dispatch_faults(fault_batch)
                self._track_recovery(fault_batch, t)
                # fault-driven coverage changes are not user movement:
                # resync the mobility model's nearest-server tracking
                self.mobility.server = np.asarray(
                    self.topo.ap_server[self.mobility.ap])
            else:
                fault_batch = None
            self.timings["faults_s"] += time.perf_counter() - t0

        admitted = None
        if self._admission_aware:
            # detection keys on the CURRENT admitted servers: apply any
            # in-flight replan first
            if getattr(self.policy, "pending", False):
                self.drain()
            admitted = getattr(self.fleet, "server", None)

        t0 = time.perf_counter()
        batch = self.mobility.step(sc.dt, t, admitted=admitted) \
            if admitted is not None else self.mobility.step(sc.dt, t)
        result = None
        outcome = None
        if on_events is not None and (len(batch) or
                                      fault_batch is not None):
            # this step's handoffs + faults in ONE dirty-set solve
            outcome = on_events(
                StepEvents(t=t, handoffs=batch, faults=fault_batch),
                self.devices, self.fleet,
                user_aps=np.asarray(self.mobility.ap))
            result = outcome.result
            evacuation = outcome.evacuation
        elif on_events is None and len(batch):
            result = self.policy.on_handoffs(batch, self.devices,
                                             self.fleet)
        # the Policy in-flight contract: a truthy `pending` means a
        # launched replan has not yet reached the fleet table
        in_flight = bool(getattr(self.policy, "pending", False))
        if in_flight:
            result = None             # forcing it would kill the overlap
        self.timings["steps_s"] += time.perf_counter() - t0
        if outcome is not None and not in_flight \
                and self.admission is not None \
                and (len(outcome.dirty) or evacuation is not None):
            # the synchronous pipeline already moved users between
            # servers (drain() would no-op, so it can't refresh for us)
            self.refresh_admission()

        serving = None
        if self.dataplane is not None:
            # after evacuation and replanning: fleet.server already names
            # the evacuation targets, so failover lands where the planner
            # chose
            t0 = time.perf_counter()
            serving = self.dataplane.step(sc.dt, t, fleet=self.fleet,
                                          faults=fault_batch)
            self.timings["serve_s"] += time.perf_counter() - t0

        if serving is not None and self.estimator is not None:
            # close the loop: this step's samples -> EWMA state -> the
            # planner, so NEXT step's replans and admission price against
            # observed load
            coll = getattr(self.dataplane, "collector", None)
            iv = sc.serving.feedback_interval
            if coll is not None and (self.steps_taken + 1) % iv == 0:
                t0 = time.perf_counter()
                snap = self.estimator.update(coll, t + sc.dt)
                self.load_snapshot = snap
                upd = getattr(self.policy, "update_load", None)
                if upd is not None:
                    upd(snap)
                tl = self._telemetry_log
                tl["t"].append(t + sc.dt)
                tl["compute_mult_max"].append(
                    float(snap.compute_mult.max()))
                tl["backhaul_mult_max"].append(
                    float(snap.backhaul_mult.max()))
                self.timings["telemetry_s"] += time.perf_counter() - t0

        self.steps_taken += 1
        self.total_handoffs += len(batch)
        log = self._log
        log["t"].append(t)
        log["handoffs"].append(len(batch))
        if outcome is not None and outcome.relays is not None:
            log["relays"].append(outcome.relays)
            log["resplits"].append(outcome.resplits)
        elif getattr(result, "R", None) is not None:
            relays = int(np.asarray(result.R).sum())
            log["relays"].append(relays)
            log["resplits"].append(len(batch) - relays)
        elif len(batch) == 0:
            log["relays"].append(0)
            log["resplits"].append(0)
        else:                         # in flight / decision-free policy
            log["relays"].append(-1)
            log["resplits"].append(-1)
        for f in ("T", "E", "C"):
            log[f"mean_{f}"].append(_fleet_mean(self.fleet, f))
        log["availability"].append(self.topo.availability)
        log["evacuated"].append(
            0 if evacuation is None else int(evacuation.evacuated))
        log["degraded"].append(
            0 if evacuation is None else int(evacuation.degraded))
        if evacuation is not None:
            self._fault_reassociated += int(evacuation.reassociated)
            self._fault_retried += int(evacuation.retried)
        return StepReport(t=t, events=batch, result=result,
                          in_flight=in_flight, faults=fault_batch,
                          evacuation=evacuation, serving=serving)

    def _dispatch_faults(self, batch):
        """Route one applied FaultBatch to a policy without
        ``on_events``.  Fault-aware policies (``on_faults``) run their
        own evacuation; for the rest the session synthesizes handoff
        events that move every user off a down server to its nearest up
        one, so no policy can keep users assigned to dead servers."""
        on_faults = getattr(self.policy, "on_faults", None)
        if on_faults is not None:
            rep = on_faults(batch, self.devices, self.fleet,
                            user_aps=np.asarray(self.mobility.ap))
            if self.admission is not None:
                self.refresh_admission()
            return rep
        up = self.topo.server_available()
        srv = getattr(self.fleet, "server", None)
        if not isinstance(srv, np.ndarray) or not up.any():
            return None
        idx = np.nonzero(~up[srv])[0]
        if len(idx) == 0:
            return None
        ap = np.asarray(self.mobility.ap)[idx]
        h = np.asarray(self.topo.hops[ap], np.float64).copy()
        h[:, ~up] = np.inf
        tgt = np.argmin(h, axis=1)
        blackout = ~np.isfinite(h[np.arange(len(tgt)), tgt])
        tgt[blackout] = int(np.argmax(up))
        hb = HandoffBatch(
            t=float(batch.t), user=idx,
            old_server=srv[idx].astype(np.int64),
            new_server=tgt.astype(np.int64),
            new_ap=ap.astype(np.int64),
            hops_new=clamp_hops(self.topo.hops[ap, tgt]).astype(np.int64),
            hops_back=clamp_hops(
                self.topo.hops[ap, srv[idx]]).astype(np.int64))
        self.policy.on_handoffs(hb, self.devices, self.fleet)
        return None

    def _track_recovery(self, batch, t: float) -> None:
        """Time-to-recover accounting: an outage opens at server_down
        and closes (one sample) at the matching server_up."""
        for z in np.asarray(batch.server_down, np.int64):
            self._down_since.setdefault(int(z), t)
        for z in np.asarray(batch.server_up, np.int64):
            t_down = self._down_since.pop(int(z), None)
            if t_down is not None:
                self._recovery_times.append(t - t_down)

    def run(self, n: Optional[int] = None) -> SessionMetrics:
        """Step ``n`` times (default: the scenario's remaining schedule),
        drain any in-flight async replan, and return the metrics."""
        if n is None:
            n = max(0, self.scenario.steps - self.steps_taken)
        for _ in range(n):
            self.step()
        self.drain()
        if self.dataplane is not None:
            t0 = time.perf_counter()
            self.dataplane.drain()   # the zero-lost audit raises here
            self.timings["serve_s"] += time.perf_counter() - t0
        return self.metrics()

    def record_failover(self, report) -> None:
        """Fold a caller-side
        :class:`~repro_torch.serving.failover.FailoverReport` (e.g. from
        ``SplitServer.generate_with_failover``) into this session's fault
        accounting: its events surface in
        ``metrics().faults["serving_failovers"]`` beside the data plane's
        own failovers."""
        self._failover_reports.append(report)

    def drain(self):
        """Apply any in-flight async replan (no-op for synchronous
        policies).  Returns the applied solver result, if any."""
        t0 = time.perf_counter()
        res = self.policy.drain(self.fleet)
        self.timings["drain_s"] += time.perf_counter() - t0
        if res is not None and self.admission is not None:
            # the applied replan moved users between servers: keep the
            # admission summary in sync with the live table
            self.refresh_admission()
        return res

    def metrics(self) -> SessionMetrics:
        """The per-step accounting so far (see :class:`SessionMetrics`)."""
        log = self._log
        chaos = self.fault_model is not None
        avail = np.asarray(log["availability"], np.float64)
        evac = np.asarray(log["evacuated"], np.int64)
        degr = np.asarray(log["degraded"], np.int64)
        faults = None
        if chaos:
            faults = {
                "availability_min": (float(avail.min())
                                     if len(avail) else 1.0),
                "evacuated_total": int(evac.sum()),
                "degraded_total": int(degr.sum()),
                "reassociated_total": self._fault_reassociated,
                "replans_retried_total": self._fault_retried,
                "recovery_times_s": [float(x)
                                     for x in self._recovery_times],
                "mean_time_to_recover_s": (
                    float(np.mean(self._recovery_times))
                    if self._recovery_times else 0.0),
                "still_down": sorted(self._down_since),
            }
        # serving-side failovers: the data plane's events plus the
        # reports of record_failover(); the entry (and, without chaos,
        # the faults dict) appears only when failovers happened
        fo_events = []
        if self.dataplane is not None:
            fo_events.extend(self.dataplane.events)
        for rep in self._failover_reports:
            fo_events.extend(rep.events)
        if fo_events:
            rep = FailoverReport(events=fo_events)
            if faults is None:
                faults = {}
            faults["serving_failovers"] = {
                "events": rep.retries,
                "relay_s": rep.relay_s,
                "tokens_preserved": rep.tokens_preserved,
                "by_mode": rep.by_mode,
                "relay_s_by_mode": rep.relay_s_by_mode,
            }
        telemetry = None
        if self.estimator is not None:
            tl = self._telemetry_log
            telemetry = {
                "updates": int(self.estimator.updates),
                "t": [float(x) for x in tl["t"]],
                "compute_mult_max": list(tl["compute_mult_max"]),
                "backhaul_mult_max": list(tl["backhaul_mult_max"]),
                "last": (self.load_snapshot.to_dict()
                         if self.load_snapshot is not None else None),
            }
        return SessionMetrics(
            t=np.asarray(log["t"], np.float64),
            handoffs=np.asarray(log["handoffs"], np.int64),
            resplits=np.asarray(log["resplits"], np.int64),
            relays=np.asarray(log["relays"], np.int64),
            mean_T=np.asarray(log["mean_T"], np.float64),
            mean_E=np.asarray(log["mean_E"], np.float64),
            mean_C=np.asarray(log["mean_C"], np.float64),
            admission=self.admission,
            availability=avail if chaos else None,
            evacuated=evac if chaos else None,
            degraded=degr if chaos else None,
            faults=faults,
            serving=(self.dataplane.summary()
                     if self.dataplane is not None else None),
            telemetry=telemetry)
