"""The one stepped lifecycle of the MCSA system.

``Session(scenario, policy, device=...)`` builds the world a
:class:`Scenario` declares (topology, layer profile, device fleet,
mobility model), plans it with the policy, and owns the per-step loop::

    mobility.step -> HandoffBatch -> policy.on_events -> FleetState

including the async-replanning drain semantics (``run`` drains at the
end; ``step`` never does).  The step order is the reference's
(``repro/api/session.py``): mobility step, replan, accounting.

This slice covers ``__init__``, ``step``, ``run``, ``drain`` and
``metrics`` for fault-free, serving-free worlds with K = 1 and no
budgets; a scenario with ``faults``, ``candidates_k > 1`` or budgets
raises (ROADMAP, queue 1, item 2).  The planner runs on ``device``:
None means the card, and a missing card raises.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Optional

import numpy as np

from repro_torch._device import resolve_device
from repro_torch.core.events import StepEvents
from repro_torch.core.mobility import HandoffBatch
from repro_torch.core.planner import ADMISSION_DEFERRED, FAULTS_DEFERRED

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
    """
    t: float
    events: HandoffBatch
    result: Optional[object]
    in_flight: bool = False


@dataclasses.dataclass
class SessionMetrics:
    """Struct-of-arrays per-step accounting, one row per executed step
    (fleet aggregates are read after the step's replan was applied —
    one step stale under async replanning).

    t / handoffs        : (S,) step start times / handoff counts
    resplits / relays   : (S,) applied MLi-GD decisions (-1 while the
                          solve is in flight)
    mean_T/mean_E/mean_C: (S,) fleet-mean delay (s) / device energy (J)
                          / renting cost ($/round)
    """
    t: np.ndarray
    handoffs: np.ndarray
    resplits: np.ndarray
    relays: np.ndarray
    mean_T: np.ndarray
    mean_E: np.ndarray
    mean_C: np.ndarray


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
    device   : where the planner solves; None means ``cuda`` and raises
               when CUDA is unavailable — pass ``"cpu"`` for the plain
               PyTorch path
    topo / profile / devices / mobility : optional prebuilt components
               overriding the scenario's builders

    Attributes: ``fleet`` (the live plan table), ``policy``, ``topo``,
    ``profile``, ``devices``, ``mobility``, ``device``, ``steps_taken``,
    ``total_handoffs``, ``timings`` ({"plan_s", "steps_s", "drain_s"}
    cumulative host wall-clock inside the component calls).
    """

    def __init__(self, scenario: Scenario, policy=None, *, device=None,
                 topo=None, profile=None, devices=None, mobility=None):
        if scenario.faults is not None:
            raise NotImplementedError(FAULTS_DEFERRED)
        if (scenario.candidates_k > 1 or scenario.r_capacity is not None
                or scenario.B_capacity is not None):
            raise NotImplementedError(ADMISSION_DEFERRED)
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
        # admission-aware detection: the reference's auto rule is on
        # exactly when admission control is active, which this slice
        # refuses, so only an explicit True turns it on
        self._admission_aware = bool(scenario.admission_aware_handoffs)

        self.steps_taken = 0
        self.total_handoffs = 0
        self.timings = {"plan_s": 0.0, "steps_s": 0.0, "drain_s": 0.0}
        self._log = {k: [] for k in ("t", "handoffs", "resplits", "relays",
                                     "mean_T", "mean_E", "mean_C")}

        t0 = time.perf_counter()
        aps = self.topo.nearest_ap(self.mobility.positions())
        self.fleet = self.policy.plan(self.devices, aps)
        self.timings["plan_s"] = time.perf_counter() - t0

    @property
    def t(self) -> float:
        """Simulation time at the start of the NEXT step (s)."""
        return self.steps_taken * self.scenario.dt

    # ------------------------------------------------------------------
    def step(self) -> StepReport:
        """One lifecycle step: advance mobility, replan the handoffs,
        record accounting.  Returns a :class:`StepReport`."""
        sc = self.scenario
        t = self.t
        on_events = getattr(self.policy, "on_events", None)

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
        if on_events is not None and len(batch):
            outcome = on_events(StepEvents(t=t, handoffs=batch),
                                self.devices, self.fleet,
                                user_aps=np.asarray(self.mobility.ap))
            result = outcome.result
        elif on_events is None and len(batch):
            result = self.policy.on_handoffs(batch, self.devices,
                                             self.fleet)
        # the Policy in-flight contract: a truthy `pending` means a
        # launched replan has not yet reached the fleet table
        in_flight = bool(getattr(self.policy, "pending", False))
        if in_flight:
            result = None             # forcing it would kill the overlap
        self.timings["steps_s"] += time.perf_counter() - t0

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
        return StepReport(t=t, events=batch, result=result,
                          in_flight=in_flight)

    def run(self, n: Optional[int] = None) -> SessionMetrics:
        """Step ``n`` times (default: the scenario's remaining schedule),
        drain any in-flight async replan, and return the metrics."""
        if n is None:
            n = max(0, self.scenario.steps - self.steps_taken)
        for _ in range(n):
            self.step()
        self.drain()
        return self.metrics()

    def drain(self):
        """Apply any in-flight async replan (no-op for synchronous
        policies).  Returns the applied solver result, if any."""
        t0 = time.perf_counter()
        res = self.policy.drain(self.fleet)
        self.timings["drain_s"] += time.perf_counter() - t0
        return res

    def metrics(self) -> SessionMetrics:
        """The per-step accounting so far (see :class:`SessionMetrics`)."""
        log = self._log
        return SessionMetrics(
            t=np.asarray(log["t"], np.float64),
            handoffs=np.asarray(log["handoffs"], np.int64),
            resplits=np.asarray(log["resplits"], np.int64),
            relays=np.asarray(log["relays"], np.int64),
            mean_T=np.asarray(log["mean_T"], np.float64),
            mean_E=np.asarray(log["mean_E"], np.float64),
            mean_C=np.asarray(log["mean_C"], np.float64))
