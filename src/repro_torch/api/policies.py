"""The pluggable planning surface: the :class:`Policy` protocol and the
policy registry.

The port of the JAX package's ``repro/api/policies.py``.  Implementations:

* :class:`repro_torch.core.planner.MCSAPlanner` — the paper's
  Li-GD/MLi-GD control plane (admission control, faults, async
  replanning); it implements the protocol natively and is the default.
* The §6 comparison baselines of :mod:`repro_torch.core.baselines` as
  fleet policies: :class:`DeviceOnlyPolicy`, :class:`EdgeOnlyPolicy`,
  :class:`GreedyNearestPolicy` (Neurosurgeon's latency-greedy split at
  the nearest server), :class:`DNNSurgeryPolicy` (the same under a
  resource-capped edge), and :class:`CloudPolicy` (full offload to one
  remote datacenter over a fixed WAN hop count).

The baselines optimize no (B, r) allocation; on handoffs they re-evaluate
only the moved users against their new serving server (Cloud's plan is
position-independent, so its ``on_handoffs`` is a no-op).  Every policy
that solves takes ``device`` (None means the card) and evaluates there.
"""
from __future__ import annotations

from typing import Protocol, runtime_checkable

import numpy as np

from repro_torch._device import resolve_device
from repro_torch.core.baselines import run_baseline_batch
from repro_torch.core.costs import (Devices, LayerProfile, device_columns,
                                    rows_to_device, stack_edges_np)
from repro_torch.core.mobility import HandoffBatch
from repro_torch.core.network import Topology
from repro_torch.core.planner import FleetState, MCSAPlanner


@runtime_checkable
class Policy(Protocol):
    """What a Session needs from a planner.

    ``plan`` produces the fleet's plan table from scratch;
    ``on_handoffs`` updates it in place for one step's handoff batch
    (implementations may defer the scatter — async replanning — until
    the next call or an explicit ``drain``).  A policy that defers MUST
    expose a truthy ``pending`` while a replan is launched but unapplied;
    Session reads it so it neither forces the solve nor counts its
    decisions as landed.

    Optional entry points (duck-typed): ``on_events`` (the planner's
    event pipeline: handoffs, faults and drains in one solve), which
    Session prefers when present, and ``on_faults`` (the legacy fault
    hook); a policy with neither gets synthesized evacuation handoffs
    from Session, so no policy can keep users on dead servers."""

    def plan(self, devices: Devices, user_aps: np.ndarray) -> FleetState:
        ...                                             # pragma: no cover

    def on_handoffs(self, events: HandoffBatch, devices: Devices,
                    fleet: FleetState):
        ...                                             # pragma: no cover

    def drain(self, fleet: FleetState):
        ...                                             # pragma: no cover


class BaselinePolicy:
    """Shared machinery for the stateless §6 baselines: plan every user
    against its serving server with one batched baseline evaluation, and
    re-evaluate only the moved rows on handoffs (no relay-back concept —
    baselines always follow coverage)."""

    #: key into ``repro_torch.core.baselines.BASELINES``
    baseline: str = "device_only"

    def __init__(self, profile: LayerProfile, topo: Topology, device=None):
        self.device = resolve_device(device)
        self.profile = profile
        self.topo = topo
        self._edge_table = stack_edges_np(topo.edges)

    # -- helpers -------------------------------------------------------
    def _edges_for(self, servers: np.ndarray) -> dict:
        servers = np.asarray(servers)
        return rows_to_device({k: v[servers] for k, v in
                               self._edge_table.items()},
                              self.device, len(servers))

    def _serving(self, user_aps: np.ndarray) -> tuple:
        """(servers, hops) for a batch of AP associations."""
        user_aps = np.asarray(user_aps)
        servers = self.topo.ap_server[user_aps]
        return servers, self.topo.hops[user_aps, servers]

    def _evaluate(self, devices: Devices, idx, servers: np.ndarray,
                  hops: np.ndarray):
        """The baseline for fleet rows ``idx`` (None = all) at
        ``servers`` over ``hops``, the device columns in one copy."""
        cols = device_columns(devices, idx)
        cols["hops"] = np.asarray(hops, np.float64)
        devs = rows_to_device(cols, self.device, len(servers))
        return run_baseline_batch(self.baseline, self.profile, devs,
                                  self._edges_for(servers))

    # -- Policy protocol -----------------------------------------------
    def plan(self, devices: Devices, user_aps: np.ndarray) -> FleetState:
        servers, hops = self._serving(user_aps)
        res = self._evaluate(devices, None, servers, hops)
        return FleetState.from_static(servers, res)

    def on_handoffs(self, events: HandoffBatch, devices: Devices,
                    fleet: FleetState):
        batch = HandoffBatch.from_events(events) \
            if not isinstance(events, HandoffBatch) else events
        if len(batch) == 0:
            return None
        users = batch.user
        servers, hops = batch.new_server, batch.hops_new
        res = self._evaluate(devices, users, servers, hops)
        fleet.scatter(users, servers, res, R=0)   # baselines never relay
        return res

    pending = False                           # baselines never defer

    def drain(self, fleet: FleetState):
        return None                           # baselines are synchronous


class DeviceOnlyPolicy(BaselinePolicy):
    """Everything on-device (s = M): no offload, no rent — the paper's
    Device-Only baseline as a fleet policy."""
    baseline = "device_only"


class EdgeOnlyPolicy(BaselinePolicy):
    """Everything offloaded (s = 0) to the nearest edge server at the
    full static allocation — the paper's Edge-Only baseline."""
    baseline = "edge_only"


class GreedyNearestPolicy(BaselinePolicy):
    """The greedy-nearest heuristic: latency-optimal single split at the
    NEAREST server (Neurosurgeon [29]'s objective), no (B, r)
    optimization, coverage-following handoffs."""
    baseline = "neurosurgeon"


class DNNSurgeryPolicy(BaselinePolicy):
    """DNN-Surgery/DADS [14]: the greedy-nearest split under a capped
    rentable edge allocation (resource-limited edge server)."""
    baseline = "dnn_surgery"


class CloudPolicy(BaselinePolicy):
    """Full offload to ONE remote datacenter: every user ships its input
    to the same (best-provisioned) server over ``wan_hops`` backhaul
    hops, wherever it roams.  The plan is position-independent, so
    ``on_handoffs`` is a no-op: the fleet table (including the serving
    column, pinned to the cloud server) never changes after ``plan``."""
    baseline = "edge_only"

    def __init__(self, profile: LayerProfile, topo: Topology,
                 wan_hops: int = 8, device=None):
        super().__init__(profile, topo, device=device)
        self.wan_hops = int(wan_hops)
        # "the cloud" = the beefiest deployment in the region
        self.cloud_server = int(np.argmax(
            [e.c_min * e.r_max for e in topo.edges]))

    def _serving(self, user_aps: np.ndarray) -> tuple:
        X = len(np.asarray(user_aps))
        return (np.full(X, self.cloud_server, np.int64),
                np.full(X, self.wan_hops, np.int64))

    def on_handoffs(self, events: HandoffBatch, devices: Devices,
                    fleet: FleetState):
        return None                 # plan is position-independent

    def on_faults(self, batch, devices: Devices, fleet: FleetState,
                  user_aps=None):
        """Position-independent is not failure-independent: when the
        datacenter goes down (or becomes unreachable) the whole fleet
        fails over to the best-provisioned surviving server."""
        up = self.topo.server_available()
        if up[self.cloud_server] or not up.any():
            return None
        score = np.array([e.c_min * e.r_max for e in self.topo.edges],
                         np.float64)
        score[~up] = -np.inf
        self.cloud_server = int(np.argmax(score))
        X = len(fleet.server)
        servers, hops = self._serving(np.zeros(X, np.int64))
        res = self._evaluate(devices, None, servers, hops)
        fleet.scatter(np.arange(X), servers, res, R=0)
        return None


#: policy-name registry (classes, not instances: Session instantiates)
POLICIES = {
    "mcsa": MCSAPlanner,
    "device_only": DeviceOnlyPolicy,
    "edge_only": EdgeOnlyPolicy,
    "greedy_nearest": GreedyNearestPolicy,
    "dnn_surgery": DNNSurgeryPolicy,
    "cloud": CloudPolicy,
}


def list_policies() -> tuple:
    return tuple(sorted(POLICIES))


def make_policy(spec, scenario, profile: LayerProfile, topo: Topology,
                device=None) -> Policy:
    """Resolve a policy spec into a live Policy.

    spec: None (→ the MCSA planner), a registry name, a policy class
    (MCSAPlanner subclasses receive the scenario's solver and admission
    knobs, and every planner or baseline class receives ``device``), or
    an already-built instance (returned as-is)."""
    if spec is None:
        spec = "mcsa"
    if isinstance(spec, str):
        try:
            spec = POLICIES[spec]
        except KeyError:
            raise KeyError(f"unknown policy {spec!r}; available: "
                           f"{list_policies()}") from None
    if isinstance(spec, type):
        if issubclass(spec, MCSAPlanner):
            return spec(profile, topo, scenario.ligd,
                        candidates_k=scenario.candidates_k,
                        async_replanning=scenario.async_replanning,
                        async_horizon=scenario.async_horizon,
                        hysteresis=scenario.hysteresis, device=device)
        if issubclass(spec, BaselinePolicy):
            return spec(profile, topo, device=device)
        return spec(profile, topo)
    if not isinstance(spec, Policy):
        raise TypeError(f"{type(spec).__name__} does not implement the "
                        "Policy protocol (plan / on_handoffs / drain)")
    return spec
