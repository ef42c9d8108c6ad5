"""The pluggable planning surface: the :class:`Policy` protocol and the
policy registry.

The port of the JAX package's ``repro/api/policies.py``, with one policy
so far: :class:`repro_torch.core.planner.MCSAPlanner`, the paper's
Li-GD/MLi-GD control plane, which implements the protocol natively.  The
§6 comparison baselines wait for ROADMAP, queue 1, item 2:
their evaluator, ``core/baselines.py``, is not ported yet, and asking
for one by name raises.
"""
from __future__ import annotations

from typing import Protocol, runtime_checkable

import numpy as np

from repro_torch.core.costs import Devices, LayerProfile
from repro_torch.core.mobility import HandoffBatch
from repro_torch.core.network import Topology
from repro_torch.core.planner import BASELINES_DEFERRED, FleetState, \
    MCSAPlanner

#: names of the reference's baseline policies, refused until ported
DEFERRED_POLICIES = ("device_only", "edge_only", "greedy_nearest",
                     "dnn_surgery", "cloud")


@runtime_checkable
class Policy(Protocol):
    """What a Session needs from a planner.

    ``plan`` produces the fleet's plan table from scratch;
    ``on_handoffs`` updates it in place for one step's handoff batch
    (implementations may defer the scatter — async replanning — until
    the next call or an explicit ``drain``).  A policy that defers MUST
    expose a truthy ``pending`` while a replan is launched but unapplied;
    Session reads it so it neither forces the solve nor counts its
    decisions as landed.  An optional ``on_events`` entry point (the
    planner's event pipeline) is preferred by Session when present."""

    def plan(self, devices: Devices, user_aps: np.ndarray) -> FleetState:
        ...                                             # pragma: no cover

    def on_handoffs(self, events: HandoffBatch, devices: Devices,
                    fleet: FleetState):
        ...                                             # pragma: no cover

    def drain(self, fleet: FleetState):
        ...                                             # pragma: no cover


#: policy-name registry (classes, not instances: Session instantiates)
POLICIES = {
    "mcsa": MCSAPlanner,
}


def list_policies() -> tuple:
    return tuple(sorted(POLICIES))


def make_policy(spec, scenario, profile: LayerProfile, topo: Topology,
                device=None) -> Policy:
    """Resolve a policy spec into a live Policy.

    spec: None (→ the MCSA planner), a registry name, a policy class
    (MCSAPlanner subclasses receive the scenario's solver knobs and
    ``device``), or an already-built instance (returned as-is)."""
    if spec is None:
        spec = "mcsa"
    if isinstance(spec, str):
        if spec in DEFERRED_POLICIES:
            raise NotImplementedError(f"policy {spec!r}: "
                                      f"{BASELINES_DEFERRED}")
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
        return spec(profile, topo)
    if not isinstance(spec, Policy):
        raise TypeError(f"{type(spec).__name__} does not implement the "
                        "Policy protocol (plan / on_handoffs / drain)")
    return spec
