"""User mobility: random-waypoint traces + handoff detection, fully
array-resident.

The "model-mule" concept (paper §3): each mobile user carries the whole
model; on entering a new edge server's coverage the MLi-GD decision is
either re-split against the new server or relay back to the old one.

State is struct-of-arrays (positions, waypoints, speeds, AP/server
assignments as (X,) numpy arrays) and :meth:`RandomWaypointMobility.step`
advances ALL users with vectorized numpy — one step of a 100k-user fleet
is a handful of array ops, never a Python loop.  Handoffs come back as a
:class:`HandoffBatch` of parallel arrays; iterating a batch yields legacy
:class:`HandoffEvent` views for display/debug code.

Handoff detection TRIGGERS on nearest-server coverage changes
(``topo.ap_server``) — coverage is a radio property.  Which server an
event is emitted AGAINST is a resource property: pass the fleet's
admitted-server column as ``step(..., admitted=fleet.server)`` and each
event's ``old_server`` / ``hops_back`` reference the server the user was
actually ADMITTED to (the strategy MLi-GD prices the relay-back against),
and coverage changes INTO the admitted server's own coverage are
suppressed (arriving home is not a handoff).  Without ``admitted`` the
detector keys on nearest-server coverage alone — the paper's
one-server-per-AP model, where admitted == nearest.  ``repro_torch.api.Session``
passes the column automatically whenever admission control is active;
see docs/ARCHITECTURE.md for the step-by-step dataflow.

This module is internal plumbing: the supported front door is
``repro_torch.api`` (Scenario presets pick the mobility model by name and
Session owns the step loop).
"""
from __future__ import annotations

import dataclasses
from typing import Iterator, Optional, Sequence, Tuple

import numpy as np

from .faults import clamp_hops
from .network import Topology


@dataclasses.dataclass
class HandoffEvent:
    """Scalar view of one handoff (display/compat; the planner's solve
    path consumes HandoffBatch arrays directly).

    Fields
    ------
    user       : fleet row index of the user that moved (indexes
                 DeviceFleet / FleetState arrays)
    t          : simulation time of the step that detected the handoff (s)
    old_server : server the user was NEAREST to before the step (the
                 coverage it left, not necessarily the admitted server)
    new_server : nearest server after the step — MLi-GD's re-split target
    new_ap     : AP the user is now associated with
    hops_new   : backhaul hops new_ap -> new_server (H₁ of Eq. 18)
    hops_back  : backhaul hops new_ap -> the ORIGINAL server (H₂ of
                 Eq. 41 — the relay-back path length)
    """
    user: int
    t: float
    old_server: int
    new_server: int
    new_ap: int
    hops_new: int
    hops_back: int


@dataclasses.dataclass
class HandoffBatch:
    """All of one mobility step's edge-server handoffs as parallel (E,)
    arrays — the planner's native input.  Field semantics match
    :class:`HandoffEvent` one-to-one; ``user`` rows index the fleet
    arrays, and duplicate users only appear when batches from several
    steps are concatenated (see MCSAPlanner.on_handoffs for the
    last-event-wins contract)."""
    t: float
    user: np.ndarray             # (E,) int — fleet row per event
    old_server: np.ndarray       # (E,) int — pre-step nearest server
    new_server: np.ndarray       # (E,) int — post-step nearest server
    new_ap: np.ndarray           # (E,) int — post-step AP association
    hops_new: np.ndarray         # (E,) int — new_ap -> new_server hops
    hops_back: np.ndarray        # (E,) int — new_ap -> original server (H₂)

    def __len__(self) -> int:
        return len(self.user)

    def __bool__(self) -> bool:
        return len(self.user) > 0

    def __iter__(self) -> Iterator[HandoffEvent]:
        for i in range(len(self.user)):
            yield HandoffEvent(
                user=int(self.user[i]), t=self.t,
                old_server=int(self.old_server[i]),
                new_server=int(self.new_server[i]),
                new_ap=int(self.new_ap[i]),
                hops_new=int(self.hops_new[i]),
                hops_back=int(self.hops_back[i]))

    @classmethod
    def empty(cls, t: float = 0.0) -> "HandoffBatch":
        z = np.zeros(0, np.int64)
        return cls(t=t, user=z, old_server=z, new_server=z, new_ap=z,
                   hops_new=z, hops_back=z)

    @classmethod
    def from_events(cls, events: Sequence[HandoffEvent]) -> "HandoffBatch":
        if not events:
            return cls.empty()
        if isinstance(events, HandoffBatch):
            return events
        return cls(
            t=float(events[-1].t),
            user=np.asarray([e.user for e in events], np.int64),
            old_server=np.asarray([e.old_server for e in events], np.int64),
            new_server=np.asarray([e.new_server for e in events], np.int64),
            new_ap=np.asarray([e.new_ap for e in events], np.int64),
            hops_new=np.asarray([e.hops_new for e in events], np.int64),
            hops_back=np.asarray([e.hops_back for e in events], np.int64))

    @classmethod
    def concat(cls, batches: Sequence["HandoffBatch"]) -> "HandoffBatch":
        batches = [b for b in batches if len(b)]
        if not batches:
            return cls.empty()
        cat = lambda name: np.concatenate(
            [getattr(b, name) for b in batches])
        return cls(t=batches[-1].t, user=cat("user"),
                   old_server=cat("old_server"),
                   new_server=cat("new_server"), new_ap=cat("new_ap"),
                   hops_new=cat("hops_new"), hops_back=cat("hops_back"))


def _deploy_area(topo: Topology) -> np.ndarray:
    """The (2,) rectangle users are placed (and re-waypointed) over —
    the AP deployment's bounding box plus a 5% margin, shared by every
    mobility model so fleets built from one Scenario see one area."""
    return topo.ap_xy.max(0) * 1.05


class RandomWaypointMobility:
    """Classic random-waypoint over the topology area, vectorized.

    Public state (read-only from outside): ``xy`` (X, 2) positions,
    ``ap`` / ``server`` (X,) current assignments.
    """

    def __init__(self, topo: Topology, num_users: int, *,
                 speed_range: Tuple[float, float] = (1.0, 15.0),
                 seed: int = 0):
        self.topo = topo
        self.rng = np.random.default_rng(seed)
        self.speed_range = speed_range
        area = _deploy_area(topo)
        self.area = area
        self.xy = self.rng.uniform(0, 1, (num_users, 2)) * area
        self.waypoint = self.rng.uniform(0, 1, (num_users, 2)) * area
        self.speed = self.rng.uniform(*speed_range, num_users)
        self.ap = np.asarray(topo.nearest_ap(self.xy))
        self.server = np.asarray(topo.ap_server[self.ap])

    @property
    def num_users(self) -> int:
        return len(self.xy)

    def positions(self) -> np.ndarray:
        return self.xy

    def step(self, dt: float, t: float,
             admitted: Optional[np.ndarray] = None) -> HandoffBatch:
        """Advance all users by dt seconds; return the step's handoffs.

        ``admitted``: optional (X,) admitted-server column (e.g.
        ``FleetState.server``).  Detection still TRIGGERS on
        nearest-server coverage changes, but events are emitted AGAINST
        the admitted server: ``old_server`` / ``hops_back`` reference
        ``admitted[user]`` (what the frozen original strategy is priced
        against), and coverage changes into the admitted server's own
        coverage are suppressed.  ``None`` keeps the paper's
        nearest-server keying (admitted == nearest under K=1)."""
        to_wp = self.waypoint - self.xy
        dist = np.linalg.norm(to_wp, axis=-1)
        travel = self.speed * dt
        arrived = travel >= dist
        safe = np.maximum(dist, 1e-12)[:, None]
        self.xy = np.where(arrived[:, None], self.waypoint,
                           self.xy + to_wp / safe * travel[:, None])
        n_arr = int(arrived.sum())
        if n_arr:
            self.waypoint[arrived] = (
                self.rng.uniform(0, 1, (n_arr, 2)) * self.area)
            self.speed[arrived] = self.rng.uniform(*self.speed_range, n_arr)

        new_ap = np.asarray(self.topo.nearest_ap(self.xy))
        new_server = np.asarray(self.topo.ap_server[new_ap])
        moved = new_server != self.server
        if admitted is None:
            old = self.server
        else:
            old = np.asarray(admitted, np.int64)
            moved &= new_server != old          # arriving home: no handoff
        idx = np.nonzero(moved)[0]
        batch = HandoffBatch(
            t=t,
            user=idx,
            old_server=old[idx].astype(np.int64),
            new_server=new_server[idx].astype(np.int64),
            new_ap=new_ap[idx].astype(np.int64),
            # clamp_hops: under fault injection a hop count can be inf
            # (dead server / cut backhaul) — keep it a finite,
            # astronomically expensive path instead of an int64 wrap
            hops_new=clamp_hops(
                self.topo.hops[new_ap[idx], new_server[idx]]
            ).astype(np.int64),
            hops_back=clamp_hops(
                self.topo.hops[new_ap[idx], old[idx]]).astype(np.int64))
        self.ap = new_ap
        self.server = new_server                # nearest-coverage tracking
        return batch


class StaticMobility:
    """Users that never move: random initial placement, zero handoffs.

    The ``"static"`` mobility model of ``repro_torch.api.Scenario`` — same
    public surface as :class:`RandomWaypointMobility` (``xy``, ``ap``,
    ``server``, ``positions()``, ``step()``), with ``step`` always
    returning an empty :class:`HandoffBatch`.  Reproduces the paper's
    static Figs. 3–8 setting inside the same Session lifecycle.
    """

    def __init__(self, topo: Topology, num_users: int, *,
                 seed: int = 0, **_ignored):
        self.topo = topo
        rng = np.random.default_rng(seed)
        self.xy = rng.uniform(0, 1, (num_users, 2)) * _deploy_area(topo)
        self.ap = np.asarray(topo.nearest_ap(self.xy))
        self.server = np.asarray(topo.ap_server[self.ap])

    @property
    def num_users(self) -> int:
        return len(self.xy)

    def positions(self) -> np.ndarray:
        return self.xy

    def step(self, dt: float, t: float,
             admitted: Optional[np.ndarray] = None) -> HandoffBatch:
        return HandoffBatch.empty(t)
