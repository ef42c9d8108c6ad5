"""Deterministic fault injection for the MCSA control plane.

The paper's network model assumes edge servers never die; production
edge deployments do not.  This module is the chaos layer: a seeded
:class:`FaultModel` drives server crash/recover cycles (MTBF/MTTR),
backhaul fiber cuts, and capacity churn (scaled ``r_capacity`` /
``B_capacity``), emitting one array-resident :class:`FaultBatch` per
step — only *transitions*, never steady state, so a quiet step costs a
few rng draws and no planner work.  Scripted events ("server 2 dies at
t=30 s") ride the same batch via :class:`FaultConfig`'s declarative
``schedule``.

Dataflow (docs/ARCHITECTURE.md, "Failure handling", has the full
picture):

    FaultModel.step(dt, t) -> FaultBatch
        -> Topology.apply_faults(batch)        (availability + hop recompute)
        -> MCSAPlanner.on_faults(batch, ...)   (evacuation replan)
        -> EvacuationReport                    (accounting)

``repro_torch.api.Session`` owns that sequence whenever its Scenario carries a
:class:`FaultConfig` (``faults`` field; ``chaos_*`` presets) — faults are
applied at the top of each step, *before* handoff detection, so the
mobility layer never sees a user admitted to a server that no longer
exists.

Everything is plain numpy and JSON-round-trippable: a FaultConfig is a
frozen dataclass of scalars and tuples (``to_dict`` / ``from_dict``),
and a FaultModel's trajectory is a pure function of (config, step
sequence) — two sessions built from equal scenarios see the identical
fault history.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np

#: Finite stand-in for an infinite hop count (unreachable server).  Kept
#: well inside int64/float32 range so batch fields and solver inputs stay
#: finite; any utility priced over this many hops loses every argmin.
HOP_UNREACHABLE = float(2 ** 20)

#: Scripted-event kinds a FaultConfig.schedule may carry.  ``server_*``
#: events target a server id; ``link_*`` events target an index into
#: ``Topology.links()`` (the undirected fiber-link list of the unfaulted
#: graph).
SCHEDULE_KINDS = ("server_down", "server_up", "link_down", "link_up")


def clamp_hops(hops) -> np.ndarray:
    """Replace non-finite hop counts with :data:`HOP_UNREACHABLE`.

    ``Topology.hops`` uses ``inf`` for unreachable (down server / cut
    backhaul); consumers that cast to integers or feed float32 solvers
    clamp through here so unreachability stays a *finite, astronomically
    expensive* path instead of wrapping or NaN-ing."""
    h = np.asarray(hops, np.float64)
    return np.where(np.isfinite(h), h, HOP_UNREACHABLE)


@dataclasses.dataclass(frozen=True)
class FaultConfig:
    """Declarative fault process for one scenario (JSON-safe).

    Stochastic process (all exponential, per step of ``dt`` seconds):

    server_mtbf : mean time between failures per *up* server (s);
                  None disables stochastic server crashes
    server_mttr : mean time to repair per *down* server (s)
    link_mtbf   : mean time between cuts per *up* backhaul link (s);
                  None disables stochastic link cuts
    link_mttr   : mean time to splice per *cut* link (s)
    capacity_jitter : per-step lognormal-ish churn amplitude on the
                  topology's ``r_capacity`` / ``B_capacity`` budgets
                  (0 disables; scales are resampled fresh each step
                  around 1.0, clipped to [0.25, 1.75])
    seed        : rng seed — the whole fault trajectory is a pure
                  function of (config, step sequence)

    Scripted events:

    schedule    : tuple of ``(kind, t, target)`` with kind from
                  :data:`SCHEDULE_KINDS`; each fires exactly once, at
                  the first step whose start time is >= ``t``.
                  Scripted events override the stochastic draw for
                  their target that step.
    """
    server_mtbf: Optional[float] = None
    server_mttr: float = 120.0
    link_mtbf: Optional[float] = None
    link_mttr: float = 120.0
    capacity_jitter: float = 0.0
    seed: int = 0
    schedule: Tuple[Tuple[str, float, int], ...] = ()

    def __post_init__(self):
        for ev in self.schedule:
            kind = ev[0]
            if kind not in SCHEDULE_KINDS:
                raise ValueError(
                    f"unknown fault-schedule kind {kind!r}; expected one "
                    f"of {SCHEDULE_KINDS}")

    # -- serialization (mirrors Scenario.to_dict/from_dict) ------------
    def to_dict(self) -> dict:
        d = dataclasses.asdict(self)
        d["schedule"] = [list(ev) for ev in self.schedule]
        return d

    @classmethod
    def from_dict(cls, d: dict) -> "FaultConfig":
        d = dict(d)
        unknown = set(d) - {f.name for f in dataclasses.fields(cls)}
        if unknown:
            raise TypeError(
                f"unknown FaultConfig fields: {sorted(unknown)}")
        if "schedule" in d:
            d["schedule"] = tuple(
                (str(ev[0]), float(ev[1]), int(ev[2]))
                for ev in d["schedule"])
        return cls(**d)


@dataclasses.dataclass
class FaultBatch:
    """One step's fault *transitions* as parallel index arrays.

    t           : simulation time of the step that emitted the batch (s)
    server_down : (d,) server ids that crashed this step
    server_up   : (u,) server ids that recovered this step
    link_down   : (c,) indices into ``Topology.links()`` cut this step
    link_up     : (s,) link indices restored this step
    r_scale     : optional (Z,) multiplier on the base ``r_capacity``
                  (capacity churn; None = budgets unchanged this step)
    B_scale     : optional (Z,) multiplier on the base ``B_capacity``

    Truthiness means "something changed": an empty batch is falsy and
    the whole fault path (topology recompute, evacuation replan) is
    skipped for it.
    """
    t: float
    server_down: np.ndarray
    server_up: np.ndarray
    link_down: np.ndarray
    link_up: np.ndarray
    r_scale: Optional[np.ndarray] = None
    B_scale: Optional[np.ndarray] = None

    def __len__(self) -> int:
        return (len(self.server_down) + len(self.server_up)
                + len(self.link_down) + len(self.link_up))

    def __bool__(self) -> bool:
        return len(self) > 0 or self.r_scale is not None \
            or self.B_scale is not None

    @classmethod
    def empty(cls, t: float = 0.0) -> "FaultBatch":
        z = np.zeros(0, np.int64)
        return cls(t=t, server_down=z, server_up=z, link_down=z,
                   link_up=z)


@dataclasses.dataclass
class EvacuationReport:
    """What one ``MCSAPlanner.on_faults`` call did.

    t            : simulation time of the triggering FaultBatch (s)
    users        : (A,) fleet rows that needed evacuation (offloading to
                   a down or unreachable server)
    evacuated    : users re-admitted to a surviving candidate server
    degraded     : users degraded to device-only execution (split = M) —
                   no surviving candidate was reachable or admissible
    reassociated : device-only users whose *association* moved off a
                   down server (they consumed nothing; bookkeeping only)
    retried      : stale async-replan rows re-dispatched against the
                   updated topology instead of scattered onto a dead
                   server
    drained      : users shed from servers whose effective capacity
                   churned below their ledger usage (re-admitted through
                   the same dirty-set pipeline; capacitated topologies
                   only)
    admission    : the evacuation water-filling AdmissionReport (None
                   when nothing needed the candidate solve)
    """
    t: float
    users: np.ndarray
    evacuated: int = 0
    degraded: int = 0
    reassociated: int = 0
    retried: int = 0
    drained: int = 0
    admission: Optional[object] = None


class FaultModel:
    """Seeded fault process over one topology's servers and links.

    Owns the up/down state internally and emits only transitions; the
    live availability masks the *planner* consults belong to the
    Topology (``Topology.apply_faults`` keeps them).  Deterministic:
    the emitted batch sequence is a pure function of the config and the
    ``step`` call sequence (every step draws the same number of
    variates whatever the current state).
    """

    def __init__(self, cfg: FaultConfig, num_servers: int,
                 num_links: int = 0):
        self.cfg = cfg
        self.rng = np.random.default_rng(cfg.seed)
        self.server_ok = np.ones(int(num_servers), bool)
        self.link_ok = np.ones(int(num_links), bool)
        self._fired = np.zeros(len(cfg.schedule), bool)
        for kind, _, target in cfg.schedule:
            limit = num_servers if kind.startswith("server") else num_links
            if not (0 <= int(target) < max(limit, 1)):
                raise ValueError(
                    f"fault-schedule target {target} out of range for "
                    f"{kind} (have {limit})")

    # ------------------------------------------------------------------
    def _stochastic(self, dt: float, ok: np.ndarray,
                    mtbf: Optional[float], mttr: float) -> np.ndarray:
        """New ok-vector after one dt of the exponential process.  Draws
        len(ok) variates unconditionally so the rng stream — and hence
        the whole trajectory — never depends on the current state."""
        u = self.rng.uniform(size=len(ok))
        if mtbf is None or len(ok) == 0:
            return ok.copy()
        p_fail = -np.expm1(-dt / float(mtbf))
        p_heal = -np.expm1(-dt / float(mttr))
        flip = np.where(ok, u < p_fail, u < p_heal)
        return ok ^ flip

    def step(self, dt: float, t: float) -> FaultBatch:
        """Advance the fault process by ``dt``; return the transitions.

        Scripted schedule events whose time has come (``ev_t <= t``)
        fire exactly once and override the stochastic draw for their
        target."""
        new_srv = self._stochastic(dt, self.server_ok,
                                   self.cfg.server_mtbf,
                                   self.cfg.server_mttr)
        new_lnk = self._stochastic(dt, self.link_ok,
                                   self.cfg.link_mtbf,
                                   self.cfg.link_mttr)
        for i, (kind, ev_t, target) in enumerate(self.cfg.schedule):
            if self._fired[i] or ev_t > t:
                continue
            self._fired[i] = True
            target = int(target)
            if kind == "server_down":
                new_srv[target] = False
            elif kind == "server_up":
                new_srv[target] = True
            elif kind == "link_down":
                new_lnk[target] = False
            elif kind == "link_up":
                new_lnk[target] = True

        batch = FaultBatch(
            t=t,
            server_down=np.nonzero(self.server_ok & ~new_srv)[0],
            server_up=np.nonzero(~self.server_ok & new_srv)[0],
            link_down=np.nonzero(self.link_ok & ~new_lnk)[0],
            link_up=np.nonzero(~self.link_ok & new_lnk)[0])
        self.server_ok = new_srv
        self.link_ok = new_lnk

        if self.cfg.capacity_jitter > 0:
            Z = len(self.server_ok)
            jit = self.cfg.capacity_jitter
            batch.r_scale = np.clip(
                1.0 + jit * self.rng.standard_normal(Z), 0.25, 1.75)
            batch.B_scale = np.clip(
                1.0 + jit * self.rng.standard_normal(Z), 0.25, 1.75)
        return batch
