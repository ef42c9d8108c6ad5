"""The incremental control plane's event layer: everything that can
invalidate a user's plan between static replans is normalized into one
*dirty set* and replanned by ONE fused solve per step.

Event lifecycle (docs/ARCHITECTURE.md, "Event lifecycle"):

    handoff / fault / drain  ->  dirty set (last-wins per user)
        ->  one incremental MLi-GD solve over the dirty rows
        ->  admission (argmin-U, or water-filling under the
            :class:`repro_torch.core.ledger.BudgetLedger` residuals)
        ->  sparse scatter into :class:`repro_torch.core.planner.FleetState`

Three event kinds share the pipeline:

* ``HANDOFF``  — mobility moved a user's coverage; relaying back to the
  original server (MLi-GD's R=1 vertex) is a real option.
* ``EVACUATE`` — the user's serving server went down or unreachable
  (fault); the relay-back vertex is priced at
  :data:`repro_torch.core.faults.HOP_UNREACHABLE` so it can never win.
* ``DRAIN``    — the serving server's effective capacity shrank below
  what its users hold (capacity churn); the user must re-admit, with its
  old server still a candidate but its old allocation released.

:class:`DirtySet` is the planner's per-step queue: producers enqueue
entries, ``flush()`` returns one deduplicated :class:`DirtyBatch` with
**last-wins** semantics — when the same user is enqueued twice in one
step (e.g. evacuated by a fault AND handed off by mobility in the same
tick) only the LAST entry survives, so the user is replanned exactly
once against its freshest AP/target.  Entry order is preserved for the
surviving entries, which makes the no-duplicate case an identity
transform (the pinned bit-for-bit handoff paths rely on this).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from .faults import HOP_UNREACHABLE, FaultBatch
from .mobility import HandoffBatch

#: event kinds (int8 codes in :attr:`DirtyBatch.kind`)
HANDOFF = 0
EVACUATE = 1
DRAIN = 2

KIND_NAMES = {HANDOFF: "handoff", EVACUATE: "evacuate", DRAIN: "drain"}


def last_wins_indices(users: np.ndarray) -> np.ndarray:
    """Indices of the LAST occurrence of each user, in original entry
    order — the dedup kernel of the dirty set.  With no duplicates this
    is ``arange(len(users))`` (an identity permutation), so deduping a
    plain handoff batch is bit-for-bit a no-op."""
    users = np.asarray(users)
    n = len(users)
    if n == 0:
        return np.zeros(0, np.int64)
    # unique() keeps the FIRST occurrence; scan the reversed array so
    # "first in reverse" is "last in original", then restore entry order
    _, rev_first = np.unique(users[::-1], return_index=True)
    return np.sort(n - 1 - rev_first)


@dataclasses.dataclass
class DirtyBatch:
    """One step's deduplicated dirty rows as parallel (D,) arrays — the
    unified input of ``MCSAPlanner.on_events``'s fused solve.  Field
    semantics match :class:`repro_torch.core.mobility.HandoffBatch` plus the
    event ``kind``; for EVACUATE/DRAIN rows ``hops_back`` is
    :data:`~repro_torch.core.faults.HOP_UNREACHABLE` (the relay-back vertex
    must lose) and ``new_server`` is the nearest up server (the K=1
    target; with K>1 the planner re-derives candidates from ``new_ap``).
    """
    t: float
    user: np.ndarray             # (D,) int — fleet row per entry
    kind: np.ndarray             # (D,) int8 — HANDOFF / EVACUATE / DRAIN
    old_server: np.ndarray       # (D,) int — pre-event admitted server
    new_server: np.ndarray       # (D,) int — K=1 replan target
    new_ap: np.ndarray           # (D,) int — current AP association
    hops_new: np.ndarray         # (D,) int — new_ap -> new_server hops
    hops_back: np.ndarray        # (D,) int — new_ap -> old_server (H₂)

    def __len__(self) -> int:
        return len(self.user)

    def __bool__(self) -> bool:
        return len(self.user) > 0

    def count(self, kind: int) -> int:
        return int((self.kind == kind).sum())

    @classmethod
    def empty(cls, t: float = 0.0) -> "DirtyBatch":
        z = np.zeros(0, np.int64)
        return cls(t=t, user=z, kind=np.zeros(0, np.int8), old_server=z,
                   new_server=z, new_ap=z, hops_new=z, hops_back=z)


class DirtySet:
    """Per-step dirty-user queue: handoffs, fault evacuations, and
    capacity drains all enqueue here; ``flush()`` yields one last-wins
    deduplicated :class:`DirtyBatch` for the fused solve.  See the
    module docstring for the lifecycle and the duplicate contract."""

    def __init__(self) -> None:
        self._entries: list = []
        self.t = 0.0

    def __len__(self) -> int:
        return sum(len(e["user"]) for e in self._entries)

    def enqueue(self, kind: int, users: np.ndarray,
                old_server: np.ndarray, new_server: np.ndarray,
                new_ap: np.ndarray, hops_new: np.ndarray,
                hops_back: np.ndarray, t: Optional[float] = None) -> None:
        """Append (E,) parallel arrays of one event kind.  Later entries
        win over earlier ones for the same user at ``flush()``."""
        users = np.asarray(users, np.int64)
        if len(users) == 0:
            return
        if t is not None:
            self.t = float(t)
        E = len(users)
        self._entries.append({
            "user": users,
            "kind": np.full(E, kind, np.int8),
            "old_server": np.asarray(old_server, np.int64),
            "new_server": np.asarray(new_server, np.int64),
            "new_ap": np.asarray(new_ap, np.int64),
            "hops_new": np.asarray(hops_new, np.int64),
            "hops_back": np.asarray(hops_back, np.int64),
        })

    def enqueue_handoffs(self, batch: HandoffBatch) -> None:
        """Enqueue one mobility step's HandoffBatch as HANDOFF entries
        (enqueued last in ``MCSAPlanner.on_events``, so a handoff
        supersedes a same-tick evacuation entry for the same user — the
        handoff carries the fresher AP)."""
        if len(batch) == 0:
            return
        self.enqueue(HANDOFF, batch.user, batch.old_server,
                     batch.new_server, batch.new_ap, batch.hops_new,
                     batch.hops_back, t=batch.t)

    def enqueue_evacuations(self, users: np.ndarray, old_server: np.ndarray,
                            new_server: np.ndarray, new_ap: np.ndarray,
                            hops_new: np.ndarray,
                            t: Optional[float] = None,
                            kind: int = EVACUATE) -> None:
        """EVACUATE (or DRAIN) entries: relay-back priced unreachable."""
        users = np.asarray(users, np.int64)
        self.enqueue(kind, users, old_server, new_server, new_ap,
                     hops_new,
                     np.full(len(users), HOP_UNREACHABLE, np.int64), t=t)

    def flush(self) -> DirtyBatch:
        """Concatenate, dedup last-wins, clear — one DirtyBatch per step."""
        entries, self._entries = self._entries, []
        if not entries:
            return DirtyBatch.empty(self.t)
        cat = {k: np.concatenate([e[k] for e in entries])
               for k in entries[0]}
        keep = last_wins_indices(cat["user"])
        if len(keep) != len(cat["user"]):
            cat = {k: v[keep] for k, v in cat.items()}
        return DirtyBatch(t=self.t, **cat)


@dataclasses.dataclass
class StepEvents:
    """Everything that happened to the world in one step, bundled for
    ``Policy.on_events``: the mobility handoffs plus (optionally) the
    step's applied FaultBatch.  ``faults is not None`` — even an empty
    batch — runs the fault preamble (recovery-hold decay, stale-pending
    retry, evacuation/drain detection); None skips it entirely, keeping
    unfaulted runs bit-for-bit."""
    t: float
    handoffs: HandoffBatch
    faults: Optional[FaultBatch] = None

    @classmethod
    def from_handoffs(cls, events) -> "StepEvents":
        batch = HandoffBatch.from_events(events) \
            if not isinstance(events, HandoffBatch) else events
        return cls(t=float(batch.t), handoffs=batch)


@dataclasses.dataclass
class EventOutcome:
    """What one ``MCSAPlanner.on_events`` call did.

    result     : the solver result over the deduplicated dirty rows
                 (MLiGDResult with (D,) leaves after candidate
                 reduction), or None when the dirty set was empty.
                 Under async replanning the leaves may be un-forced.
    dirty      : the deduplicated :class:`DirtyBatch` that was solved
    in_flight  : True when the solve was dispatched but not applied
                 (async) — the fleet table is stale until the next
                 event-bearing call or ``drain``
    evacuation : the step's EvacuationReport when the fault preamble ran
                 (None for pure handoff calls)
    relays / resplits / stays : decision counts over the HANDOFF rows
                 (None while in flight).  ``stays`` counts hysteresis
                 holds — users whose replan did not beat their current
                 plan by the margin, so they kept their plan row as-is.
    """
    t: float
    result: Optional[object]
    dirty: DirtyBatch
    in_flight: bool = False
    evacuation: Optional[object] = None
    relays: Optional[int] = None
    resplits: Optional[int] = None
    stays: Optional[int] = None
