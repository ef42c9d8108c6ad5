"""Persistent per-server budget ledger — THE single source of truth for
"how much compute / bandwidth does each server have left".

Before the incremental control plane, three call sites independently
recomputed "capacity minus what live users hold": the static plan's
water-filling admission, ``MCSAPlanner.on_faults``'s evacuation
(``_residual_budgets``), and ``Session.refresh_admission``.  The ledger
replaces the first two with one delta-updated usage table: users
``charge`` their (r, B) demands when admitted and ``release`` them when
they move, degrade, or get evacuated, so residuals are O(Z) reads
instead of O(X) resweeps — at 100k+ users the difference is the point.

The ledger tracks USAGE only; capacities are read live from the
topology at query time, so fault-driven capacity churn (``apply_faults``
rescaling ``r_capacity`` / ``B_capacity``) is reflected without any
sync step.  ``reset_from_fleet`` re-derives usage from a plan table
(called after every static replan), and ``audit`` recomputes it
independently so tests can assert the deltas never drifted from the
sweep the old code did (see tests/test_events.py).

Event lifecycle context: docs/ARCHITECTURE.md, "Event lifecycle".
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np


def slots_from_usage(r_used: np.ndarray, r_per_slot: float,
                     min_slots: int = 2, max_slots: int = 512) -> np.ndarray:
    """Derive per-server engine slot counts from admitted r usage.

    Each slot serves one concurrent decode stream; a server that has
    admitted ``r_used[z]`` compute units provisions
    ``ceil(r_used / r_per_slot)`` streams, floored at ``min_slots`` (so
    a freshly-empty server can still take traffic), rounded UP to a
    power of two (slot counts are a static batch dim of the compiled
    decode program — pow2 bucketing bounds the number of distinct
    compiles across the fleet), and capped at ``max_slots``.

    See docs/ARCHITECTURE.md ("Serving data plane") for how the
    closed-loop data plane sizes its engine pools with this.
    """
    if r_per_slot <= 0:
        raise ValueError("r_per_slot must be positive")
    raw = np.ceil(np.asarray(r_used, np.float64) / r_per_slot)
    raw = np.maximum(raw.astype(np.int64), int(min_slots))
    out = np.empty_like(raw)
    for i, n in enumerate(np.ravel(raw)):
        out.flat[i] = 1 << (int(n) - 1).bit_length() if n > 1 else 1
    return np.minimum(out, int(max_slots))


class BudgetLedger:
    """Delta-updated per-server (r, B) usage against a topology's live
    effective capacities.

    Usage is tracked unconditionally (it is two (Z,) float adds per
    event batch); residuals are ``None`` when the corresponding budget
    is uncapacitated, matching what ``admit_waterfill`` expects for its
    capacity arguments.
    """

    def __init__(self, topo) -> None:
        self.topo = topo
        Z = topo.num_servers
        self.r_used = np.zeros(Z, np.float64)
        self.B_used = np.zeros(Z, np.float64)

    # -- delta updates --------------------------------------------------
    def charge(self, servers: np.ndarray, r: np.ndarray,
               B: np.ndarray) -> None:
        """Add demands to usage (vectorized; duplicate servers
        accumulate).  Callers pass device-only rows with zero demand."""
        servers = np.asarray(servers, np.int64)
        np.add.at(self.r_used, servers, np.asarray(r, np.float64))
        np.add.at(self.B_used, servers, np.asarray(B, np.float64))

    def release(self, servers: np.ndarray, r: np.ndarray,
                B: np.ndarray) -> None:
        np.subtract.at(self.r_used, np.asarray(servers, np.int64),
                       np.asarray(r, np.float64))
        np.subtract.at(self.B_used, np.asarray(servers, np.int64),
                       np.asarray(B, np.float64))

    def release_rows(self, fleet, users: np.ndarray,
                     num_layers: int) -> None:
        """Release what fleet rows ``users`` currently hold (device-only
        rows hold nothing — their r/B columns are already zero)."""
        users = np.asarray(users, np.int64)
        offl = np.asarray(fleet.split)[users] < num_layers
        self.release(np.asarray(fleet.server)[users][offl],
                     np.asarray(fleet.r)[users][offl],
                     np.asarray(fleet.B)[users][offl])

    # -- bulk (re)derivation --------------------------------------------
    def reset_from_fleet(self, fleet, num_layers: int) -> None:
        """Re-derive usage from a plan table — called after every static
        replan (the plan supersedes all prior deltas)."""
        self.r_used, self.B_used = self.audit(fleet, num_layers)

    def audit(self, fleet, num_layers: int) -> Tuple[np.ndarray,
                                                     np.ndarray]:
        """Independent O(X) recompute of usage from the live plan table
        (what every pre-ledger call site swept on its own).  Tests
        compare it against the delta-updated state to prove the two
        accountings agree."""
        Z = self.topo.num_servers
        split = np.asarray(fleet.split)
        offl = split < num_layers
        srv = np.asarray(fleet.server)[offl]
        return (np.bincount(srv, weights=np.asarray(fleet.r)[offl],
                            minlength=Z).astype(np.float64),
                np.bincount(srv, weights=np.asarray(fleet.B)[offl],
                            minlength=Z).astype(np.float64))

    def drift(self, fleet, num_layers: int) -> float:
        """Max absolute usage discrepancy vs a fresh audit (float noise
        from repeated add/subtract; ~0 when the deltas are sound)."""
        r_ref, B_ref = self.audit(fleet, num_layers)
        return float(max(np.abs(self.r_used - r_ref).max(initial=0.0),
                         np.abs(self.B_used - B_ref).max(initial=0.0)))

    # -- residual queries -----------------------------------------------
    def residual_r(self) -> Optional[np.ndarray]:
        """Per-server compute headroom (clipped at 0), or None when the
        r budget is uncapacitated — directly usable as
        ``admit_waterfill``'s ``r_capacity`` argument."""
        cap = self.topo.r_capacity
        if cap is None:
            return None
        return np.maximum(np.asarray(cap, np.float64) - self.r_used, 0.0)

    def residual_B(self) -> Optional[np.ndarray]:
        cap = self.topo.B_capacity
        if cap is None:
            return None
        return np.maximum(np.asarray(cap, np.float64) - self.B_used, 0.0)

    def residuals(self) -> Tuple[Optional[np.ndarray],
                                 Optional[np.ndarray]]:
        return self.residual_r(), self.residual_B()

    # -- serving pool sizing --------------------------------------------
    def slot_counts(self, r_per_slot: float, min_slots: int = 2,
                    max_slots: int = 512) -> np.ndarray:
        """(Z,) int — engine slots per server from current r usage
        (see :func:`slots_from_usage`)."""
        return slots_from_usage(self.r_used, r_per_slot,
                                min_slots=min_slots, max_slots=max_slots)

    # -- capacity-churn overflow ----------------------------------------
    def overloaded(self, rtol: float = 1e-9) -> np.ndarray:
        """(Z,) bool — servers whose usage exceeds the LIVE effective
        capacity (e.g. after fault-driven capacity churn shrank it).
        The planner drains the overflow users of these servers."""
        Z = self.topo.num_servers
        over = np.zeros(Z, bool)
        for cap, used in ((self.topo.r_capacity, self.r_used),
                          (self.topo.B_capacity, self.B_used)):
            if cap is not None:
                cap = np.asarray(cap, np.float64)
                over |= used > cap * (1.0 + rtol)
        return over
