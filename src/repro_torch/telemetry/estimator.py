"""Online load estimation: telemetry samples -> congestion multipliers.

The port of the JAX package's ``repro/telemetry/estimator.py``, numpy
only, the same operations in the same order.

:class:`LoadEstimator` folds each :meth:`TelemetryCollector.harvest
<repro_torch.telemetry.collector.TelemetryCollector.harvest>` bundle into
per-server EWMA state and emits a :class:`LoadSnapshot` — the *only*
object the planner ever sees from the serving side.  The snapshot
carries two multiplier vectors with a hard contract (asserted by the
property tests in ``tests/test_telemetry.py`` and documented in
docs/ARCHITECTURE.md, "Telemetry & feedback"):

* **bounded**   — every multiplier lies in ``[1.0, max_mult]``;
* **monotone**  — ``compute_mult`` is non-decreasing in observed queue
  delay, ``backhaul_mult`` non-decreasing in observed slot occupancy;
* **decaying**  — with no fresh load the EWMAs shrink geometrically,
  so both multipliers converge back to the identity ``1.0``.

The multipliers are *beliefs about residual capacity*, applied as
divisors: ``c_min / compute_mult`` (effective compute rate) and
``B_backhaul / backhaul_mult`` (effective backhaul bandwidth) via
:func:`repro_torch.core.costs.apply_congestion`.  ``compute_mult`` is a
queueing-delay penalty normalised by the server's own observed
per-token service time (so "one extra token's worth of queueing"
reads the same on fast and slow servers); ``backhaul_mult``
interpolates ``1 -> max_mult`` quadratically in slot occupancy, a
smooth stand-in for the M/M/1 ``1/(1-rho)`` blow-up without its
division-by-zero edge.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from repro_torch.telemetry.collector import TelemetryCollector


def ewma_update(prev: float, x: float, alpha: float) -> float:
    """One exponentially-weighted moving-average step:
    ``(1 - alpha) * prev + alpha * x``."""
    return (1.0 - alpha) * prev + alpha * x


def ewma(samples, alpha: float, init: Optional[float] = None) -> float:
    """Fold a sample sequence through :func:`ewma_update` (seeded with
    the first sample when ``init`` is None).  Output is a convex
    combination of its inputs, hence bounded by the sample range — the
    property pinned in tests/test_telemetry.py."""
    it = iter(samples)
    if init is None:
        try:
            init = float(next(it))
        except StopIteration:
            raise ValueError("ewma() of empty sequence with no init")
    acc = float(init)
    for x in it:
        acc = ewma_update(acc, float(x), alpha)
    return acc


@dataclasses.dataclass(frozen=True)
class LoadSnapshot:
    """Per-server congestion beliefs at virtual time ``t``.

    ``compute_mult`` / ``backhaul_mult`` are (Z,) float64 vectors in
    ``[1, max_mult]`` (identity 1.0 == uncongested); the raw EWMA
    signals they were derived from ride along for metrics and
    debugging.  Consumed by ``MCSAPlanner.update_load`` which divides
    the static edge table and the admission residuals by them.
    """

    t: float
    compute_mult: np.ndarray
    backhaul_mult: np.ndarray
    queue_delay_s: np.ndarray      # EWMA of admission wait, (Z,)
    occupancy: np.ndarray          # EWMA of slot occupancy, (Z,)
    token_ref_s: np.ndarray        # EWMA per-token service time, (Z,)
    token_latency_p90_s: np.ndarray  # windowed p90, NaN where unseen

    def is_identity(self, atol: float = 1e-9) -> bool:
        """True when the snapshot would not change any plan: both
        multiplier vectors are 1.0 everywhere (the ``feedback=off``
        fixed point)."""
        return bool(np.all(np.abs(self.compute_mult - 1.0) <= atol)
                    and np.all(np.abs(self.backhaul_mult - 1.0) <= atol))

    def to_dict(self) -> dict:
        return {
            "t": self.t,
            "compute_mult": [float(v) for v in self.compute_mult],
            "backhaul_mult": [float(v) for v in self.backhaul_mult],
            "queue_delay_s": [float(v) for v in self.queue_delay_s],
            "occupancy": [float(v) for v in self.occupancy],
        }


class LoadEstimator:
    """EWMA state machine from harvest bundles to :class:`LoadSnapshot`.

    Update rules per server, one :meth:`update` per control step:

    * ``qd`` (queue delay): EWMA toward the window mean when the server
      admitted anything this interval, otherwise a pure geometric decay
      ``qd *= (1 - alpha)`` — idle servers forget congestion.
    * ``occ`` (occupancy): always EWMA'd; idle pools emit explicit 0.0
      samples so this decays on its own.
    * ``tok`` (per-token service time): EWMA'd only when tokens were
      observed; it is a *scale* estimate, not a load signal, so it is
      held (never decayed) while idle.  Servers that have never emitted
      a token borrow the fleet mean (1.0 s if nobody has).

    Multipliers (both clipped to ``[1, max_mult]``):

    * ``compute_mult  = 1 + qd / tok_ref``
    * ``backhaul_mult = 1 + (max_mult - 1) * occ**2``
    """

    def __init__(self, num_servers: int, *, alpha: float = 0.25,
                 max_mult: float = 8.0):
        if not (0.0 < alpha <= 1.0):
            raise ValueError(f"alpha must be in (0, 1], got {alpha}")
        if max_mult < 1.0:
            raise ValueError(f"max_mult must be >= 1, got {max_mult}")
        self.num_servers = int(num_servers)
        self.alpha = float(alpha)
        self.max_mult = float(max_mult)
        self._qd = np.zeros(self.num_servers, np.float64)
        self._occ = np.zeros(self.num_servers, np.float64)
        self._tok = np.full(self.num_servers, np.nan, np.float64)
        self._p90 = np.full(self.num_servers, np.nan, np.float64)
        self.updates = 0

    # -- state folding ---------------------------------------------------
    def observe(self, harvest: dict) -> None:
        """Fold one :meth:`TelemetryCollector.harvest` bundle into the
        EWMA state (see class docstring for the per-signal rules)."""
        a = self.alpha
        admitted = np.asarray(harvest["admitted"]) > 0
        qd_obs = np.nan_to_num(
            np.asarray(harvest["queue_delay_mean"], np.float64))
        self._qd = np.where(admitted,
                            (1.0 - a) * self._qd + a * qd_obs,
                            (1.0 - a) * self._qd)
        occ_obs = np.nan_to_num(
            np.asarray(harvest["occupancy_mean"], np.float64))
        self._occ = (1.0 - a) * self._occ + a * occ_obs
        saw_tok = np.asarray(harvest["tokens"]) > 0
        tok_obs = np.asarray(harvest["token_latency_mean"], np.float64)
        seeded = np.isnan(self._tok)
        tok_next = np.where(seeded, tok_obs,
                            (1.0 - a) * self._tok + a * tok_obs)
        self._tok = np.where(saw_tok, tok_next, self._tok)
        self._p90 = np.asarray(harvest["token_latency_p90"], np.float64)
        self.updates += 1

    def snapshot(self, t: float = 0.0) -> LoadSnapshot:
        """The current beliefs as an immutable :class:`LoadSnapshot`
        (contract: bounded, monotone, decays to identity)."""
        tok = self._tok
        fleet_ref = float(np.nanmean(tok)) if np.any(~np.isnan(tok)) \
            else 1.0
        ref = np.where(np.isnan(tok), fleet_ref, tok)
        ref = np.maximum(ref, 1e-9)
        compute = np.clip(1.0 + self._qd / ref, 1.0, self.max_mult)
        occ = np.clip(self._occ, 0.0, 1.0)
        backhaul = np.clip(1.0 + (self.max_mult - 1.0) * occ * occ,
                           1.0, self.max_mult)
        return LoadSnapshot(
            t=float(t), compute_mult=compute, backhaul_mult=backhaul,
            queue_delay_s=self._qd.copy(), occupancy=occ,
            token_ref_s=ref, token_latency_p90_s=self._p90.copy())

    def update(self, collector: TelemetryCollector,
               t: float = 0.0) -> LoadSnapshot:
        """Harvest + observe + snapshot: the one call ``Session.step``
        makes per feedback interval."""
        self.observe(collector.harvest())
        return self.snapshot(t)
