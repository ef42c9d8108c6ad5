"""Always-on serving telemetry: per-server ring-buffer samplers.

The port of the JAX package's ``repro/telemetry/collector.py``, numpy
only, the same operations in the same order.

The closed-loop data plane (``repro_torch.serving.dataplane``) observes the
*actual* cost of the planner's decisions — how long requests queue, how
fast tokens really come out, how full the decode slots are, what got
shed or degraded — and, before this module, threw that signal away.
:class:`TelemetryCollector` is the retention layer: one fixed-size
:class:`RingBuffer` per (server, signal) plus a handful of per-server
counters, every record an O(1) scalar write into a preallocated numpy
array, cheap enough to run unconditionally whenever a data plane is
active (collection never perturbs the simulation — the feedback knob
only controls whether anything *consumes* the samples; see
docs/ARCHITECTURE.md, "Telemetry & feedback").

Signals, all in virtual time (the data plane's deterministic clock):

* ``queue_delay_s``   — admission wait: pool clock at admission minus
  the request's ready time (arrival, or retry-backoff/relay expiry)
* ``token_latency_s`` — gap between consecutive token emissions of one
  stream (the decode-side congestion signal)
* ``ttft_s``          — submit-to-first-token per request
* ``occupancy``       — active streams / decode slots, sampled every
  pool iteration and once per control step (so idle pools still emit
  the zeros the estimator's decay needs)

plus monotone counters: ``admitted`` / ``tokens`` / ``shed`` /
``degraded`` per server.

:meth:`TelemetryCollector.harvest` turns the state into one per-server
stats dict (window means/quantiles + counter deltas since the previous
harvest) — the input contract of
:class:`repro_torch.telemetry.estimator.LoadEstimator`.
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np

#: ring-buffered signal names (one buffer per server each)
SAMPLERS = ("queue_delay_s", "token_latency_s", "ttft_s", "occupancy")
#: monotone per-server counters (harvest reports deltas)
COUNTERS = ("admitted", "tokens", "shed", "degraded")


class RingBuffer:
    """Fixed-capacity scalar sampler: ``push`` overwrites the oldest
    entry once full, so reads always describe the most recent
    ``capacity`` samples (the estimator's quantile window)."""

    __slots__ = ("_buf", "_idx", "_count")

    def __init__(self, capacity: int):
        if capacity < 1:
            raise ValueError("RingBuffer capacity must be >= 1")
        self._buf = np.zeros(int(capacity), np.float64)
        self._idx = 0
        self._count = 0

    @property
    def capacity(self) -> int:
        return len(self._buf)

    def __len__(self) -> int:
        return min(self._count, len(self._buf))

    def push(self, x: float) -> None:
        self._buf[self._idx] = x
        self._idx = (self._idx + 1) % len(self._buf)
        self._count += 1

    def values(self) -> np.ndarray:
        """The filled entries (unordered — window stats don't care)."""
        return self._buf[:len(self)]

    def mean(self, default: float = 0.0) -> float:
        n = len(self)
        return float(self._buf[:n].mean()) if n else float(default)

    def quantile(self, q: float,
                 default: Optional[float] = None) -> Optional[float]:
        n = len(self)
        if n == 0:
            return default
        return float(np.quantile(self._buf[:n], q))

    def clear(self) -> None:
        self._idx = 0
        self._count = 0


class TelemetryCollector:
    """Per-server ring buffers + counters for one data plane.

    The data plane calls the ``on_*`` hooks as events happen;
    :class:`~repro_torch.telemetry.estimator.LoadEstimator` (or anything
    else) calls :meth:`harvest` once per control step.  Counters are
    cumulative (``totals`` exposes them for ``summary()``); harvest
    additionally reports the delta since the previous harvest so the
    estimator can tell a server that served nothing from one that
    served plenty at zero delay.
    """

    def __init__(self, num_servers: int, window: int = 64):
        self.num_servers = int(num_servers)
        self.window = int(window)
        self.rings: Dict[str, list] = {
            name: [RingBuffer(self.window)
                   for _ in range(self.num_servers)]
            for name in SAMPLERS}
        self.counts: Dict[str, np.ndarray] = {
            name: np.zeros(self.num_servers, np.int64)
            for name in COUNTERS}
        self._harvest_base = {name: np.zeros(self.num_servers, np.int64)
                              for name in COUNTERS}

    # -- data-plane hooks (all O(1)) ------------------------------------
    def on_queue_delay(self, z: int, delay_s: float) -> None:
        self.rings["queue_delay_s"][z].push(max(float(delay_s), 0.0))
        self.counts["admitted"][z] += 1

    def on_token(self, z: int, latency_s: float) -> None:
        self.rings["token_latency_s"][z].push(max(float(latency_s), 0.0))
        self.counts["tokens"][z] += 1

    def on_ttft(self, z: int, ttft_s: float) -> None:
        self.rings["ttft_s"][z].push(max(float(ttft_s), 0.0))
        self.counts["tokens"][z] += 1

    def on_occupancy(self, z: int, frac: float) -> None:
        self.rings["occupancy"][z].push(min(max(float(frac), 0.0), 1.0))

    def on_shed(self, z: int) -> None:
        self.counts["shed"][z] += 1

    def on_degraded(self, z: int) -> None:
        self.counts["degraded"][z] += 1

    # -- consumers -------------------------------------------------------
    def totals(self, name: str) -> np.ndarray:
        """Cumulative counter ``name`` (``COUNTERS``), (Z,) int64."""
        return self.counts[name].copy()

    def window_mean(self, name: str, default: float = 0.0) -> np.ndarray:
        return np.asarray([rb.mean(default)
                           for rb in self.rings[name]], np.float64)

    def window_quantile(self, name: str, q: float) -> np.ndarray:
        """(Z,) windowed quantile; NaN where a server has no samples."""
        return np.asarray(
            [v if (v := rb.quantile(q)) is not None else np.nan
             for rb in self.rings[name]], np.float64)

    def harvest(self) -> dict:
        """One per-server stats bundle: window means and quantiles of
        every sampler plus counter deltas since the previous harvest
        (which this call resets).  The estimator's input contract —
        see :meth:`repro_torch.telemetry.estimator.LoadEstimator.update`."""
        out = {
            "queue_delay_mean": self.window_mean("queue_delay_s"),
            "queue_delay_p90": self.window_quantile("queue_delay_s", 0.9),
            "token_latency_mean": self.window_mean("token_latency_s"),
            "token_latency_p90": self.window_quantile(
                "token_latency_s", 0.9),
            "ttft_p90": self.window_quantile("ttft_s", 0.9),
            "occupancy_mean": self.window_mean("occupancy"),
        }
        for name in COUNTERS:
            out[name] = self.counts[name] - self._harvest_base[name]
            self._harvest_base[name] = self.counts[name].copy()
        return out
