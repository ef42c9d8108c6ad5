"""Telemetry + adaptive feedback: serving load closes the loop back
into the planner.

The port of the JAX package's ``repro/telemetry`` (numpy only, held
equal to it bit for bit).  ``collector`` retains what the data plane
observes (per-server ring buffers in virtual time); ``estimator`` turns
the samples into a bounded, monotone, idle-decaying
:class:`LoadSnapshot` of congestion multipliers that
``MCSAPlanner.update_load`` prices replans and admission against.
"""
from repro_torch.telemetry.collector import (COUNTERS, SAMPLERS, RingBuffer,
                                             TelemetryCollector)
from repro_torch.telemetry.estimator import (LoadEstimator, LoadSnapshot,
                                             ewma, ewma_update)

__all__ = [
    "COUNTERS",
    "SAMPLERS",
    "RingBuffer",
    "TelemetryCollector",
    "LoadEstimator",
    "LoadSnapshot",
    "ewma",
    "ewma_update",
]
