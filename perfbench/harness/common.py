"""Pieces the drivers share: the program's model configuration, the
clock, the program's launch counters, the profiler and the
forbidden-module check."""
from __future__ import annotations

import contextlib
import sys
import time

import torch

from . import trace

#: top-level modules that may not be loaded in a run's process: JAX and
#: the JAX package the program was ported from
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def model_config(m: dict):
    """The program's ``ModelConfig`` of a configuration's ``program``
    fields (JSON lists become the tuples it takes)."""
    from repro_torch.configs.base import ModelConfig
    return ModelConfig(**{k: tuple(v) if isinstance(v, list) else v
                          for k, v in m.items()})


def now() -> float:
    return time.perf_counter()


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def launch_counters() -> dict:
    """The program's kernel launch counters, flattened by name: the
    ``LAUNCHES`` dict of every ``repro_torch.kernels`` module loaded so
    far (a kernel that has run has been loaded)."""
    out = {}
    for name, mod in list(sys.modules.items()):
        counts = getattr(mod, "LAUNCHES", None)
        if name.startswith("repro_torch.kernels.") and isinstance(counts,
                                                                  dict):
            out.update(counts)
    return out


def counter_delta(before: dict, after: dict) -> dict:
    return {k: after[k] - before.get(k, 0) for k in after}


#: a traced run profiles the last this many seconds of its window
TRACE_SECONDS = 20.0


class TracedPart:
    """The traced part of a window: the last :data:`TRACE_SECONDS` of it
    (the last half when the window is shorter than twice that), under
    the profiler of host and device activity and the ``bench.window``
    span, started and stopped between whole turns or steps; with ``on``
    False it does nothing.  After :meth:`stop`: ``begin`` the host time
    at which the part began (the turns or steps before it are the
    untraced part), ``t0``/``t1`` the profiled span's host times,
    ``start_s`` the seconds the profiler took to start (the window did
    no work meanwhile), ``launches`` the program's launches in it and
    the trace's summary returned."""

    def __init__(self, on: bool, device: torch.device, t0: float,
                 seconds: float):
        self.on, self.device = on, device
        self.start_at = t0 + max(seconds - TRACE_SECONDS, seconds / 2)
        self.prof = self._span = self._before = None
        self.begin = self.t0 = self.t1 = None
        self.start_s = 0.0
        self.launches: dict = {}

    @property
    def running(self) -> bool:
        return self.prof is not None and self.t1 is None

    def maybe_start(self) -> None:
        if not self.on or self.prof is not None or now() < self.start_at:
            return
        self.begin = now()
        sync(self.device)
        self._before = launch_counters()
        acts = [torch.profiler.ProfilerActivity.CPU]
        if self.device.type == "cuda":
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        t = now()
        self.prof = torch.profiler.profile(activities=acts)
        self.prof.__enter__()
        self._span = torch.profiler.record_function(trace.WINDOW)
        self._span.__enter__()
        self.t0 = now()
        self.start_s = self.t0 - t
        print(f"trace: profiler started in {self.start_s:.1f} s, "
              f"{self.t0 - self.start_at:.1f} s after the traced part "
              "was due", file=sys.stderr)

    def stop(self):
        """End the traced part (the caller has just synchronised) and
        return the trace's summary, or None when nothing was traced."""
        if self.prof is None:
            return None
        self.t1 = now()
        self._span.__exit__(None, None, None)
        t = now()
        self.prof.__exit__(None, None, None)
        print(f"trace: profiler stopped in {now() - t:.1f} s",
              file=sys.stderr)
        self.launches = counter_delta(self._before, launch_counters())
        return trace.summarize(self.prof)


def peak_memory(device: torch.device) -> int:
    """The peak of device memory allocated so far (0 off the card); the
    caching allocator's retries so far (each frees cached blocks and
    synchronises the device) go to standard error."""
    if device.type != "cuda":
        return 0
    peak = torch.cuda.max_memory_allocated(device)
    retries = torch.cuda.memory_stats(device).get("num_alloc_retries", 0)
    print(f"memory: peak {peak} B, allocator retries {retries}",
          file=sys.stderr)
    return peak


def span(trace: bool, name: str):
    """A named host span in the trace (``bench.<name>``) when traced."""
    if not trace:
        return contextlib.nullcontext()
    return torch.profiler.record_function("bench." + name)


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is a forbidden one, compared
    whole."""
    tops = {name.split(".", 1)[0] for name in list(sys.modules)}
    return sorted(t for t in tops if t in FORBIDDEN)


def p95(values) -> float:
    import numpy as np
    return float(np.percentile(np.asarray(values, dtype=np.float64), 95))
