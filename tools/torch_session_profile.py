#!/usr/bin/env python3
"""Where the time goes in the port's main path on the card.

Runs ``Session(get_scenario(<scenario>)).run()`` (default
``megafleet_100k``: 100k users, 5 async steps) twice on one CUDA card —
the first run warms the CUDA context, the allocator and the kernel
library — and reports for the second run:

* host wall-clock per phase, from timers wrapped around the planner's and
  the mobility model's methods: mobility step, applying the previous
  step's replan (which waits for its solve and copies it to the host),
  gathering + copying the dirty rows to the device + launching the
  solve, and the static plan;
* device time by kernel from ``torch.profiler`` (CUDA activity), and the
  device's busy share of the run's wall-clock.

    python3 tools/torch_session_profile.py [--scenario megafleet_100k]
        [--out chiprun_out/session_profile.json]

Needs a CUDA card; prints one JSON object (also written to ``--out``).
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from collections import defaultdict
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def _timed(obj, name: str, bucket: dict, key: str) -> None:
    """Wrap ``obj.name`` so its host wall-clock accumulates in
    ``bucket[key]``."""
    fn = getattr(obj, name)

    def wrapper(*a, **kw):
        t0 = time.perf_counter()
        try:
            return fn(*a, **kw)
        finally:
            bucket[key] += time.perf_counter() - t0

    setattr(obj, name, wrapper)


def run_once(scenario, profile: bool):
    import torch
    from repro_torch.api import Session
    from repro_torch.kernels.ligd_step import LAUNCHES

    for k in LAUNCHES:
        LAUNCHES[k] = 0
    host = defaultdict(float)
    prof = None
    if profile:
        prof = torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA])
        prof.__enter__()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sess = Session(scenario)
    plan_s = time.perf_counter() - t0
    _timed(sess.mobility, "step", host, "mobility_s")
    _timed(sess.policy, "_apply_inflight", host, "apply_previous_s")
    _timed(sess.policy, "_solve_dirty", host, "gather_copy_launch_s")
    _timed(sess.policy, "on_events", host, "on_events_s")
    sess.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    if prof is not None:
        prof.__exit__(None, None, None)
    return sess, dict(host, plan_s=plan_s, wall_s=wall), dict(LAUNCHES), prof


def device_times(prof) -> dict:
    """Device microseconds by kernel name (events on the CUDA device
    only: the CPU ops that launched them report the same time again)."""
    import torch
    out = {}
    for ev in prof.key_averages():
        if ev.device_type != torch.autograd.DeviceType.CUDA:
            continue
        dev_us = getattr(ev, "self_device_time_total", None)
        if dev_us is None:
            dev_us = getattr(ev, "self_cuda_time_total", 0.0)
        if dev_us and dev_us > 0:
            out[ev.key] = {"device_us": float(dev_us), "count": ev.count}
    return dict(sorted(out.items(), key=lambda kv: -kv[1]["device_us"]))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--scenario", default="megafleet_100k")
    ap.add_argument("--out", default=str(ROOT / "chiprun_out"
                                         / "session_profile.json"))
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.api import get_scenario

    sc = get_scenario(args.scenario)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    run_once(sc, profile=False)                       # warm-up
    sess, host, launches, prof = run_once(sc, profile=True)
    dev = device_times(prof)
    busy_us = sum(v["device_us"] for v in dev.values())
    sweep_us = sum(v["device_us"] for k, v in dev.items()
                   if "sweep_kernel" in k)
    report = {
        "card": card, "scenario": sc.name, "users": sc.num_users,
        "steps": sc.steps, "host_s": host, "timings": sess.timings,
        "launches": launches,
        "handoffs_per_step": sess.metrics().handoffs.tolist(),
        "device_busy_us": busy_us, "sweep_kernel_us": sweep_us,
        "device_busy_share": busy_us * 1e-6 / host["wall_s"],
        "device_by_kernel_top": dict(list(dev.items())[:12]),
    }
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(report, indent=1))
    print(json.dumps(report))
    return 0


if __name__ == "__main__":
    sys.exit(main())
