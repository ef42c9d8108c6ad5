#!/usr/bin/env python3
"""Where the time goes in the port's main paths on the card.

Planner (default): runs ``Session(get_scenario(<scenario>)).run()``
(default ``megafleet_100k``: 100k users, 5 async steps) twice on one
CUDA card — the first run warms the CUDA context, the allocator and the
kernel library — and reports for the second run:

* host wall-clock per phase, from timers wrapped around the planner's and
  the mobility model's methods: mobility step, applying the previous
  step's replan (which waits for its solve and copies it to the host),
  gathering + copying the dirty rows to the device + launching the
  solve, and the static plan;
* device time by kernel from ``torch.profiler`` (CUDA activity), and the
  device's busy share of the run's wall-clock.

Serving (``--serve [MODEL]``, default starcoder2-3b; also
granite-moe-1b-a400m and rwkv6-3b): the model at full width and depth
(random weights), split at the Li-GD choice, ``SplitServer`` prefill of
4 prompts of 1024 tokens then 31 decode steps, after one warm-up
generation; for the prefill and for the decode steps apart: host
wall-clock, device busy share and device time by kernel, grouped into
the hand-written kernels, matrix products and the rest.

    python3 tools/torch_session_profile.py [--scenario megafleet_100k]
        [--serve [MODEL]] [--out report.json]

Needs a CUDA card; prints one JSON object (also written to ``--out``
when given).
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


def _groups(dev: dict) -> dict:
    """Device microseconds of the hand-written kernels, the matrix
    products (cuBLAS / CUTLASS kernels) and everything else."""
    mine = {"flash_attention": ("flash_attention_kernel",),
            "rmsnorm": ("rmsnorm_kernel",),
            "moe_swiglu": ("moe_swiglu", "sum_slices_kernel"),
            "wkv6": ("wkv6_kernel",), "sweep": ("sweep_kernel",)}
    out = dict.fromkeys(tuple(mine) + ("matmul", "other"), 0.0)
    for name, v in dev.items():
        hit = [k for k, subs in mine.items() if any(t in name for t in subs)]
        if hit:
            key = hit[0]
        elif any(t in name.lower() for t in ("gemm", "xmma", "cutlass",
                                             "cublas", "gemv", "nvjet")):
            key = "matmul"
        else:
            key = "other"
        out[key] += v["device_us"]
    return out


def serve_profile(arch: str) -> dict:
    import torch
    from repro_torch.configs import get_config
    from repro_torch.launch.serve_split import C_DEV, make_inputs, plan_split
    from repro_torch.serving import SplitServer

    batch, prompt_len, new_tokens = 4, 1024, 32   # chip_smoke.py's [serve]
    device = torch.device("cuda", 0)
    cfg = get_config(arch)
    params, tokens = make_inputs(cfg, device=device, batch=batch,
                                 prompt_len=prompt_len)
    split = plan_split(cfg, seq=prompt_len, batch=batch, c_dev=C_DEV,
                       device=device)["split"]
    server = SplitServer(cfg, params, device=device)
    server.generate(tokens, split, max_new=new_tokens)          # warm-up
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    report = {"model": cfg.name, "layers": cfg.num_layers, "split": split,
              "batch": batch, "prompt_len": prompt_len}
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        _, nxt, caches = server.prefill(tokens, split,
                                        prompt_len + new_tokens)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    report["prefill"] = _phase_report(prof, wall, 1)
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for i in range(new_tokens - 1):
            _, nxt, caches = server.decode(nxt[:, None], prompt_len + i,
                                           caches, split)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    report["decode"] = _phase_report(prof, wall, new_tokens - 1)
    return report


def _phase_report(prof, wall_s: float, steps: int) -> dict:
    dev = device_times(prof)
    busy_us = sum(v["device_us"] for v in dev.values())
    return {"wall_ms": wall_s * 1e3, "steps": steps,
            "wall_ms_per_step": wall_s * 1e3 / steps,
            "device_busy_ms": busy_us * 1e-3,
            "device_busy_share": busy_us * 1e-6 / wall_s,
            "device_ms_by_group": {k: v * 1e-3
                                   for k, v in _groups(dev).items()},
            "device_by_kernel_top": dict(list(dev.items())[:10])}


def emit(report: dict, out) -> int:
    """Print the report as one JSON line; also write it to ``out``."""
    if out:
        Path(out).parent.mkdir(parents=True, exist_ok=True)
        Path(out).write_text(json.dumps(report, indent=1))
    print(json.dumps(report))
    return 0


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--scenario", default="megafleet_100k")
    ap.add_argument("--serve", nargs="?", const="starcoder2-3b",
                    default=None, metavar="MODEL",
                    help="profile full-width split serving of MODEL "
                         "(default starcoder2-3b) instead")
    ap.add_argument("--out", default=None,
                    help="also write the report to this JSON file")
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.api import get_scenario

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    if args.serve:
        return emit(dict(serve_profile(args.serve), card=card), args.out)
    sc = get_scenario(args.scenario)
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
    return emit(report, args.out)


if __name__ == "__main__":
    sys.exit(main())
