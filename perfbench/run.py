#!/usr/bin/env python3
"""Run one cell of the benchmark of the PyTorch/CUDA port on the card:

    python3 perfbench/run.py --workload <name> --seed <n> --seconds <s> \\
        --trace <0|1>

The cell (``BENCHMARK.json``'s ``workloads``) names a configuration
(its file of sizes), a traffic mix (``traffic/<name>.json``) and its
correctness limits (``limits/<workload>.json``).  Inputs and weights
come from ``--seed``; set-up (weights, kernels built at first use into
the checkout's ``build/``, a warm-up through the window's own calls) is
``setup_s``; the window measures for ``--seconds``; then the outputs are
judged against the plain reference.  With ``--trace 0`` the result
holds the cell's end-to-end metrics, with ``--trace 1`` its per-layer
metrics from a profiled window.  The last line of standard output is
the result as one JSON object; the last lines of standard error give
each number compared beside its limit.  Without a CUDA card the run
fails and prints no result.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
for _p in (str(ROOT / "src"), str(HERE)):
    if _p not in sys.path:
        sys.path.insert(0, _p)

def power_limit() -> str:
    """The card's name and power limit as ``nvidia-smi`` reads them, or
    an empty string."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
    except (OSError, subprocess.SubprocessError):
        return ""
    return out.stdout.strip().splitlines()[0] if out.stdout.strip() else ""


def execute(workload: str, seed: int, seconds: float, trace: bool, device,
            t_start: float, cfg: dict = None, mix: dict = None,
            limits: dict = None, fault=None) -> dict:
    """Run one cell and build its result (without the device's name):
    the drivers and readers only; ``cfg``, ``mix`` and ``limits``
    replace the cell's files (tests at a small size)."""
    import math
    from harness import manifest

    wl = manifest.workload(workload)
    cfg = cfg or manifest.config(wl["config"])
    mix = mix or manifest.traffic(wl["traffic"])
    limits = limits or manifest.limits(workload)
    out = manifest.driver(mix["kind"]).run(
        cfg["program"], mix, limits, seed, seconds, trace, device,
        fault=fault)
    e2e_entries, layer_entries = manifest.cell_metrics(workload)
    metrics = {}
    if trace:
        ctx = dict(out["ctx"], workload=workload)
        for e in layer_entries:
            v = manifest.reader(e["name"])(ctx)
            if v is not None:
                metrics[e["name"]] = {"value": v, "unit": e["unit"]}
    else:
        values = dict(out["e2e"], setup_s=out["t0"] - t_start)
        for e in e2e_entries:
            metrics[e["name"]] = {"value": values[e["name"]],
                                  "unit": e["unit"]}
    checks = {k: {"value": v, "limit": lim}
              for k, (v, lim) in out["checks"].items()}
    correct = (out["failed"] == 0 and all(
        math.isfinite(c["value"]) and c["value"] <= c["limit"]
        for c in checks.values()))
    print(f"setup_s: {out['t0'] - t_start!r}", file=sys.stderr)
    result = {"correct": correct, "attempted": out["attempted"],
              "failed": out["failed"], "metrics": metrics,
              "device": {"memory_peak_bytes": out["peak"]}}
    if trace:
        t = out["trace"]
        result["device"].update(busy_s=t["busy_s"], window_s=t["window_s"])
        result["breakdown"] = {"device_ops": t["device_ops"],
                               "idle_gaps": t["idle_gaps"]}
        print("device s by op: " + ", ".join(
            f"{k} {v!r}" for k, v in t["groups"].items() if v),
            file=sys.stderr)
    result["checks"] = checks
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    # caches that a library may write stay inside the checkout, at fixed
    # paths
    for var, sub in (("TRITON_CACHE_DIR", "triton"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TORCHINDUCTOR_CACHE_DIR", "inductor")):
        os.environ.setdefault(var, str(HERE / ".cache" / sub))

    import torch
    from harness import common, manifest

    chips = manifest.workload(args.workload)["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"perfbench: cell {args.workload} needs {chips} CUDA card(s), "
              f"found {n}; no result", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    result = execute(args.workload, args.seed, args.seconds,
                     bool(args.trace), device, T_START)
    bad = common.forbidden_modules()
    if bad:
        print(f"perfbench: forbidden modules loaded: {', '.join(bad)}; "
              "no result", file=sys.stderr)
        return 3
    result["device"] = dict(platform="gpu",
                            kind=torch.cuda.get_device_name(device),
                            count=chips, **result["device"],
                            power=power_limit())
    sys.stdout.flush()
    for name, c in result["checks"].items():
        print(f"check {name}: {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
