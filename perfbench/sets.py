#!/usr/bin/env python3
"""Run one cell several times, each run a process of its own as a check
runs it, and print each metric's median and spread:

    python3 perfbench/sets.py --workload sc2-complete --seeds 11,12,13 \\
        --seconds 30 [--trace 0] [--sets 2] [--out FILE]

``--sets 2`` runs the list of seeds twice (the same seeds in both sets).
A spread is the distance between the first and third quartiles
(``statistics.quantiles(values, n=4)``) as a share of the median; a
set's first run is left out of ``setup_s``'s median, since a checkout's
first run builds the kernels.  Each run's result line, exit code,
seconds and the end of its standard error go to ``--out`` (JSON lines).
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent


def spread(values: list) -> float:
    if len(values) < 2:
        return float("nan")
    q1, med, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / med if med else float("nan")


def one(workload: str, seed: int, seconds: float, trace: int) -> dict:
    cmd = [sys.executable, str(HERE / "run.py"), "--workload", workload,
           "--seed", str(seed), "--seconds", str(seconds), "--trace",
           str(trace)]
    t = time.perf_counter()
    p = subprocess.run(cmd, capture_output=True, text=True)
    out = {"seed": seed, "rc": p.returncode,
           "seconds": time.perf_counter() - t,
           "stderr_tail": p.stderr[-3000:]}
    lines = p.stdout.strip().splitlines()
    if p.returncode == 0 and lines:
        out["result"] = json.loads(lines[-1])
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, default=0)
    ap.add_argument("--sets", type=int, default=1)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    seeds = [int(s) for s in args.seeds.split(",")]
    sets = []
    for k in range(args.sets):
        runs = []
        for seed in seeds:
            r = one(args.workload, seed, args.seconds, args.trace)
            runs.append(r)
            res = r.get("result", {})
            print(json.dumps({"set": k, "seed": seed, "rc": r["rc"],
                              "seconds": round(r["seconds"], 2),
                              "correct": res.get("correct"),
                              "metrics": {n: v["value"] for n, v in
                                          res.get("metrics", {}).items()},
                              "checks": {n: v["value"] for n, v in
                                         res.get("checks", {}).items()},
                              "peak": res.get("device", {}).get(
                                  "memory_peak_bytes")}), flush=True)
            if r["rc"] != 0 or "result" not in r:
                print(r["stderr_tail"], flush=True)
            if args.out:
                with open(args.out, "a") as f:
                    f.write(json.dumps(dict(r, set=k)) + "\n")
        sets.append(runs)
    for k, runs in enumerate(sets):
        ok = [r["result"] for r in runs if "result" in r]
        names = sorted({n for r in ok for n in r["metrics"]})
        for n in names:
            vals = [r["metrics"][n]["value"] for r in ok
                    if n in r["metrics"]]
            if n == "setup_s" and len(vals) > 2:
                vals = vals[1:]
            print(f"set {k} {n}: median {statistics.median(vals)!r} "
                  f"spread {spread(vals)!r} n {len(vals)}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
