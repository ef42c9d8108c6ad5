#!/usr/bin/env python3
"""Readings that the correctness limits are set from, on the card at a
cell's own size (not run by the benchmark's runs):

    python3 perfbench/control.py --workload sc2-complete \\
        --seeds 1,2,...,12 --control-seeds 1,2,3 --seconds 5 [--out FILE]

For each of ``--seeds`` the program runs as a cell runs (set-up, a short
window, the check) and its numbers are printed: their largest over the
seeds is a limit's lower reading.  For each of ``--control-seeds`` the
control is read too: the float8 reference in the program's place
(serving: at each served position of the same sample, the gap of the
token the float8 reference puts first; training: the float8
reference's three steps against the float32 reference's), and, for a
training cell, the reference with half of each batch left out in the
program's place (a state left unchanged reads 1 on the change and needs
no run).  The smallest control reading is a limit's upper reading.
Every seed runs in this one process."""
from __future__ import annotations

import argparse
import gc
import json
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
for _p in (str(HERE.parent / "src"), str(HERE)):
    if _p not in sys.path:
        sys.path.insert(0, _p)


def readings(workload: str, seed: int, seconds: float, control: bool,
             device, cfg: dict = None, mix: dict = None,
             limits: dict = None) -> dict:
    """One seed's readings from the cell's driver: ``program`` (the
    numbers a run compares) and, with ``control``, ``control`` and, for
    training, ``half_batch``."""
    import torch
    from harness import manifest

    wl = manifest.workload(workload)
    cfg = cfg or manifest.config(wl["config"])
    mix = mix or manifest.traffic(wl["traffic"])
    limits = limits or manifest.limits(workload)
    out = dict(seed=seed, **manifest.driver(mix["kind"]).readings(
        cfg["program"], mix, limits, seed, seconds, control, device))
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    return out


def main(argv=None) -> int:
    import torch
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--seconds", type=float, default=5.0)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("control: needs a CUDA card", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    ctrl = {int(s) for s in args.control_seeds.split(",") if s}
    seeds = [int(s) for s in args.seeds.split(",")]
    seeds += [s for s in sorted(ctrl) if s not in seeds]
    for seed in seeds:
        t = time.perf_counter()
        r = readings(args.workload, seed, args.seconds, seed in ctrl, device)
        r["seconds"] = time.perf_counter() - t
        line = json.dumps(r)
        print(line, flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
