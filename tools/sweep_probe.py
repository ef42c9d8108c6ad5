#!/usr/bin/env python3
"""What binds kernel rows 1a and 1b, the fused Li-GD / MLi-GD sweep
(``src/repro_torch/kernels/ligd_step/csrc/sweep.cu``), on one CUDA card.

For this checkout's sweep kernel and for each ``--other DIR`` (the root of
another checkout, for example the parent unpacked with ``git archive``):

* **X-sweep**: device ms (``chip_smoke.device_ms``, median of 20 calls
  queued behind a sleep kernel) at X = 132·32·k lanes for k = 1, 2, 4,
  8, 16, 24, NiN's 10 splits, megafleet_100k's topology
  (``chip_smoke.sweep_inputs``), both variants, ``max_iters`` 60, with
  the lane-iterations the plain version counts on the same inputs.  A
  time that stays flat as X grows is latency-bound; one that grows with X
  is bound by issue.
* **Serving plan**: X = 1, the inputs ``launch/serve_split.plan_split``
  gives the sweep for starcoder2-3b's prefill profile (31 splits,
  ``max_iters`` 200), captured by a spy on the wrapper; time of one call
  (host enqueue inside, CUDA events) and device ms.
* **SASS**: ``cuobjdump -sass`` of the built library; for each kernel
  instance, each loop (a backward branch and its target) with its
  instruction count, its MUFU instructions, its calls (the IEEE
  division's slow path) and ``trip_insns``: the instructions one pass
  through the loop issues on its common path — the first conditional
  branch falls through (the GD loop's exit test; the state machine's
  choice of fast or exact arithmetic), a forward branch that skips
  stores, loads, atomics or calls is taken (a split or lane finishing,
  a slow path), any other falls through.  The whole listing goes to
  ``--sass-dir`` when given.

    python3 tools/sweep_probe.py [--other DIR ...] [--out report.json]
        [--sass-dir DIR]

Needs a CUDA card and the CUDA toolkit; prints one JSON line per
measurement and the whole report as the last line.
"""
from __future__ import annotations

import argparse
import json
import os
import re
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
SMS, WARP = 132, 32
KS = (1, 2, 4, 8, 16, 24)


def cuobjdump() -> str:
    found = shutil.which("cuobjdump")
    if found:
        return found
    return str(Path(os.environ.get("CUDA_HOME", "/usr/local/cuda"))
               / "bin" / "cuobjdump")


_FUNC = re.compile(r"^\s*Function\s*:\s*(\S+)")
_INSN = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(.*?)\s*;")
_LABEL = re.compile(r"^\s*(\.L_x_\d+):")
_TARGET = re.compile(r"\((\.L_x_\d+)\)|(0x[0-9a-f]+)")


def sass_loops(text: str) -> dict:
    """Per kernel function in a ``cuobjdump -sass`` listing: its
    instruction count and its loops, each as the instructions from a
    backward branch's target to the branch, with its MUFU instructions
    and its CALLs (the IEEE division's slow path)."""
    funcs, cur = {}, None
    for ln in text.splitlines():
        m = _FUNC.match(ln)
        if m:
            cur = funcs.setdefault(m.group(1), {"insns": [], "labels": {}})
            continue
        if cur is None:
            continue
        m = _LABEL.match(ln)
        if m:
            cur["labels"][m.group(1)] = len(cur["insns"])
            continue
        m = _INSN.search(ln)
        if m:
            cur["insns"].append((int(m.group(1), 16), m.group(2)))
    out = {}
    for name, f in funcs.items():
        insns = f["insns"]
        at = {addr: i for i, (addr, _) in enumerate(insns)}
        loops = []
        for i, (_, op) in enumerate(insns):
            if "BRA" not in op.split() and not re.search(r"\bBRA\b", op):
                continue
            t = _TARGET.search(op.split("BRA", 1)[1])
            if not t:
                continue
            j = f["labels"].get(t.group(1)) if t.group(1) else \
                at.get(int(t.group(2), 16))
            if j is None or j > i:
                continue
            body = [o for _, o in insns[j:i + 1]]
            loops.append({
                "first": j, "last": i, "insns": len(body),
                "mufu": sum(o.lstrip("@!P0123456789T ").startswith("MUFU")
                            or " MUFU." in o for o in body),
                "calls": sum("CALL" in o for o in body),
                "trip_insns": trip_insns(insns, at, f["labels"], j, i)})
        out[name] = {"insns": len(insns), "loops": loops}
    return out


def trip_insns(insns: list, at: dict, labels: dict, first: int,
               last: int) -> int:
    """Instructions issued by one pass through the loop [first, last] on
    its common path (module docstring)."""
    count, i, seen, decided = 0, first, set(), False
    while first <= i <= last and i not in seen:
        seen.add(i)
        op = insns[i][1]
        count += 1
        if i == last:
            break
        if re.search(r"\bBRA\b", op):
            t = _TARGET.search(op.split("BRA", 1)[1])
            j = labels.get(t.group(1)) if t and t.group(1) else \
                at.get(int(t.group(2), 16)) if t else None
            if j is not None and not op.startswith("@"):
                i = j
                continue
            if j is not None and decided and j > i:
                skipped = " ".join(o for _, o in insns[i + 1:j])
                if any(k in skipped for k in ("STG", "ATOM", "LDG", "CALL")):
                    i = j
                    continue
            decided = True
        i += 1
    return count


def load_package(root: Path, tag: str):
    sys.path.insert(0, str(ROOT / "tools"))
    from kernel_ab import load_package as load
    return load(root, "ligd_step", tag)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--other", action="append", default=[], type=Path)
    ap.add_argument("--out", type=Path)
    ap.add_argument("--sass-dir", type=Path)
    args = ap.parse_args()

    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    import torch
    if not torch.cuda.is_available():
        print("sweep_probe: needs a CUDA card", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from repro_torch.configs import get_config, nin
    from repro_torch.core.profile import profile_of
    from repro_torch.kernels import _build
    from repro_torch.kernels import ligd_step
    from repro_torch.kernels.ligd_step import ops as sweep_ops
    from repro_torch.launch import serve_split

    versions = {"this": ligd_step}
    for i, root in enumerate(args.other):
        versions[f"{root.name}_{i}"] = load_package(root, f"other{i}_ligd")
    dev = torch.device("cuda", 0)
    report = {"card": cs.card_line(), "sass": {}, "x_sweep": [],
              "serving_plan": []}
    print(report["card"], flush=True)

    for tag, pkg in versions.items():
        km = pkg.kernel
        km.library()
        lib = _build.library_path(km.LIB_NAME, km.SOURCE, km.FLAGS)
        proc = subprocess.run([cuobjdump(), "-sass", str(lib)],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"cuobjdump failed: {proc.stderr}")
        text = proc.stdout
        if args.sass_dir:
            args.sass_dir.mkdir(parents=True, exist_ok=True)
            (args.sass_dir / f"sweep_{tag}.sass").write_text(text)
        report["sass"][tag] = sass_loops(text)
        print(json.dumps({"sass": tag, **report["sass"][tag]}), flush=True)

    prof = profile_of(nin())
    xmax = SMS * WARP * max(KS)
    for joint in (False, True):
        feat, x0, tab = cs.sweep_inputs(prof, xmax, joint, seed=7,
                                        device=dev)
        for k in KS:
            X = SMS * WARP * k
            f, x = feat[:, :X].contiguous(), x0[:, :X].contiguous()
            kw = dict(lr=0.15, eps=1e-5, max_iters=60, warm_start=True,
                      init=(0.5,) * x.shape[0])
            ref = (ligd_step.mligd_sweep_ref if joint
                   else ligd_step.ligd_sweep_ref)
            it = ref(f, x, tab, chunk=1, **kw)[2]
            rec = {"joint": joint, "X": X, "k": k,
                   "lane_iters": float(it.sum().item()), "device_ms": {}}
            for tag, pkg in versions.items():
                fn = (lambda pkg=pkg: pkg.sweep_cuda(f, x, tab, joint=joint,
                                                     **kw))
                rec["device_ms"][tag] = cs.device_ms(fn, 20, 3)
            report["x_sweep"].append(rec)
            print(json.dumps(rec), flush=True)
        del feat, x0

    seen, unspy = cs.record_first_launches(sweep_ops)
    try:
        plan = serve_split.plan_split(get_config(serve_split.ARCH),
                                      seq=1024, batch=4,
                                      c_dev=serve_split.C_DEV, device=dev)
    finally:
        unspy()
    feat, x0, tab, kw = seen["ligd_sweep"]
    kw = dict(kw)
    joint = kw.pop("joint")
    for tag, pkg in versions.items():
        fn = (lambda pkg=pkg: pkg.sweep_cuda(feat, x0, tab, joint=joint,
                                             **kw))
        rec = {"version": tag, "X": feat.shape[1], "M1": tab.shape[0],
               "max_iters": kw["max_iters"], "split": plan["split"],
               "ms": cs.timed_ms(fn, 30, 3),
               "device_ms": cs.device_ms(fn, 30, 3)}
        report["serving_plan"].append(rec)
        print(json.dumps(rec), flush=True)

    text = json.dumps(report)
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(text)
    print(text, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
