#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA
card: builds the CUDA sweep kernel from the checkout, holds both of its
variants against the plain PyTorch version on the card, drives the MCSA
planner's main path (``Session(get_scenario("megafleet_100k")).run()``)
at full size, holds each variant against the plain version again on the
inputs of its first launch there, and checks the card's result against
the CPU path.

    python3 chip_smoke.py

Run it from the root of a checkout.  It needs one CUDA card, ``nvcc``
and nothing of JAX; it exits non-zero, printing no result, without a
card or outside a checkout.  Phases print one line each; any failed
phase raises.  The line before the last is one JSON object listing each
kernel with its launches on the main path, its error against the plain
version and its times; the last line is
``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

#: H100 SXM peaks (NVIDIA data sheet): HBM bytes/s, and 67e12 fp32
#: FLOP/s outside the tensor cores, which counts a fused multiply-add as
#: two (128 fp32 lanes per SM per clock).  The kernel is built with
#: --fmad=false, so each add, mul or compare is an instruction of its own:
#: ISSUE_S of them per second.  A division, exp2, log2 or sqrt issues at
#: least one multi-function-unit instruction (RCP, EX2, LG2, RSQ), of
#: which an SM runs 16 per clock on compute capability 9.0 (CUDA C++
#: Programming Guide, arithmetic instruction throughput): MUFU_S.
PEAK_BYTES_S = 3.35e12
PEAK_FP32_S = 67e12
ISSUE_S = PEAK_FP32_S / 2
MUFU_S = PEAK_FP32_S / 16

#: kernel vs plain version on the card (same arithmetic, op for op, both
#: built without fast math and without FMA contraction)
U_RTOL = 1e-5
X_ATOL = 1e-5
ITERS_SHARE = 0.01           # lanes whose count may differ, by at most 1
NEAR_TIE_RTOL = 1e-5         # best two per-split U this close may swap

#: card vs CPU session: CUDA's and ATen's CPU exp2/log2 differ by ulps,
#: so a lane sitting on the |dU| < eps threshold can stop one GD step
#: apart and land a few 1e-4 away in (B, r); the columns must agree to
#: 1e-4 relative on >= 99% of rows and to 1e-2 on every row, and a
#: discrete decision may differ only on <= 0.5% of rows
SESSION_RTOL = 1e-4
SESSION_ROW_SHARE = 0.01
SESSION_RTOL_ALL = 1e-2
SESSION_DISCRETE_SHARE = 0.005

#: operations counted from csrc/sweep.cu as (plain, mufu): per objective
#: evaluation, per GD update besides its evaluation, and per split's
#: set-up.  A plain op is an add, mul, compare or clamp side; a mufu op is
#: a division, exp2, log2 or sqrt, and counts one instruction against
#: ISSUE_S besides its one against MUFU_S (a division's Newton steps are
#: not counted, so the bound stays a lower one)
OPS = {
    "ligd_sweep": {"eval": (34, 14), "update": (22, 1), "split": (24, 6)},
    "mligd_sweep": {"eval": (64, 24), "update": (38, 1), "split": (43, 14)},
}


def phase(name: str, msg: str) -> None:
    print(f"[{name}] {msg}", flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def timed_ms(fn, runs: int, warmup: int) -> float:
    """Median per-call device time over ``runs`` calls (CUDA events)."""
    import torch
    for _ in range(warmup):
        fn()
    starts = [torch.cuda.Event(enable_timing=True) for _ in range(runs)]
    ends = [torch.cuda.Event(enable_timing=True) for _ in range(runs)]
    for s, e in zip(starts, ends):
        s.record()
        fn()
        e.record()
    torch.cuda.synchronize()
    times = sorted(s.elapsed_time(e) for s, e in zip(starts, ends))
    return times[len(times) // 2]


def sweep_inputs(profile, X: int, joint: bool, seed: int, device):
    """Realistic sweep inputs from numpy: megafleet_100k's topology
    (per-lane edge rows of a user's nearest server), c_dev over the
    scenario's range, random frozen original strategies for MLi-GD."""
    import numpy as np
    from repro_torch.api import get_scenario
    from repro_torch.core.costs import (DeviceFleet, rows_to_device,
                                        stack_edges_np)
    from repro_torch.kernels.ligd_step import (pack_sweep_features,
                                               sweep_tables, table_tensor)
    rng = np.random.default_rng(seed)
    topo = get_scenario("megafleet_100k").build_topology()
    ap = rng.integers(0, topo.num_aps, X)
    srv = topo.ap_server[ap]
    devs = DeviceFleet(c_dev=rng.uniform(3e9, 6e9, X)).arrays
    devs = dict(devs, hops=topo.hops[ap, srv],
                t_ag=np.full(X, 2e-3))
    dev = rows_to_device(devs, device, X)
    edge = rows_to_device({k: v[srv] for k, v in
                           stack_edges_np(topo.edges).items()}, device, X)
    orig = hops_back = None
    if joint:
        f_l, f_e, w = profile.prefix_tables()
        s = rng.integers(0, len(f_l), X)
        o = rows_to_device({"f_l": f_l[s], "f_e": f_e[s], "w": w[s],
                            "r": rng.uniform(1.0, 32.0, X),
                            "rent": rng.uniform(1e-4, 5e-3, X),
                            "hops_back": rng.integers(1, 6, X)}, device, X)
        orig, hops_back = o, o["hops_back"]
    feat = pack_sweep_features(dev, edge, float(profile.result_bits), X,
                               orig=orig, hops_back=hops_back)
    import torch
    K = 4 if joint else 2
    x0 = torch.full((K, X), 0.5, dtype=torch.float32, device=device)
    return feat, x0, table_tensor(sweep_tables(profile), device)


def bound_ms(name: str, X: int, M1: int, K: int, iters) -> tuple:
    """Least time the card could take for one sweep: the larger of the
    bytes it must move (the feature rows this variant reads, x0 and the
    tables once; every output once) over PEAK_BYTES_S, and the
    operations that these inputs' iteration counts need (OPS) over the
    issue and MUFU rates.  Returns (ms, "bytes" or "operations")."""
    from repro_torch.kernels.ligd_step import NROWS_JOINT, NROWS_LIGD
    rows = NROWS_JOINT if name == "mligd_sweep" else NROWS_LIGD
    bytes_ = 4 * (X * (rows + K + 4 * M1 + 2 + K) + 4 * M1)
    it_sum = float(iters.sum().item())
    count = {"eval": it_sum + M1 * X, "update": it_sum, "split": M1 * X}
    plain = sum(n * OPS[name][k][0] for k, n in count.items())
    mufu = sum(n * OPS[name][k][1] for k, n in count.items())
    t_bytes = bytes_ / PEAK_BYTES_S * 1e3
    t_ops = max((plain + mufu) / ISSUE_S, mufu / MUFU_S) * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def record_first_launches(ops_mod) -> tuple:
    """Spy on the kernel wrapper that ``ops_mod`` launches: keep a copy
    of the inputs and arguments of the first launch of each variant, then
    launch as before (the wrapper still counts each launch once).  Returns
    (records by kernel name, a function that removes the spy)."""
    seen = {}
    launch = ops_mod.sweep_cuda

    def spy(feat, x0, tables, **kw):
        name = "mligd_sweep" if kw["joint"] else "ligd_sweep"
        if name not in seen:
            seen[name] = (feat.clone(), x0.clone(), tables.clone(), kw)
        return launch(feat, x0, tables, **kw)

    ops_mod.sweep_cuda = spy
    return seen, lambda: setattr(ops_mod, "sweep_cuda", launch)


def synthetic_case(profile, X, joint, max_iters, device) -> tuple:
    feat, x0, tab = sweep_inputs(profile, X, joint, seed=7, device=device)
    kw = dict(joint=joint, lr=0.15, eps=1e-5, max_iters=max_iters,
              warm_start=True, init=(0.5,) * x0.shape[0])
    return feat, x0, tab, kw


def compare_sweep(name, label, feat, x0, tab, kw) -> dict:
    """Kernel vs plain version on the same card inputs (``kw``: the
    wrapper's keyword arguments); raises on a breach.  Returns the
    measured numbers."""
    import torch
    from repro_torch.kernels.ligd_step import (ligd_sweep_ref,
                                               mligd_sweep_ref, sweep_cuda)
    kw = dict(kw)
    joint = kw.pop("joint")
    K = x0.shape[0]
    X = feat.shape[1]
    run_k = lambda: sweep_cuda(feat, x0, tab, joint=joint, **kw)  # noqa: E731
    ref = mligd_sweep_ref if joint else ligd_sweep_ref
    run_p = lambda: ref(feat, x0, tab, chunk=1, **kw)              # noqa: E731
    u_k, xB_k, xr_k, it_k, best_k = run_k()
    u_p, x_p, it_p, bs_p, bx_p, bu_p = run_p()
    torch.cuda.synchronize()

    rel_u = ((u_k - u_p).abs() / u_p.abs().clamp_min(1e-30)).max().item()
    rel_bu = ((best_k[1] - bu_p).abs()
              / bu_p.abs().clamp_min(1e-30)).max().item()
    err_x = max((xB_k - x_p[0]).abs().max().item(),
                (xr_k - x_p[1]).abs().max().item(),
                *((best_k[2 + i] - bx_p[i]).abs().max().item()
                  for i in range(K)))
    abs_u = max((u_k - u_p).abs().max().item(),
                (best_k[1] - bu_p).abs().max().item())
    d_it = (it_k - it_p).abs()
    lanes_it = (d_it.max(0).values > 0).float().mean().item()
    max_dit = d_it.max().item()
    top2 = torch.topk(u_p, 2, dim=0, largest=False).values
    near_tie = (top2[1] - top2[0]) <= NEAR_TIE_RTOL * top2[0].abs()
    split_diff = best_k[0] != bs_p
    split_bad = int((split_diff & ~near_tie).sum().item())

    ms = timed_ms(run_k, runs=30, warmup=3)
    plain_ms = timed_ms(run_p, runs=3, warmup=1)
    M1 = tab.shape[0]
    b_ms, b_by = bound_ms(name, X, M1, K, it_p)
    rec = dict(X=X, M1=M1, u_rel=rel_u, best_u_rel=rel_bu, x_abs=err_x,
               iters_lanes_differ=lanes_it, iters_max_diff=max_dit,
               split_diff=int(split_diff.sum().item()),
               split_diff_outside_near_ties=split_bad,
               near_tie_lanes=int(near_tie.sum().item()),
               ms=ms, plain_ms=plain_ms,
               mean_iters_per_split=float(it_p.mean().item()),
               bound_ms=b_ms, bound_by=b_by,
               max_abs_err=max(abs_u, err_x))
    phase("kernel", f"{name} {label} " + json.dumps(rec))
    breaches = []
    if not (rel_u <= U_RTOL and rel_bu <= U_RTOL):
        breaches.append(f"U rel {max(rel_u, rel_bu):.3g} > {U_RTOL}")
    if not err_x <= X_ATOL:
        breaches.append(f"x abs {err_x:.3g} > {X_ATOL}")
    if not (max_dit <= 1 and lanes_it <= ITERS_SHARE):
        breaches.append(f"iteration counts: {lanes_it:.3%} lanes differ, "
                        f"max {max_dit}")
    if split_bad:
        breaches.append(f"{split_bad} split mismatches outside near-ties")
    if breaches:
        raise AssertionError(f"{name} {label} X={X}: " + "; ".join(breaches))
    return rec


def check_fleet(fleet, num_layers: int, num_servers: int) -> None:
    import numpy as np
    from repro_torch.core.planner import PLAN_FIELDS
    for f in PLAN_FIELDS:
        col = getattr(fleet, f)
        if not np.all(np.isfinite(col)):
            raise AssertionError(f"FleetState.{f} has non-finite values")
    if not (fleet.split.min() >= 0 and fleet.split.max() <= num_layers):
        raise AssertionError(f"split outside [0, {num_layers}]")
    if not (fleet.server.min() >= 0 and fleet.server.max() < num_servers):
        raise AssertionError(f"server outside [0, {num_servers})")


def compare_fleets(a, b) -> dict:
    """Card FleetState ``a`` vs CPU FleetState ``b``; raises on breach."""
    import numpy as np
    out, breaches = {}, []
    n = len(a.server)
    for f in ("server", "split", "R"):
        share = float(np.mean(getattr(a, f) != getattr(b, f)))
        out[f"{f}_differ"] = share
        if share > SESSION_DISCRETE_SHARE:
            breaches.append(f"{f}: {share:.3%} rows differ")
    for f in ("B", "r", "U", "T", "E", "C"):
        x, y = getattr(a, f), getattr(b, f)
        rel = np.abs(x - y) / np.maximum(np.abs(y), 1e-30)
        out[f"{f}_rel_max"] = float(rel.max())
        share = float(np.mean(rel > SESSION_RTOL))
        out[f"{f}_rows_over_rtol"] = share
        if share > SESSION_ROW_SHARE or rel.max() > SESSION_RTOL_ALL:
            breaches.append(f"{f}: {share:.3%} rows over {SESSION_RTOL}, "
                            f"max rel {rel.max():.3g}")
    out["rows"] = n
    if breaches:
        raise AssertionError("card vs CPU session: " + "; ".join(breaches))
    return out


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this "
              "script needs one CUDA card", file=sys.stderr)
        return 2
    if not (SRC / "repro_torch" / "__init__.py").is_file():
        print(f"chip_smoke: {SRC / 'repro_torch'} not found; run from the "
              "root of a checkout", file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))
    t_start = time.perf_counter()

    # 1. card ----------------------------------------------------------
    card = card_line()
    print(card, flush=True)
    phase("card", f"{card} | torch {torch.__version__} cuda "
          f"{torch.version.cuda} | python {sys.version.split()[0]}")
    device = torch.device("cuda", 0)

    # 2. build ---------------------------------------------------------
    from repro_torch.kernels import _build
    from repro_torch.kernels.ligd_step import kernel as sweep_kernel
    t0 = time.perf_counter()
    sweep_kernel.library()
    build_s = time.perf_counter() - t0
    log = _build.library_path("mcsa_sweep", sweep_kernel.SOURCE)
    ptxas = [ln.strip() for ln in log.with_suffix(".log").read_text()
             .splitlines() if "registers" in ln or "spill" in ln] \
        if log.with_suffix(".log").exists() else []
    phase("build", f"{build_s:.2f} s ({log.name}) " + " | ".join(ptxas))

    # 3. kernel against plain on the card --------------------------------
    from repro_torch.configs import nin, vgg16
    from repro_torch.core.profile import profile_of
    nin_p, vgg_p = profile_of(nin()), profile_of(vgg16())
    errs = {"ligd_sweep": [], "mligd_sweep": []}
    for name, joint in (("ligd_sweep", False), ("mligd_sweep", True)):
        for prof, X in ((nin_p, 100_000), (vgg_p, 8192)):
            case = synthetic_case(prof, X, joint, 60, device)
            rec = compare_sweep(name, f"{prof.name} synthetic", *case)
            errs[name].append(rec["max_abs_err"])

    # 4. main path -------------------------------------------------------
    from repro_torch.api import Session, get_scenario
    from repro_torch.kernels.ligd_step import ops as sweep_ops
    sc = get_scenario("megafleet_100k")
    recorded, unspy = record_first_launches(sweep_ops)
    for k in sweep_kernel.LAUNCHES:
        sweep_kernel.LAUNCHES[k] = 0
    try:
        t0 = time.perf_counter()
        sess = Session(sc)                      # device=None -> the card
        metrics = sess.run()
        torch.cuda.synchronize()
        main_s = time.perf_counter() - t0
        launches = dict(sweep_kernel.LAUNCHES)
    finally:
        unspy()
    if sess.device.type != "cuda":
        raise AssertionError(f"main path ran on {sess.device}")
    if not all(v > 0 for v in launches.values()):
        raise AssertionError(f"a kernel never launched: {launches}")
    if sess.policy.pending:
        raise AssertionError("a replan is still in flight after run()")
    check_fleet(sess.fleet, sess.profile.num_layers, sess.topo.num_servers)
    phase("main", json.dumps({
        "scenario": sc.name, "users": sc.num_users, "steps": sc.steps,
        "async": sc.async_replanning, "wall_s": main_s,
        "timings": sess.timings, "launches": launches,
        "handoffs_per_step": metrics.handoffs.tolist(),
        "mean_T": metrics.mean_T.tolist()}))

    # 4b. each kernel against plain on the main path's own inputs: the
    # Li-GD launch of the static plan and the first step's MLi-GD launch
    recs = {}
    for name in ("ligd_sweep", "mligd_sweep"):
        recs[name] = compare_sweep(name, f"{sc.name} main-path launch",
                                   *recorded[name])
        errs[name].append(recs[name]["max_abs_err"])
    del recorded

    # 5. card against the CPU path ---------------------------------------
    small = sc.replace(num_users=4096, steps=3)
    fleets = {}
    for dev in ("cuda", "cpu"):
        s = Session(small, device=dev)
        s.run()
        check_fleet(s.fleet, s.profile.num_layers, s.topo.num_servers)
        fleets[dev] = s.fleet
    phase("cross", json.dumps(compare_fleets(fleets["cuda"], fleets["cpu"])))

    # 6. kernels line, 7. result ----------------------------------------
    src = "src/repro_torch/kernels/ligd_step/csrc/sweep.cu"
    kernels = [{
        "name": name, "route": "cuda", "source": src,
        "replaces": "src/repro/kernels/ligd_step/kernel.py:189",
        "launches": launches[name], "max_abs_err": max(errs[name]),
        "ms": r["ms"], "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
        "bound_by": r["bound_by"], "library_ms": None,
    } for name, r in recs.items()]
    phase("done", f"{time.perf_counter() - t_start:.1f} s in all")
    print(card, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
