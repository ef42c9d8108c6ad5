#!/usr/bin/env python3
"""Where the time goes in the port's main paths on the card.

Planner (default): runs ``Session(get_scenario(<scenario>)).run()``
(default ``megafleet_100k``: 100k users, 5 async steps; ``--users`` and
``--r-capacity`` resize it, e.g. chaos_singlefail_k3 at 100,000 users
and 40,000 units a server, chip_smoke.py's [admission] world) twice on
one CUDA card — the first run warms the CUDA context, the allocator and
the kernel library — and reports for the second run:

* host wall-clock per phase, from timers wrapped around the planner's,
  the mobility model's and the fault process's methods: mobility step,
  applying the previous step's replan (which waits for its solve and
  copies it to the host), gathering + copying the dirty rows to the
  device + launching the solve, the static plan, and on admission /
  fault worlds the fault process, the fault preamble, the admission of
  the dirty rows, the waterfill, the ledger, and the device-to-host
  copies of solve results (each of which first waits for its solve);
* device time by kernel from ``torch.profiler`` (CUDA activity), the
  sweep's and the copies' (``Memcpy``) device time apart, and the
  device's busy share of the run's wall-clock.

Serving (``--serve [MODEL]``, default starcoder2-3b; also
granite-moe-1b-a400m, rwkv6-3b and recurrentgemma-9b): the model at
full width and depth (random weights), split at the Li-GD choice,
``SplitServer`` prefill of 4 prompts of 1024 tokens (2560 for
recurrentgemma-9b, longer than its 2048-token window) then 31 decode
steps, after one warm-up
generation; for the prefill and for the decode steps apart: host
wall-clock, device busy share and device time by kernel, grouped into
the hand-written kernels, matrix products and the rest.

The closed loop (``--serve-loop``): chip_smoke.py's ``[serve-loop]``
world, ``serve_chaos_k3`` at its own size with full-width starcoder2-3b
engine pools, one run under the profiler (no warm-up run: it would
double a minute of host work): host wall-clock, the Session's timings
(``serve_s``: the data plane; ``steps_s``: mobility and replans), the
engines' prefills and decode steps, the device's busy share and device
time by group.

Training (``--train [MODEL]``): chip_smoke.py's ``[train]`` step
(starcoder2-3b by default) or that of one of its TRAIN_FAMILIES phases
(granite-moe-1b-a400m, rwkv6-3b, recurrentgemma-9b at 12 layers,
seamless-m4t-large-v2), at that phase's width, depth, batch and
sequence, remat, AdamW: one warm-up step,
one step with the AdamW update timed apart (synchronised before and
after it), then two steps under the profiler: host wall-clock, device
busy share and device time by group (the forward and backward kernels
apart).

    python3 tools/torch_session_profile.py [--scenario megafleet_100k]
        [--users N] [--r-capacity R] [--serve [MODEL]] [--serve-loop]
        [--train [MODEL]] [--out report.json]

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
    import repro_torch.core.planner as planner_mod
    from repro_torch.api import Session
    from repro_torch.kernels.ligd_step import LAUNCHES

    for k in LAUNCHES:
        LAUNCHES[k] = 0
    host = defaultdict(float)
    # module functions the planner looks up at call time: wrapped for
    # this run, restored after it
    saved = {n: getattr(planner_mod, n) for n in ("admit_waterfill",
                                                  "_host")}
    _timed(planner_mod, "admit_waterfill", host, "waterfill_s")
    _timed(planner_mod, "_host", host, "device_to_host_s")
    prof = None
    if profile:
        prof = torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA])
        prof.__enter__()
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        sess = Session(scenario)
        plan_s = time.perf_counter() - t0
        pol = sess.policy
        _timed(sess.mobility, "step", host, "mobility_s")
        _timed(pol, "_apply_inflight", host, "apply_previous_s")
        _timed(pol, "_solve_dirty", host, "gather_copy_launch_s")
        _timed(pol, "on_events", host, "on_events_s")
        _timed(pol, "_admit_dirty", host, "admit_dirty_s")
        _timed(pol, "_fault_preamble", host, "fault_preamble_s")
        for name in ("release_rows", "charge", "reset_from_fleet"):
            _timed(pol.ledger, name, host, "ledger_s")
        if sess.fault_model is not None:
            _timed(sess.fault_model, "step", host, "fault_process_s")
            _timed(sess.topo, "apply_faults", host, "fault_process_s")
        sess.run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        for n, fn in saved.items():
            setattr(planner_mod, n, fn)
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
    mine = {"flash_attention": ("flash_attention_kernel",
                                "flash_attention_tc_kernel"),
            # the bf16 body's four kernels, then the f32 body's three
            "flash_attention_bwd": ("attn_bwd_delta",
                                    "attn_bwd_dkdv_tc_kernel",
                                    "attn_bwd_sum_kernel",
                                    "attn_bwd_dq_tc_kernel",
                                    "attn_bwd_prep", "attn_bwd_dkdv",
                                    "attn_bwd_dq"),
            "rmsnorm": ("rmsnorm_kernel",),
            "rmsnorm_bwd": ("rmsnorm_bwd_rows_kernel",
                            "rmsnorm_bwd_dw_kernel"),
            # the wgmma body's three kernels, then the mma.sync and
            # CUDA-core bodies' three
            "moe_swiglu_bwd": ("hopper_tc::hidden_kernel",
                               "hopper_tc::dx_kernel",
                               "hopper_tc::dw_kernel", "bwd_hidden",
                               "bwd_dx", "bwd_dw"),
            "moe_swiglu": ("moe_swiglu", "sum_slices_kernel",
                           "hopper_tc::gate_up_kernel",
                           "hopper_tc::down_kernel"),
            # the serial body's kernel, then the chunked body's five
            "wkv6_bwd": ("wkv6_bwd_kernel", "bwd_chunked::"),
            "wkv6": ("wkv6_kernel", "chunked::chunk_", "wkv6_chunk::chunk_"),
            "rglru_scan_bwd": ("rglru_bwd_",),
            "rglru_scan": ("rglru_scan_kernel",),
            "sweep": ("sweep_kernel",)}
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

    device = torch.device("cuda", 0)
    cfg = get_config(arch)
    # chip_smoke.py's [serve] phases; recurrentgemma's prompts pass its
    # window, as in [serve-hybrid]
    batch, new_tokens = 4, 32
    prompt_len = 2560 if arch == "recurrentgemma-9b" else 1024
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


def serve_loop_profile() -> dict:
    import torch
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    from repro_torch.api import get_scenario
    from repro_torch.configs import get_config

    device = torch.device("cuda", 0)
    sc = get_scenario("serve_chaos_k3")
    cfg = get_config("starcoder2-3b")
    factory = cs.FullWidthEngines(cfg, sc.serving.cache_len, device,
                                  cs.SERVE_LOOP_SEED)
    counters = cs.kernel_counters()
    cs.zero_counters(counters)
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        sess = cs.serving_session(sc, factory, device)
        m = sess.run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    launches = cs.all_launches(counters)
    L = cfg.num_layers
    prefills = launches["flash_attention"] // L
    forwards = launches["rmsnorm"] // (2 * L + 1)
    rep = _phase_report(prof, wall, 1)
    rep.update(scenario=sc.name, engine=cfg.name, timings=sess.timings,
               prefills=prefills, decode_steps=forwards - prefills,
               launches=launches,
               summary={k: v for k, v in m.serving.items()
                        if k != "per_server"})
    return rep


def train_profile(arch: str) -> dict:
    import dataclasses
    import torch
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    from repro_torch.configs import get_config
    from repro_torch.models import transformer as tfm
    from repro_torch.optim import adamw
    from repro_torch.optim.schedules import cosine_with_warmup
    from repro_torch.runtime.data import DataConfig, batch_at
    from repro_torch.runtime.train import TrainConfig, make_train_step

    device = torch.device("cuda", 0)
    shapes = {a: (layers, batch, seq) for _, a, layers, batch, seq, _, _
              in cs.TRAIN_FAMILIES}
    shapes["starcoder2-3b"] = (None, cs.TRAIN_BATCH, cs.TRAIN_SEQ)
    if arch not in shapes:
        raise SystemExit(f"--train takes one of {sorted(shapes)}")
    layers, batch, seq = shapes[arch]
    cfg = get_config(arch)
    if layers is not None:
        cfg = dataclasses.replace(cfg, num_layers=layers)
    params = tfm.init_lm(cfg, torch.Generator(device).manual_seed(0),
                         device)
    opt = adamw.init(params)
    step_fn = make_train_step(cfg, TrainConfig(remat=True),
                              lr_schedule=cosine_with_warmup(2, 10))
    dcfg = DataConfig(seed=0, seq_len=seq, global_batch=batch)
    batches = [batch_at(cfg, dcfg, s, device) for s in range(4)]
    params, opt, _ = step_fn(params, opt, batches[0])         # warm-up

    update, update_s = adamw.update, []

    def timed(*a, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = update(*a, **kw)
        torch.cuda.synchronize()
        update_s.append(time.perf_counter() - t0)
        return out

    adamw.update = timed
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params, opt, _ = step_fn(params, opt, batches[1])
        torch.cuda.synchronize()
        step_s = time.perf_counter() - t0
    finally:
        adamw.update = update
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for b in batches[2:]:
            params, opt, _ = step_fn(params, opt, b)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    rep = _phase_report(prof, wall, 2)
    rep.update(model=cfg.name, layers=cfg.num_layers, batch=batch, seq=seq,
               remat=True, step_s_unprofiled=step_s,
               adamw_update_s=update_s[0])
    return rep


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
    ap.add_argument("--users", type=int, default=None,
                    help="replace the scenario's num_users")
    ap.add_argument("--r-capacity", type=float, default=None,
                    help="replace the scenario's per-server r budget")
    ap.add_argument("--serve", nargs="?", const="starcoder2-3b",
                    default=None, metavar="MODEL",
                    help="profile full-width split serving of MODEL "
                         "(default starcoder2-3b) instead")
    ap.add_argument("--serve-loop", action="store_true",
                    help="profile chip_smoke.py's [serve-loop] closed "
                         "loop instead")
    ap.add_argument("--train", nargs="?", const="starcoder2-3b",
                    default=None, metavar="MODEL",
                    help="profile chip_smoke.py's [train] step of MODEL "
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
    if args.serve_loop:
        return emit(dict(serve_loop_profile(), card=card), args.out)
    if args.train:
        return emit(dict(train_profile(args.train), card=card), args.out)
    sc = get_scenario(args.scenario)
    changes = {k: v for k, v in (("num_users", args.users),
                                 ("r_capacity", args.r_capacity))
               if v is not None}
    if changes:
        sc = sc.replace(**changes)
    run_once(sc, profile=False)                       # warm-up
    sess, host, launches, prof = run_once(sc, profile=True)
    dev = device_times(prof)
    busy_us = sum(v["device_us"] for v in dev.values())
    sweep_us = sum(v["device_us"] for k, v in dev.items()
                   if "sweep_kernel" in k)
    copy_us = sum(v["device_us"] for k, v in dev.items()
                  if "memcpy" in k.lower())
    report = {
        "card": card, "scenario": sc.name, "users": sc.num_users,
        "steps": sc.steps, "host_s": host, "timings": sess.timings,
        "launches": launches,
        "handoffs_per_step": sess.metrics().handoffs.tolist(),
        "r_capacity": sc.r_capacity, "candidates_k": sc.candidates_k,
        "device_busy_us": busy_us, "sweep_kernel_us": sweep_us,
        "copy_us": copy_us, "admission": sess.admission,
        "faults": sess.metrics().faults,
        "device_busy_share": busy_us * 1e-6 / host["wall_s"],
        "device_by_kernel_top": dict(list(dev.items())[:12]),
    }
    return emit(report, args.out)


if __name__ == "__main__":
    sys.exit(main())
