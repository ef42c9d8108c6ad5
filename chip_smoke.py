#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA
card, over its main paths.

* The MCSA planner: builds the CUDA kernels from the checkout, holds both
  variants of the sweep kernel against the plain PyTorch version on the
  card, drives ``Session(get_scenario("megafleet_100k")).run()`` at full
  size, holds each variant against the plain version again on the inputs
  of its first launch there, and checks the card's result against the
  CPU path.
* Split LLM serving of starcoder2-3b at full width and depth (random
  weights from a seed): holds the RMSNorm and flash-attention kernels
  against their plain versions at the model's shapes, runs Li-GD split
  generation against unsplit generation and the continuous-batching
  engine over 16 requests, and compares the card with the CPU path on a
  2-layer cut of the same width.
* Split serving of the MoE family (granite-moe-1b-a400m) and of RWKV-6
  (rwkv6-3b) at full width and depth, the same way: holds the fused
  expert SwiGLU and WKV6 kernels (and attention at granite's shape)
  against their plain versions, runs split against unsplit generation and
  the engine, compares card with CPU on 2-layer cuts and runs the float32
  engine there.

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

#: H100 SXM dense bf16 tensor-core rate (NVIDIA data sheet): the least
#: time for attention's products counts them at this rate
PEAK_BF16_S = 989e12

#: language-model kernels vs plain version on the card, as atol = rtol
#: (``torch.allclose``).  RMSNorm, the reference's own kernel-test
#: tolerances: f32 sums in another order (1e-5), one bf16 output rounding
#: (5e-2).  Attention: another summation order in f32 (2e-5); in bf16
#: 1e-2, set from the card's readings (max abs error <= 0.0039 at these
#: shapes), not the reference tests' 3e-2: a long causal row's output is
#: only ~0.05 in size.  Attention's error RMS over the output's RMS must
#: also stay within ATTN_RMS_TOL (readings: <= 4.6e-5 in bf16, where
#: both sides round the same f32 value and differ by one ulp on a few
#: elements; 5.8e-7 in f32), so a fault confined to a few rows or one kv
#: tile cannot hide under an elementwise bound
RMS_TOL = {"float32": 1e-5, "bfloat16": 5e-2}
ATTN_TOL = {"float32": 2e-5, "bfloat16": 1e-2}
ATTN_RMS_TOL = {"float32": 2e-5, "bfloat16": 1e-3}

#: fused expert SwiGLU vs plain version, as atol = rtol: float32 1e-5, the
#: reference kernel tests' figure (the same float32 products summed in
#: another order; reading 3.5e-6); bfloat16 in and out, where both sides
#: round nearly the same float32 value once (the tensor-core path carries
#: h as bf16 hi + lo): 2e-2 elementwise (readings: at most 0.0156, one
#: bf16 ulp at values 2-4), and the error's RMS over the output's RMS
#: within 1e-3 (readings 1.3e-4 at most).  WKV6: 2e-4 on y and the final
#: state, the reference kernel tests' figure (readings 4.6e-5 at most),
#: for float32 and bfloat16 r/k/v alike (both read bf16 exactly and
#: compute in float32), with the RMS ratio within 1e-6 (readings 1.6e-7).
MOE_TOL = {"float32": 1e-5, "bfloat16": 2e-2}
MOE_RMS_TOL = {"float32": 1e-5, "bfloat16": 1e-3}
WKV_TOL = 2e-4
WKV_RMS_TOL = 1e-6

#: card vs CPU on the 2-layer full-width cut: bf16 prefill logits to the
#: reference's own bound for one model computed in two orders (atol 0.08,
#: rtol 0.02, tests/test_split_serving.py); f32 greedy tokens exactly
CROSS_ATOL, CROSS_RTOL = 0.08, 0.02

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


def build_all(modules) -> None:
    """Build every kernel library at once (one nvcc each, in threads) and
    print each build's ptxas register and spill lines."""
    from concurrent.futures import ThreadPoolExecutor
    from repro_torch.kernels import _build

    def one(mod):
        t0 = time.perf_counter()
        mod.library()
        return time.perf_counter() - t0

    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(modules)) as pool:
        secs = list(pool.map(one, modules))
    phase("build", f"{time.perf_counter() - t0:.2f} s for "
          f"{len(modules)} libraries in parallel")
    for mod, sec in zip(modules, secs):
        lib = _build.library_path(mod.LIB_NAME, mod.SOURCE, mod.FLAGS)
        log = lib.with_suffix(".log")
        ptxas = [ln.strip() for ln in log.read_text().splitlines()
                 if "registers" in ln or "spill" in ln] if log.exists() \
            else []
        phase("build", f"{mod.LIB_NAME}: {sec:.2f} s ({lib.name}) "
              + " | ".join(ptxas))


def attention_pairs(S: int, causal: bool, window: int) -> int:
    """(query, key) pairs the masks leave for one head of an S-token
    sequence attending to itself."""
    import numpy as np
    q = np.arange(S)
    if causal:
        n = q + 1
        if window:
            n = np.minimum(n, window)
    else:
        lo = np.maximum(q - window + 1, 0) if window else np.zeros(S, int)
        n = S - lo
    return int(n.sum())


def lm_kernel_cases(device) -> dict:
    """RMSNorm and flash attention against their plain versions on the
    card at starcoder2-3b's shapes, with times, bounds and the one-call
    library time.  Returns, per kernel, the record of its main-path case
    (RMSNorm: 4096 prefill rows in bf16; attention: B=4, S=1024, causal,
    bf16) with ``max_abs_err`` the largest over its cases."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import rmsnorm as rn
    g = torch.Generator(device=device).manual_seed(11)

    def randn(shape, dt):
        return torch.randn(shape, generator=g, device=device).to(dt)

    out, breaches = {}, []
    d, eps = 3072, 1e-6
    errs = []
    for rows in (8, 4096):
        for dtn in ("bfloat16", "float32"):
            dt = getattr(torch, dtn)
            x, w = randn((rows, d), dt), randn((d,), dt)
            got = rn.rmsnorm_cuda(x, w, eps).float()
            want = rn.rmsnorm_ref(x, w, eps).float()
            err = (got - want).abs().max().item()
            errs.append(err)
            tol = RMS_TOL[dtn]
            if not torch.allclose(got, want, atol=tol, rtol=tol):
                breaches.append(f"rmsnorm {rows}x{d} {dtn}: {err:.3g}")
            w1 = (1.0 + w.float()).to(dt)
            rec = dict(
                rows=rows, d=d, dtype=dtn, max_abs_err=err,
                ms=timed_ms(lambda: rn.rmsnorm_cuda(x, w, eps), 30, 3),
                plain_ms=timed_ms(lambda: rn.rmsnorm_ref(x, w, eps), 30, 3),
                library_ms=timed_ms(lambda: F.rms_norm(x, (d,), w1, eps),
                                    30, 3),
                bound_ms=(2 * rows * d + d) * x.element_size()
                / PEAK_BYTES_S * 1e3, bound_by="bytes")
            phase("lm-kernel", "rmsnorm " + json.dumps(rec))
            if (rows, dtn) == (4096, "bfloat16"):
                out["rmsnorm"] = rec
    out["rmsnorm"]["max_abs_err"] = max(errs)

    sc2, granite = (24, 2, 128), (16, 8, 64)      # (Hq, Hkv, hd)
    errs = []
    for B, S, causal, window, dtn, (Hq, Hkv, hd) in (
            (1, 2048, True, 0, "bfloat16", sc2),
            (4, 1024, True, 0, "bfloat16", sc2),
            (1, 512, True, 128, "bfloat16", sc2),
            (1, 512, False, 0, "bfloat16", sc2),
            (1, 2048, True, 0, "float32", sc2),
            (4, 1024, True, 0, "bfloat16", granite)):
        dt = getattr(torch, dtn)
        q = randn((B, S, Hq, hd), dt)
        k, v = randn((B, S, Hkv, hd), dt), randn((B, S, Hkv, hd), dt)
        kw = dict(causal=causal, window=window)
        got = fa.flash_attention_cuda(q, k, v, **kw).float()
        want = fa.attention_ref(q, k, v, **kw).float()
        err = (got - want).abs().max().item()
        rel_rms = ((got - want).square().mean().sqrt()
                   / want.square().mean().sqrt()).item()
        errs.append(err)
        tol, rms_tol = ATTN_TOL[dtn], ATTN_RMS_TOL[dtn]
        if not (torch.allclose(got, want, atol=tol, rtol=tol)
                and rel_rms <= rms_tol):
            breaches.append(f"attention B={B} S={S} {kw} {dtn}: max "
                            f"{err:.3g} (tol {tol}), error RMS / output "
                            f"RMS {rel_rms:.3g} (tol {rms_tol})")
        del got, want
        qh, kh, vh = (t.transpose(1, 2) for t in (q, k, v))
        mask = None
        if window:
            i = torch.arange(S, device=device)
            mask = (i[:, None] >= i[None, :]) & (i[:, None] - i[None, :]
                                                  < window)

        def library():
            return F.scaled_dot_product_attention(
                qh, kh, vh, attn_mask=mask,
                is_causal=causal and mask is None, enable_gqa=True)

        try:
            lib_ms = timed_ms(library, 30, 3)
        except TypeError:        # a PyTorch without enable_gqa
            lib_ms = None
        flops = 4.0 * B * Hq * hd * attention_pairs(S, causal, window)
        t_ops = flops / PEAK_BF16_S * 1e3
        t_bytes = (2 * q.numel() + 2 * k.numel()) * q.element_size() \
            / PEAK_BYTES_S * 1e3
        rec = dict(
            B=B, S=S, Hq=Hq, Hkv=Hkv, hd=hd, causal=causal, window=window,
            dtype=dtn, max_abs_err=err, rel_rms_err=rel_rms,
            ms=timed_ms(lambda: fa.flash_attention_cuda(q, k, v, **kw),
                        30, 3),
            plain_ms=timed_ms(lambda: fa.attention_ref(q, k, v, **kw),
                              5, 1),
            library_ms=lib_ms, flops=flops,
            bound_ms=max(t_ops, t_bytes),
            bound_by="operations" if t_ops >= t_bytes else "bytes")
        phase("lm-kernel", "flash_attention " + json.dumps(rec))
        if (B, S, window, hd) == (4, 1024, 0, 128):
            out["flash_attention"] = rec
        elif hd == 64:
            out["flash_attention_hd64"] = rec
    out["flash_attention"]["max_abs_err"] = max(errs)
    if breaches:
        raise AssertionError("LM kernel vs plain: " + "; ".join(breaches))
    return out


def rel_rms(got, want) -> float:
    return ((got - want).square().mean().sqrt()
            / want.square().mean().sqrt()).item()


def moe_wkv_kernel_cases(device) -> dict:
    """The fused expert SwiGLU and WKV6 kernels against their plain
    versions on the card: MoE at granite-moe-1b-a400m's prefill shape
    (E 32, C 1280 = capacity_for(4096 tokens), d 1024, ff 512, bf16), its
    engine decode shape (C 4 at 8 slots) and a ragged case (ff 1408,
    moonshot's width, C not a multiple of the 16-row tile) in float32 and
    bfloat16; WKV6 at rwkv6-3b's prefill shape (B 4, S 1024, H 40, n 64,
    bf16 r/k/v) from a non-zero state, and at S 1 with the state aliased
    as in decode.  Returns, per kernel, the record of its main-path case
    (the prefill shape) with ``max_abs_err`` the largest over its
    cases."""
    import torch
    import torch.nn.functional as F
    from repro_torch.configs import get_config
    from repro_torch.kernels import moe_gemm as mg
    from repro_torch.kernels import wkv6 as wk
    from repro_torch.models.moe import capacity_for
    g = torch.Generator(device=device).manual_seed(13)

    def randn(shape, scale=1.0):
        return torch.randn(shape, generator=g, device=device) * scale

    out, breaches = {}, []
    granite = get_config("granite-moe-1b-a400m")
    E, d, ff = granite.num_experts, granite.d_model, granite.d_ff
    C_prefill = capacity_for(4 * 1024, granite, 1.25)
    C_decode = capacity_for(8, granite, 2.0)
    errs = []
    for label, E_, C, ff_, dtn in (("prefill", E, C_prefill, ff, "bfloat16"),
                                   ("decode", E, C_decode, ff, "bfloat16"),
                                   ("ragged", 4, 37, 1408, "float32"),
                                   ("ragged", 4, 37, 1408, "bfloat16"),
                                   ("ragged", 4, 37, 1000, "bfloat16")):
        dt = getattr(torch, dtn)
        x = randn((E_, C, d)).to(dt)
        wg = randn((E_, d, ff_), d ** -0.5).to(dt)
        wu = randn((E_, d, ff_), d ** -0.5).to(dt)
        wd = randn((E_, ff_, d), ff_ ** -0.5).to(dt)
        got = mg.moe_swiglu_cuda(x, wg, wu, wd).float()
        want = mg.moe_swiglu_ref(x, wg, wu, wd).float()
        err = (got - want).abs().max().item()
        rr = rel_rms(got, want)
        errs.append(err)
        tol, rms_tol = MOE_TOL[dtn], MOE_RMS_TOL[dtn]
        if not (torch.allclose(got, want, atol=tol, rtol=tol)
                and rr <= rms_tol):
            breaches.append(f"moe_swiglu {label} {dtn}: max {err:.3g} (tol "
                            f"{tol}), RMS ratio {rr:.3g} (tol {rms_tol})")
        del got, want
        flops = 6.0 * E_ * C * d * ff_
        peak = PEAK_BF16_S if dtn == "bfloat16" else PEAK_FP32_S
        t_ops = flops / peak * 1e3
        t_bytes = (2 * x.numel() + 3 * wg.numel()) * x.element_size() \
            / PEAK_BYTES_S * 1e3

        def library():
            h = F.silu(torch.bmm(x, wg)) * torch.bmm(x, wu)
            return torch.bmm(h, wd)

        rec = dict(
            case=label, E=E_, C=C, d=d, ff=ff_, dtype=dtn, max_abs_err=err,
            rel_rms_err=rr, flops=flops,
            ms=timed_ms(lambda: mg.moe_swiglu_cuda(x, wg, wu, wd), 30, 3),
            plain_ms=timed_ms(lambda: mg.moe_swiglu_ref(x, wg, wu, wd),
                              10, 2),
            library_ms=timed_ms(library, 30, 3),
            library_call="composition: 3 torch.bmm + silu (no single call)",
            bound_ms=max(t_ops, t_bytes),
            bound_by="operations" if t_ops >= t_bytes else "bytes")
        phase("lm-kernel", "moe_swiglu " + json.dumps(rec))
        if label == "prefill":
            out["moe_swiglu"] = rec
    out["moe_swiglu"]["max_abs_err"] = max(errs)

    rwkv = get_config("rwkv6-3b")
    H, n = rwkv.rwkv_num_heads, rwkv.rwkv_head_dim
    errs = []
    for label, B, S, dtn in (("prefill", 4, 1024, "bfloat16"),
                             ("prefill", 4, 1024, "float32"),
                             ("decode, aliased state", 8, 1, "bfloat16")):
        dt = getattr(torch, dtn)
        r, k, v = (randn((B, S, H, n)).to(dt) for _ in range(3))
        w = torch.rand((B, S, H, n), generator=g, device=device) * 0.65 + 0.3
        u = randn((H, n), 0.5)
        s0 = randn((B, H, n, n), 0.5)
        want_y, want_s = wk.wkv6_ref(r, k, v, w, u, s0)
        if S == 1:
            state = s0.clone()
            got_y, got_s = wk.wkv6_cuda(r, k, v, w, u, state,
                                        state_out=state)
            if got_s.data_ptr() != state.data_ptr():
                breaches.append("wkv6 did not write the aliased state")
        else:
            got_y, got_s = wk.wkv6_cuda(r, k, v, w, u, s0)
        err = max((got_y - want_y).abs().max().item(),
                  (got_s - want_s).abs().max().item())
        rr = max(rel_rms(got_y, want_y), rel_rms(got_s, want_s))
        errs.append(err)
        if not (torch.allclose(got_y, want_y, atol=WKV_TOL, rtol=WKV_TOL)
                and torch.allclose(got_s, want_s, atol=WKV_TOL,
                                   rtol=WKV_TOL) and rr <= WKV_RMS_TOL):
            breaches.append(f"wkv6 {label} {dtn}: max {err:.3g} (tol "
                            f"{WKV_TOL}), RMS ratio {rr:.3g} (tol "
                            f"{WKV_RMS_TOL})")
        ops = 3.0 * B * S * H * n * n
        t_ops = ops / ISSUE_S * 1e3
        t_bytes = (r.numel() * (3 * r.element_size() + 4 + 4)
                   + 2 * s0.numel() * 4 + u.numel() * 4) / PEAK_BYTES_S * 1e3
        rec = dict(
            case=label, B=B, S=S, H=H, n=n, dtype=dtn, max_abs_err=err,
            rel_rms_err=rr, state_ops=ops,
            ms=timed_ms(lambda: wk.wkv6_cuda(r, k, v, w, u, s0), 30, 3),
            plain_ms=timed_ms(lambda: wk.wkv6_ref(r, k, v, w, u, s0),
                              3 if S > 1 else 30, 1),
            library_ms=None, bound_ms=max(t_ops, t_bytes),
            bound_by="operations" if t_ops >= t_bytes else "bytes",
            bound_bytes_ms=t_bytes, bound_ops_ms=t_ops)
        phase("lm-kernel", "wkv6 " + json.dumps(rec))
        if (label, dtn) == ("prefill", "bfloat16"):
            out["wkv6"] = rec
    out["wkv6"]["max_abs_err"] = max(errs)
    if breaches:
        raise AssertionError("MoE/WKV6 kernel vs plain: "
                             + "; ".join(breaches))
    return out


def serve_cross(device, arch: str, seed: int = 3) -> None:
    """``arch`` at full width, 2 layers, one 64-token prompt: bf16
    prefill logits on the card (kernels) against the CPU (plain
    versions), then 8 greedy tokens in float32, which must be equal.
    Then, in float32 on the card, the engine's batched decode over 4
    slots that hold prompts of other lengths (so other positions), 6
    requests: every token of every request must equal that request's own
    unsplit generation; for an MoE model, whose capacity drops couple the
    slots by design, the port's CPU engine on the same requests.  Raises
    on a breach."""
    import dataclasses
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.launch.serve_split import unsplit_generate
    from repro_torch.models import transformer as tfm
    from repro_torch.serving import InferenceEngine

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = dataclasses.replace(get_config(arch), num_layers=2)
    cpu_params = tfm.init_lm(cfg, torch.Generator().manual_seed(seed), "cpu")
    tok = torch.randint(0, cfg.vocab_size, (1, 64),
                        generator=torch.Generator().manual_seed(seed + 1))

    def to(tree, **kw):
        if isinstance(tree, dict):
            return {k: to(v, **kw) for k, v in tree.items()}
        if isinstance(tree, list):
            return [to(v, **kw) for v in tree]
        return tree.to(**kw)

    logits = {}
    for dev in ("cpu", device):
        p = to(cpu_params, device=dev)
        logits[str(dev)], _ = tfm.prefill(cfg, p, {"tokens": tok.to(dev)},
                                          cache_len=64)
    a = logits[str(device)].float().cpu()
    b = logits["cpu"].float()
    err = (a - b).abs().max().item()
    bf16_ok = bool(torch.allclose(a, b, atol=CROSS_ATOL, rtol=CROSS_RTOL))
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    toks, p32 = {}, {}
    for dev in ("cpu", device):
        p32[dev] = to(cpu_params, device=dev, dtype=torch.float32)
        toks[str(dev)] = unsplit_generate(cfg32, p32[dev], tok.to(dev),
                                          8)[0].cpu()
    same = bool(torch.equal(toks["cpu"], toks[str(device)]))
    p = p32[device]

    rng = np.random.default_rng(seed)
    prompts = [rng.integers(0, cfg.vocab_size, n)
               for n in rng.integers(8, 97, 6)]
    def engine_run(dev):
        eng = InferenceEngine(cfg32, p32[dev], device=dev, slots=4,
                              cache_len=128)
        rids = [eng.submit(q, max_new=8) for q in prompts]
        results = eng.run_to_completion()
        return [results[rid] for rid in rids]

    got = engine_run(device)
    if cfg.num_experts:
        want = engine_run("cpu")
    else:
        want = [unsplit_generate(cfg32, p, torch.as_tensor(
            q, device=device)[None], 8)[0][0].cpu().tolist()
            for q in prompts]
    eng_equal = sum(a == b for a, b in zip(got, want))
    phase("serve-cross", json.dumps({
        "model": cfg.name, "f32_engine_reference":
        "CPU engine" if cfg.num_experts else "one-request generation",
        "layers": 2, "prompt": 64, "bf16_logits_max_abs_err": err,
        "bf16_within_tol": bf16_ok, "f32_tokens_equal": same,
        "f32_tokens": toks["cpu"].tolist(),
        "f32_engine_prompt_lens": [len(q) for q in prompts],
        "f32_engine_requests_equal": eng_equal}))
    if not (bf16_ok and same and eng_equal == len(prompts)):
        raise AssertionError(f"serve card vs CPU, {cfg.name}: bf16 logits "
                             f"err {err:.3g}"
                             f" (tol {CROSS_ATOL}/{CROSS_RTOL}), f32 tokens "
                             f"equal: {same}; f32 engine: {eng_equal} of "
                             f"{len(prompts)} requests equal their "
                             "reference")


def kernel_counters() -> tuple:
    """Every kernel wrapper's launch count (dicts, zeroed in place)."""
    from repro_torch.kernels.flash_attention import kernel as fk
    from repro_torch.kernels.ligd_step import kernel as sk
    from repro_torch.kernels.moe_gemm import kernel as mk
    from repro_torch.kernels.rmsnorm import kernel as rk
    from repro_torch.kernels.wkv6 import kernel as wk
    return (fk.LAUNCHES, rk.LAUNCHES, sk.LAUNCHES, mk.LAUNCHES, wk.LAUNCHES)


def serve_full_width(device, arch: str, tag: str) -> dict:
    """``arch`` as get_config gives it (full width and depth, bf16),
    random weights from ``serve_split.SEED``: the Li-GD split on its
    profile (one sweep launch), split generation of 4 prompts x 1024
    tokens, 32 new, at that split and at the middle split, each equal to
    unsplit; then the engine over 16 requests of 128-1024 prompt tokens,
    32 new tokens each, 8 slots, 2048-token caches, whose first tokens
    must equal each request's own generation (later tokens are counted,
    not required: bf16 rounds differently at batch 8 and batch 1).
    Every kernel's count is zeroed just before and read just after, and
    each kernel of the family must launch a whole number of times per
    forward.  For MoE, prints the capacities both factors give at the
    batches used and requires split and unsplit decode to agree (the
    split path decodes at ``CAPACITY_FACTOR``, ``decode_step`` at
    ``DECODE_CAPACITY_FACTOR``, as in the reference).  Raises on a
    breach."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.configs.base import RWKV6
    from repro_torch.launch import serve_split
    from repro_torch.models import transformer as tfm
    from repro_torch.models.moe import capacity_for
    from repro_torch.serving import InferenceEngine, SplitServer

    cfg = get_config(arch)
    batch, prompt_len, new, slots = 4, 1024, 32, 8
    breaches = []
    caps = None
    if cfg.num_experts:
        factors = (tfm.CAPACITY_FACTOR, tfm.DECODE_CAPACITY_FACTOR)
        caps = {f"{what} T={T}": {f: capacity_for(T, cfg, f)
                                  for f in factors}
                for what, T in (("prefill", batch * prompt_len),
                                ("split/unsplit decode", batch),
                                ("engine decode", slots))}
        dec = list(caps[f"split/unsplit decode T={batch}"].values())
        if dec[0] != dec[1]:
            breaches.append(f"split and unsplit decode capacities differ "
                            f"at T={batch}: {dec}")
    t0 = time.perf_counter()
    params, tokens = serve_split.make_inputs(cfg, device=device, batch=batch,
                                             prompt_len=prompt_len)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()
    counters = kernel_counters()
    for c in counters:
        c.update(dict.fromkeys(c, 0))
    res = serve_split.run(cfg, params, tokens, new_tokens=new)
    mid = cfg.num_layers // 2
    mid_out = SplitServer(cfg, params, device=device).generate(
        tokens, mid, max_new=new)
    mid_match = bool(mid_out.cpu().tolist() == res["unsplit_tokens"])

    rng = np.random.default_rng(serve_split.SEED + 7)
    prompts = [rng.integers(0, cfg.vocab_size, n)
               for n in rng.integers(128, 1025, 16)]
    eng = InferenceEngine(cfg, params, device=device, slots=slots,
                          cache_len=2048)
    rids = [eng.submit(p, max_new=new) for p in prompts]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    results = eng.run_to_completion()
    torch.cuda.synchronize()
    engine_s = time.perf_counter() - t0
    launches = {k: v for c in counters for k, v in c.items()}
    peak_gb = torch.cuda.max_memory_allocated() / 1e9

    # one-request references (after the counts were read)
    first_ok, later_same, later_all, prefix = 0, 0, 0, 0
    for rid, p in zip(rids, prompts):
        ref, _, _ = serve_split.unsplit_generate(
            cfg, params, torch.as_tensor(p, device=device)[None], new)
        ref = ref[0].cpu().tolist()
        got = results[rid]
        first_ok += int(got[0] == ref[0])
        later_same += sum(int(a == b) for a, b in zip(got[1:], ref[1:]))
        later_all += len(ref) - 1
        prefix += next((i for i, (a, b) in enumerate(zip(got, ref))
                        if a != b), len(ref))
    rec = {k: res[k] for k in ("split", "B_hz", "r", "match", "prefill_ms",
                               "decode_ms_per_step", "split_generate_s")}
    rec.update(
        model=cfg.name, layers=cfg.num_layers, d_model=cfg.d_model,
        params_b=cfg.num_params() / 1e9, init_s=init_s, mid_split=mid,
        mid_match=mid_match,
        decode_tokens_per_s=batch / (res["decode_ms_per_step"] * 1e-3),
        engine_requests=len(results),
        engine_complete=sum(len(results[r]) == new for r in rids),
        engine_s=engine_s, engine_tokens_per_s=16 * new / engine_s,
        engine_first_token_equal=first_ok,
        engine_later_token_share_equal=later_same / later_all,
        engine_mean_equal_prefix=prefix / len(rids),
        launches=launches, peak_mem_gb=peak_gb, moe_capacities=caps)
    phase(tag, json.dumps(rec))
    if not (res["match"] and mid_match):
        breaches.append("split generation != unsplit")
    if rec["engine_complete"] != 16:
        breaches.append(f"{16 - rec['engine_complete']} requests incomplete")
    if first_ok != 16:
        breaches.append(f"{16 - first_ok} first tokens differ from one-"
                        "request generation")
    L = cfg.num_layers
    per_forward = {"rmsnorm": 2 * L + 1, "ligd_sweep": 1}
    if RWKV6 in cfg.layer_types():
        per_forward["wkv6"] = L
    else:
        per_forward["flash_attention"] = L          # prefill only
    if cfg.num_experts:
        per_forward["moe_swiglu"] = L
    for name, per in per_forward.items():
        if launches[name] <= 0 or launches[name] % per:
            breaches.append(f"{name}: {launches[name]} launches, expected a "
                            f"positive multiple of {per}")
    if breaches:
        raise AssertionError(f"{tag}: " + "; ".join(breaches))
    del params, eng
    torch.cuda.empty_cache()
    return rec


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

    # 2. build: one nvcc per source, all started together -------------
    from repro_torch.kernels.ligd_step import kernel as sweep_kernel
    from repro_torch.kernels.flash_attention import kernel as flash_kernel
    from repro_torch.kernels.rmsnorm import kernel as rms_kernel
    from repro_torch.kernels.moe_gemm import kernel as moe_kernel
    from repro_torch.kernels.wkv6 import kernel as wkv_kernel
    build_all((sweep_kernel, rms_kernel, flash_kernel, moe_kernel,
               wkv_kernel))

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

    # 6. language-model kernels against plain on the card ---------------
    lm = lm_kernel_cases(device)
    lm.update(moe_wkv_kernel_cases(device))

    # 7. serving main paths: full-width starcoder2-3b, granite-moe and
    # rwkv6-3b split generation and the continuous-batching engine -------
    serve = serve_full_width(device, "starcoder2-3b", "serve")
    serve_moe = serve_full_width(device, "granite-moe-1b-a400m", "serve-moe")
    serve_rwkv = serve_full_width(device, "rwkv6-3b", "serve-rwkv")

    # 8. serving, card against the CPU path -------------------------------
    for arch in ("starcoder2-3b", "granite-moe-1b-a400m", "rwkv6-3b"):
        serve_cross(device, arch)

    # 9. kernels line, 10. result ---------------------------------------
    src = "src/repro_torch/kernels/ligd_step/csrc/sweep.cu"
    kernels = [{
        "name": name, "route": "cuda", "source": src,
        "replaces": "src/repro/kernels/ligd_step/kernel.py:189",
        "launches": launches[name], "max_abs_err": max(errs[name]),
        "ms": r["ms"], "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
        "bound_by": r["bound_by"], "library_ms": None,
    } for name, r in recs.items()]
    paths = (serve, serve_moe, serve_rwkv)
    for name, src, replaces in (
            ("rmsnorm", "src/repro_torch/kernels/rmsnorm/csrc/rmsnorm.cu",
             "src/repro/kernels/rmsnorm/kernel.py:27"),
            ("flash_attention",
             "src/repro_torch/kernels/flash_attention/csrc/flash_attention.cu",
             "src/repro/kernels/flash_attention/kernel.py:98"),
            ("moe_swiglu",
             "src/repro_torch/kernels/moe_gemm/csrc/moe_swiglu.cu",
             "src/repro/kernels/moe_gemm/kernel.py:59"),
            ("wkv6", "src/repro_torch/kernels/wkv6/csrc/wkv6.cu",
             "src/repro/kernels/wkv6/kernel.py:66")):
        r = lm[name]
        kernels.append({
            "name": name, "route": "cuda", "source": src,
            "replaces": replaces,
            "launches": sum(pth["launches"].get(name, 0) for pth in paths),
            "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": r["library_ms"]})
    phase("done", f"{time.perf_counter() - t_start:.1f} s in all")
    print(card, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
