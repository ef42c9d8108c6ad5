#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA
card, over its main paths.

* The MCSA planner: builds the CUDA kernels from the checkout, holds both
  variants of the sweep kernel against the plain PyTorch version on the
  card, drives ``Session(get_scenario("megafleet_100k")).run()`` at full
  size, holds each variant against the plain version again on the inputs
  of its first launch there and on the serving plan's one lane
  (starcoder2-3b's 31 splits, ``max_iters`` 200), and checks the card's
  result against the CPU path.
* Admission control and the fault path: ``Session`` on
  chaos_singlefail_k3 at 100,000 users x K 3 (300,000 Li-GD rows in the
  static plan, server 2 killed at t = 30 s and back at t = 150 s),
  checked step by step (nobody on a down server, no budget exceeded,
  every user of the dead server evacuated or degraded, the recovery
  hold), its Li-GD, first MLi-GD and fault-step MLi-GD launches held
  against the plain version bit for bit; the capacitated and chaos
  presets card against CPU; every policy (the §6 baselines and MCSA) on
  megafleet_100k's 100,000 users, and on the capacitated and chaos
  presets card against CPU under tools/policy_matrix.py's invariants.
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
* Split serving of the RecurrentGemma hybrid (recurrentgemma-9b: RG-LRU
  blocks and sliding-window MQA at head_dim 256) at full width and depth,
  with prompts longer than the window so the rings wrap: holds the RG-LRU
  scan and windowed hd-256 attention against their plain versions, then
  the same split, engine and card-against-CPU checks (a 3-layer cut with a
  reduced window).
* The configurations served last, the same way at full width and depth:
  qwen3-8b (qk-norm), gemma3-27b (5 local : 1 global, 2048-token prompts
  past its 1024 window), moonshot-v1-16b-a3b (64 experts at d 2048: the
  expert SwiGLU's mma.sync decode body at d 2048),
  internvl2-1b (with a full-width prefill of 256 patch embeddings and
  768 tokens, its launches held against the plain versions) and yi-34b
  (68.8 GB of weights, last, once earlier memory is returned), each
  phase's peak memory against an estimate from ``num_params()`` and the
  k/v caches; card against CPU on 2-layer cuts of four of them
  (gemma3-27b's a local and a global block, window 32).
* ``[tools]``: the port's twins of the reference's smoke tools and
  examples (``tools/torch_{chaos_smoke,serve_smoke,policy_matrix}.py``,
  ``examples/torch_{quickstart,mobility_sim}.py``) as a user runs them on
  the card, each ending with its own line, every Session on ``cuda``.
* Kernel row 2, the single-split Li-GD steps: ``ligd_steps_grouped`` for
  the 100,000 users of ``megafleet_100k`` at their planned splits, one
  launch for all four servers' groups, and a case built so that the
  optima are interior, held against the plain version (autograd).
* The closed loop (planner -> data plane -> telemetry -> planner):
  ``serve_chaos_k3`` at its own size (500 users, K 3, server 0 down from
  t = 30 to 150 s, 800 requests) with engine pools of starcoder2-3b at
  full width and depth, through ``ServingDataPlane(engine_factory=...)``
  — zero lost requests, a mid-stream failover, every engine on the
  card; token identity of streams killed mid-decode under forced
  migration and forced re-prefill (2-layer full-width cut, float32); the
  feedback loop against the open loop on ``serve_hotspot_k3``; and both
  presets card against CPU.  In each closed-loop run on the card, every
  sweep launch is held bit for bit against the plain version, and the
  first attention and RMSNorm launch at each shape within the kernels'
  tolerances.
* The paths ported last.  ``[enc-dec]``: seamless-m4t-large-v2 at full
  width and depth (24 + 24 layers, random weights), 4 sources of 1000
  audio frames, a 16-token prompt, 32 greedy decode steps, held against
  a teacher-forced prefill, every attention (non-causal encoder, causal
  decoder, cross at prefill and decode) and RMSNorm launch shape against
  the plain versions, card against CPU on a 2 + 2-layer cut.
  ``[kv-int8]``: starcoder2-3b with the int8 KV cache, its codes and
  scales against ``quantize_kv`` on the CPU, its tokens against the bf16
  cache's.  ``[cnn-split]``: NiN, YOLOv2 and VGG16 split at every layer,
  equal to unsplit bit for bit, shipping what the planner prices, card
  against CPU at both TF32 settings, then megafleet_100k's 100,000 NiN
  users run at their planned splits.  ``[ligd-oracle]``: the autodiff
  Li-GD/MLi-GD oracle on the card against rows 1a and 1b, on the
  reference tests' fleets and on 4,096 megafleet_100k users, with every
  sweep launch held bit for bit.
* Training of the dense decoder family.  ``[train-kernels]``: rows 3
  and 4's backward kernels against float32 autograd through their plain
  versions at starcoder2-3b's, qwen3-8b's, gemma3-27b's and the qk-norm's
  shapes, and with keys that share an offset (randn + 2, randn + 4) at
  starcoder2-3b's and 32/8 heads of 128, and row 3 forward and
  backward at q offsets (S/4 query rows against all S keys), bit for
  bit from run to run,
  the training forward's output bit for bit equal to the serving
  forward's, with each case's body, times, bounds and the library
  backward's.  ``[train]``: starcoder2-3b at full width and
  depth, B 4 x S 1024, remat, 4 AdamW steps through ``make_train_step``,
  every step's launches counted (no plain version), every parameter leaf
  with a gradient, the peak memory, step time and model-flops share.
  ``[train-cross]``: a reduced float32 model card against CPU (loss,
  gradients, one update), then ``launch.train`` preempted and resumed
  against a straight run.
* The mesh, ``[mesh]``: four ranks that share card 0 (gloo process
  groups, the backend checked against the cards the ranks hold;
  FileStore rendezvous; no rank builds a kernel) run (a) the static
  plan of megafleet_100k (100,000 users, 50,000 a rank) and of
  capacitated_k3 (K 3) on a data-2 mesh against the one-process plan,
  and (b) full-width starcoder2-3b cut to 1 of its 30 layers, B 4 x S
  1024, on a data 2 x model 2 mesh (ZeRO-1) in float32 and in
  bfloat16, one AdamW step each against the one-process step from the
  same weights, and (d) every other family at its published widths,
  depth cut, one float32 step each against the one-process step
  (MESH_FAMILY_CASES: granite-moe on a data 2 mesh under the global
  capacity rule and on data 2 x model 2 with expert parallelism;
  rwkv6-3b, recurrentgemma-9b and seamless-m4t on data 2 x model 2;
  internvl2-1b with its patch prefix on model 4); (e) a prefill and
  greedy decode steps of each family on a mesh against one process;
  (g) context-parallel attention (starcoder2-3b and recurrentgemma-9b
  on model 4: one train step, prefill and decode against one
  process); (h) ``InferenceEngine`` and ``SplitServer`` on data 2 x
  model 2, every token equal to the one-process engine's on every
  rank; then (c) ``launch.train --mesh host`` under
  ``torch.distributed.run`` (2 ranks) for qwen3-8b's 100m member,
  preempted and resumed by one process
  against an unbroken run.  Ranks sharing one card show the sharded
  paths, not multi-card speed or memory.
* The dry run, ``[dryrun]``: (a) ``launch.dryrun`` counts every
  architecture x cell on both production layouts on ``meta``, in worker
  processes that never touch the card (66 counted, 14 skipped), each
  row's bottleneck, roofline step and MFU printed (derived from H100
  data-sheet rates); (b) its calibration: full-width starcoder2-3b's
  train cell at [train]'s shape and a decode cell counted on ``meta``
  and run on the card under the count (flops and bytes equal, each
  kernel launched as the count called it, no plain version, the
  tracked peak against the card's), then the step timed beside its
  roofline.

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

import contextlib
import json
import math
import re
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

#: H100 SXM peaks (NVIDIA data sheet): HBM bytes/s, and 67e12 fp32
#: FLOP/s outside the tensor cores, which counts a fused multiply-add as
#: two (128 fp32 lanes per SM per clock): ISSUE_S instructions per second,
#: an add, mul, multiply-add or compare each.  A reciprocal, exp2 or log2
#: is at least one multi-function-unit instruction (RCP, EX2, LG2), of
#: which an SM runs 16 per clock on compute capability 9.0 (CUDA C++
#: Programming Guide, arithmetic instruction throughput): MUFU_S.
PEAK_BYTES_S = 3.35e12
PEAK_FP32_S = 67e12
ISSUE_S = PEAK_FP32_S / 2
MUFU_S = PEAK_FP32_S / 16

#: kernel vs plain version on the card (the same float32 ops in the same
#: order, each rounded on its own)
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

#: the fewest operations the sweep's objective, its gradient and the GD
#: rule need, as (plain, mufu): per objective evaluation, per GD update
#: besides its evaluation, and per split's set-up, whatever body computes
#: them.  A plain op is an add, mul, multiply-add, compare or clamp side;
#: a mufu op is a reciprocal, exp2 or log2, and counts one instruction
#: against ISSUE_S besides its one against MUFU_S.  U1 needs 3 log2
#: (r, 1 + q/B, B/B0), 2 exp2 (r^-a, g(B)) and the reciprocals of B, r,
#: 1 + q/B and L (1/τ = (1/B)(1/L)), and 26 plain ops; the joint variant
#: adds U2 (2 log2, 1 exp2, the reciprocals of B_back, 1 + q/B_back and
#: L_back, 19 plain) and 6 to combine them.  One reciprocal serves all n
#: of an evaluation's quotients (their product stays far inside float
#: range: B, B_back <= 2e7, r <= 32, the rest <= ~30): n - 1 products
#: build P, R = 1/P, and each 1/x_i comes from R and a prefix product at
#: 2 multiplies apiece, 3(n - 1) plain ops in all — U1 (n = 4) 26 + 9
#: plain and 3 + 2 + 1 mufu, the joint variant (n = 7) 51 + 18 plain and
#: 5 + 3 + 1 mufu.  Lane constants (1/c_dev, 1/k, 1/B0, U2's) are set up
#: once a lane and not counted
OPS = {
    "ligd_sweep": {"eval": (35, 6), "update": (18, 0), "split": (13, 0)},
    "mligd_sweep": {"eval": (69, 9), "update": (30, 0), "split": (13, 0)},
}

#: the same count for kernel row 2 (the single-split steps), whatever
#: body computes them: per GD step, for the final utility and for each
#: row's set-up.  One reciprocal serves every quotient: R = 1/P with
#: P = B·L·(B + q) (a product far inside float range here) gives 1/τ =
#: 1/(B·L) = (B + q)·R, 1/B = L·(1/τ) and 1/(B + q) = B·L·R.  A step: B
#: and r (2 multiply-adds); B + q (1); log2 B, log2(B + q) and log2 r;
#: L = log2(B + q) - log2 B (1); (B/B0)^γ = exp2(γ·log2 B - γ·log2 B0)
#: (1); r^(-a-1) = exp2((-a-1)·log2 r) (1); B·L and P (2), R; 1/τ, 1/B
#: and 1/(B + q) (3); dτ/dB = L - (q/ln2)·1/(B + q) (1); dU/dB's three
#: terms, cT/B², cE·dτ/τ² and cC·γ·(B/B0)^γ/B (7); dU/dr (1); two updates
#: and their clamps (6): 26 plain, 6 mufu (1 reciprocal, 3 log2, 2 exp2).
#: The final utility: B, r, B + q, L, the two exp2 arguments, B·L, then
#: 1/τ = 1/(B·L) (a reciprocal) and 1/B = L·(1/τ), and U as five
#: multiply-adds on its x-independent part: 13 plain, 6 mufu (1
#: reciprocal, 3 log2, 2 exp2).  A row's set-up: 1/k and 1/c_dev from
#: one reciprocal of k·c_dev (3 plain, 1 mufu), q and q/ln2, w + m, the
#: coefficients of U and of the gradient and U's x-independent part (25
#: plain); a group's constants (spans, 1/B0, log2 B0, 1/N0, 1/c_min,
#: 1/B_backhaul) are counted nowhere.  csrc/steps.cu's body issues 8
#: mufu a step (3 reciprocals), so this bound is below its own MUFU floor
STEPS_OPS = {"step": (26, 6), "final": (13, 6), "setup": (28, 1)}
#: ligd_steps, kernel vs plain version (autograd) on the card: the
#: reference test's tolerances, x atol 1e-5 and U atol 1e-5 / rtol 1e-4
#: (tests/test_kernels.py; the closed-form gradient against autograd)
STEPS_X_ATOL, STEPS_U_ATOL, STEPS_U_RTOL = 1e-5, 1e-5, 1e-4
#: RG-LRU scan vs plain version: 1e-5 as atol = rtol, the reference
#: kernel tests' figure (the same float32 recurrence; the kernel fuses
#: a·h + b into one FMA)
RGLRU_TOL = 1e-5

#: the backward kernels (rows 3 and 4) against float32 autograd through
#: their plain versions on the float32 upcasts of the same inputs (and
#: the same output gradient): elementwise ``allclose`` with rtol = tol and
#: atol = tol x max|want| (a gradient's size varies across a tensor: dK,
#: dV and dw are sums over many rows, and a sum that cancels is small
#: beside its terms), and the error's RMS over want's RMS within rms_tol.
#: float32: the same float32 arithmetic summed in another order (dK over
#: up to S x Hq/Hkv rows, dw over every row): tol 1e-4, rms 1e-5.
#: bfloat16: the kernel rounds each float32 gradient to bf16 once (an RMS
#: of 2^-9/sqrt(3) = 1.1e-3 of the value), and its tensor-core products
#: take P and dS in bf16 (dS as hi + lo in dQ) with D from the float32
#: output (out + out_lo): tol 1e-2, rms 4e-3.  Set before the first card
#: reading of the first backward kernel, unchanged since
GRAD_TOL = {"float32": 1e-4, "bfloat16": 1e-2}
GRAD_RMS_TOL = {"float32": 1e-5, "bfloat16": 4e-3}


def phase(name: str, msg: str) -> None:
    print(f"[{name}] {msg}", flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def timed_ms(fn, runs: int, warmup: int) -> float:
    """Median per-call time over ``runs`` calls (CUDA events), the host's
    enqueue included: where a call's host cost exceeds its device time,
    the card idles inside the events and the time is the host's, as a
    host-bound caller (decode) sees it."""
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


#: GPU clock cycles of the sleep kernel that ``device_ms`` queues ahead of
#: each timed call (~0.1 ms at the H100's clock): longer than the host
#: takes to enqueue one call of a kernel wrapper
SLEEP_CYCLES_PER_RUN = 200_000


def device_ms(fn, runs: int, warmup: int) -> float:
    """Median per-call device time over ``runs`` calls (CUDA events): the
    calls queue behind a sleep kernel, so the events bracket the device's
    work and not the host's enqueue.  (A call whose host time outlasts
    the sleep still has part of its host time inside.)"""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    starts = [torch.cuda.Event(enable_timing=True) for _ in range(runs)]
    ends = [torch.cuda.Event(enable_timing=True) for _ in range(runs)]
    torch.cuda._sleep(runs * SLEEP_CYCLES_PER_RUN)
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


def record_sweep_launches(ops_mod) -> tuple:
    """Spy on the sweep wrapper that ``ops_mod`` launches: keep a copy of
    the inputs and arguments of every launch, then launch as before (the
    wrapper still counts each launch once).  For the closed loop's small
    worlds, whose launches are few and narrow.  Returns (the list of
    records, a function that removes the spy)."""
    seen = []
    launch = ops_mod.sweep_cuda

    def spy(feat, x0, tables, **kw):
        if feat.shape[-1]:                  # X = 0 launches nothing
            seen.append((feat.clone(), x0.clone(), tables.clone(), kw))
        return launch(feat, x0, tables, **kw)

    ops_mod.sweep_cuda = spy
    return seen, lambda: setattr(ops_mod, "sweep_cuda", launch)


def hold_sweep_launches(seen: list, tag: str) -> dict:
    """Each recorded sweep launch against the plain version on the same
    card inputs, bit for bit (as ``[admission]`` holds its launches).
    Returns {kernel: {"launches": n, "rows": [X, ...], "max_abs_err":
    x}}; raises on a breach."""
    from repro_torch.kernels.ligd_step import (ligd_sweep_ref,
                                               mligd_sweep_ref, sweep_cuda)
    out = {}
    for i, (feat, x0, tab, kw) in enumerate(seen):
        kw = dict(kw)
        joint = kw.pop("joint")
        name = "mligd_sweep" if joint else "ligd_sweep"
        ref = mligd_sweep_ref if joint else ligd_sweep_ref
        err, breaches = sweep_errors(
            sweep_cuda(feat, x0, tab, joint=joint, **kw),
            ref(feat, x0, tab, chunk=1, **kw))
        rec = out.setdefault(name, {"launches": 0, "rows": [],
                                    "max_abs_err": 0.0})
        rec["launches"] += 1
        rec["rows"].append(int(feat.shape[1]))
        rec["max_abs_err"] = max(rec["max_abs_err"], err["max_abs_err"])
        what = f"{tag}: {name} launch {i} (X={feat.shape[1]})"
        if breaches:
            raise AssertionError(f"{what}: " + "; ".join(breaches))
        bit_for_bit(err, what)
    return out


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


def sweep_errors(kernel_out, plain_out) -> tuple:
    """Kernel outputs (u, xB, xr, iters, best) against the plain version's
    (u, x, iters, best_s, best_x, best_u) on the same inputs: (errors,
    list of breaches of U_RTOL, X_ATOL, ITERS_SHARE and NEAR_TIE_RTOL)."""
    import torch
    u_k, xB_k, xr_k, it_k, best_k = kernel_out
    u_p, x_p, it_p, bs_p, bx_p, bu_p = plain_out
    K = len(bx_p)
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
    err = dict(u_rel=rel_u, best_u_rel=rel_bu, x_abs=err_x,
               iters_lanes_differ=lanes_it, iters_max_diff=max_dit,
               split_diff=int(split_diff.sum().item()),
               split_diff_outside_near_ties=split_bad,
               near_tie_lanes=int(near_tie.sum().item()),
               max_abs_err=max(abs_u, err_x))
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
    return err, breaches


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
    out_k = run_k()
    out_p = run_p()
    torch.cuda.synchronize()
    err, breaches = sweep_errors(out_k, out_p)
    it_p = out_p[2]

    ms = timed_ms(run_k, runs=30, warmup=3)
    plain_ms = timed_ms(run_p, runs=3, warmup=1)
    M1 = tab.shape[0]
    b_ms, b_by = bound_ms(name, X, M1, K, it_p)
    rec = dict(X=X, M1=M1, **err, ms=ms, device_ms=device_ms(run_k, 30, 3),
               plain_ms=plain_ms,
               mean_iters_per_split=float(it_p.mean().item()),
               bound_ms=b_ms, bound_by=b_by)
    phase("kernel", f"{name} {label} " + json.dumps(rec))
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


def kernel_label(mangled: str) -> str:
    """``flash_attention_tc_kernel<128>``, ``rmsnorm_kernel<bf16,32,12>``
    or ``gate_up_kernel`` from a mangled kernel name (the identifier
    before its template arguments or parameters, found by its length
    prefix, which may follow other digits; then the type and the integer
    template arguments)."""
    import re
    found = re.search(r"_kernel([IE])", mangled)
    if not found:
        return mangled
    end = found.start() + len("_kernel")
    name = mangled
    for start in range(end - 1, 0, -1):
        digits = re.search(r"(\d+)$", mangled[:start])
        if digits and any(int(digits.group(1)[-k:]) == end - start
                          for k in range(1, len(digits.group(1)) + 1)):
            name = mangled[start:end]
            break
    if found.group(1) == "E":
        return name
    args = mangled[end + 1:]
    kind = ["bf16"] if args.startswith("13__nv_bfloat16") else \
        ["f32"] if args.startswith("f") else []
    return name + "<" + ",".join(kind + re.findall(r"Li(\d+)E", args)) + ">"


def by_kernel(fn, calls: int = 5) -> dict:
    """Device microseconds a call, by CUDA kernel name, over ``calls``
    calls of ``fn`` (``torch.profiler``, CUDA activity; template
    arguments and the anonymous namespace dropped from the names)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    out = {}
    for ev in prof.key_averages():
        us = getattr(ev, "device_time_total", None)
        if us is None:
            us = getattr(ev, "cuda_time_total", 0.0)
        if us and us > 0:
            name = ev.key.replace("(anonymous namespace)::", "")
            name = name.split("(")[0].removeprefix("void ")
            out[name] = out.get(name, 0.0) + us / calls
    return out


def ptxas_instances(log: str) -> list:
    """Per kernel instance in an ``nvcc -Xptxas -v`` log: its readable
    name (template arguments in <>), registers, spill bytes (stores +
    loads), static shared memory, and whether ptxas serialized its wgmma
    instructions (warning C7511)."""
    import re
    out, cur = [], None
    serialized = set(re.findall(r"C7511\).*?function '(\S+?)'", log))
    for ln in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", ln)
        if m:
            cur = dict(name=kernel_label(m.group(1)), registers=None,
                       spill_bytes=0, smem_bytes=0,
                       wgmma_serialized=m.group(1) in serialized)
            out.append(cur)
            continue
        if cur is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      ln)
        if m:
            cur["spill_bytes"] = int(m.group(1)) + int(m.group(2))
        m = re.search(r"Used (\d+) registers", ln)
        if m:
            cur["registers"] = int(m.group(1))
            s = re.search(r"(\d+) bytes smem", ln)
            cur["smem_bytes"] = int(s.group(1)) if s else 0
    return out


def build_all(modules, no_spill) -> None:
    """Build every kernel library at once (one nvcc each, in threads) and
    print each build's ptxas register and spill lines.  ``no_spill`` maps
    a library's name to the name prefixes of its instances that must not
    spill (``None``: all of them): those are printed one by one with
    their registers, spill bytes and shared memory (static from ptxas;
    the dynamic allocation of the attention body and of the MoE wgmma
    kernels from their libraries), and a spill in any of them fails."""
    from concurrent.futures import ThreadPoolExecutor
    from repro_torch.kernels import _build
    from repro_torch.kernels.flash_attention import backward as fb
    from repro_torch.kernels.flash_attention import kernel as fk
    from repro_torch.kernels.moe_gemm import backward as mb
    from repro_torch.kernels.moe_gemm import kernel as mk

    def one(mod):
        t0 = time.perf_counter()
        mod.library()
        return time.perf_counter() - t0

    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(modules)) as pool:
        secs = list(pool.map(one, modules))
    phase("build", f"{time.perf_counter() - t0:.2f} s for "
          f"{len(modules)} libraries in parallel")
    spills = []
    for mod, sec in zip(modules, secs):
        lib = _build.library_path(mod.LIB_NAME, mod.SOURCE, mod.FLAGS)
        log = lib.with_suffix(".log")
        text = log.read_text() if log.exists() else ""
        if mod.LIB_NAME not in no_spill:
            ptxas = [ln.strip() for ln in text.splitlines()
                     if "registers" in ln or "spill" in ln]
            phase("build", f"{mod.LIB_NAME}: {sec:.2f} s ({lib.name}) "
                  + " | ".join(ptxas))
            continue
        prefixes = no_spill[mod.LIB_NAME]
        insts = [rec for rec in ptxas_instances(text)
                 if prefixes is None or rec["name"].startswith(prefixes)]
        if not insts:
            raise AssertionError(f"{mod.LIB_NAME}: no ptxas report of "
                                 f"{prefixes} in {log}")
        for rec in insts:
            if mod is fk and rec["name"].startswith("flash_attention"):
                hd = int(rec["name"].split("<")[1].rstrip(">"))
                body = "tensor_cores" if "_tc_" in rec["name"] \
                    else "cuda_cores"
                rec["dynamic_smem_bytes"] = fk.smem_bytes(hd, body)
            if mod is fb and rec["name"].startswith(("attn_bwd_dkdv_tc",
                                                     "attn_bwd_dq_tc")):
                hd = int(rec["name"].split("<")[1].rstrip(">"))
                kind = "dkdv" if "dkdv" in rec["name"] else "dq"
                rec["dynamic_smem_bytes"] = fb.library_smem_bytes(hd, kind)
                if rec["dynamic_smem_bytes"] != fb.smem_bytes(hd, kind):
                    raise AssertionError(
                        f"{rec['name']}: the library takes "
                        f"{rec['dynamic_smem_bytes']} bytes of shared "
                        f"memory, backward.smem_bytes says "
                        f"{fb.smem_bytes(hd, kind)}")
            if mod is mk and rec["name"] in ("gate_up_kernel",
                                             "down_kernel"):
                rec["dynamic_smem_bytes"] = mk.wgmma_smem_bytes(
                    rec["name"][:-len("_kernel")])
            if mod is mb and rec["name"] in ("hidden_kernel", "dx_kernel",
                                             "dw_kernel"):
                rec["dynamic_smem_bytes"] = mb.library_wgmma_smem_bytes()
                if rec["dynamic_smem_bytes"] != mb.WGMMA_SMEM:
                    raise AssertionError(
                        f"{rec['name']}: the library takes "
                        f"{rec['dynamic_smem_bytes']} bytes of shared "
                        f"memory, backward.WGMMA_SMEM says {mb.WGMMA_SMEM}")
            if rec["spill_bytes"]:
                spills.append(f"{mod.LIB_NAME} {rec['name']}")
        phase("build", f"{mod.LIB_NAME}: {sec:.2f} s ({lib.name}) "
              + json.dumps(insts))
    if spills:
        raise AssertionError("ptxas spilled registers in: "
                             + ", ".join(spills))


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
    card at starcoder2-3b's shapes (RMSNorm also at recurrentgemma-9b's
    and the qk-norm's), with times, bounds and the one-call library
    time.  Returns, per kernel, the record of its main-path case
    (RMSNorm: 4096 prefill rows in bf16; attention: B=4, S=1024, causal,
    bf16) with ``max_abs_err`` the largest over its cases."""
    import torch
    g = torch.Generator(device=device).manual_seed(11)

    def randn(shape, dt):
        return torch.randn(shape, generator=g, device=device).to(dt)

    out, breaches = {}, []
    errs = []
    # starcoder2-3b's decode and prefill rows in both types, then
    # recurrentgemma-9b's prefill and decode rows and qwen3-8b's qk-norm
    # rows (a prefill of 4 x 1024 tokens, 32 heads of 128), then the
    # prefill rows of the configurations served last: qwen3-8b,
    # gemma3-27b (4 x 2048), yi-34b, moonshot-v1-16b-a3b, internvl2-1b
    for rows, d, dtn in ((8, 3072, "bfloat16"), (8, 3072, "float32"),
                         (4096, 3072, "bfloat16"), (4096, 3072, "float32"),
                         (10240, 4096, "bfloat16"), (4, 4096, "bfloat16"),
                         (131072, 128, "bfloat16"),
                         (4096, 4096, "bfloat16"), (8192, 5376, "bfloat16"),
                         (4096, 7168, "bfloat16"), (4096, 2048, "bfloat16"),
                         (4096, 896, "bfloat16")):
        rec = rmsnorm_case(randn, rows, d, dtn, breaches)
        errs.append(rec["max_abs_err"])
        if (rows, d, dtn) == (4096, 3072, "bfloat16"):
            out["rmsnorm"] = rec
    out["rmsnorm"]["max_abs_err"] = max(errs)

    sc2, granite = (24, 2, 128), (16, 8, 64)      # (Hq, Hkv, hd)
    errs = []
    for B, S, causal, window, dtn, heads in (
            # the closed loop's prefills: a 6-token prompt, and a retry or
            # re-prefill's context of up to 11, below one 64-key tile
            (1, 6, True, 0, "bfloat16", sc2),
            (1, 11, True, 0, "bfloat16", sc2),
            (1, 11, True, 0, "float32", sc2),
            (1, 2048, True, 0, "bfloat16", sc2),
            (4, 1024, True, 0, "bfloat16", sc2),
            (1, 512, True, 128, "bfloat16", sc2),
            (1, 512, False, 0, "bfloat16", sc2),
            (1, 2048, True, 0, "float32", sc2),
            (4, 1024, True, 0, "bfloat16", granite),
            # the configurations served last: GQA ratios 4 (qwen3-8b) and
            # 7 (yi-34b, internvl2-1b), gemma3-27b's local layers past
            # their 1024 window
            (4, 1024, True, 0, "bfloat16", (32, 8, 128)),
            (4, 1024, True, 0, "bfloat16", (56, 8, 128)),
            (4, 1024, True, 0, "bfloat16", (14, 2, 64)),
            (4, 2048, True, 1024, "bfloat16", (32, 16, 128))):
        rec = attention_case(device, randn, B, S, causal, window, dtn,
                             heads, breaches)
        errs.append(rec["max_abs_err"])
        if (B, S, window, heads) == (4, 1024, 0, sc2):
            out["flash_attention"] = rec
        elif (B, S, dtn) == (1, 6, "bfloat16"):
            out["flash_attention_s6"] = rec
        elif heads == granite:
            out["flash_attention_hd64"] = rec
    out["flash_attention"]["max_abs_err"] = max(errs)
    if breaches:
        raise AssertionError("LM kernel vs plain: " + "; ".join(breaches))
    return out


def rmsnorm_case(randn, rows: int, d: int, dtn: str, breaches) -> dict:
    """RMSNorm against its plain version on the card at one shape (eps
    1e-6), with its time, the plain version's, ``F.rms_norm``'s and the
    bound; a breach is appended to ``breaches``.  Returns the record."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import rmsnorm as rn
    from repro_torch.kernels.rmsnorm import kernel as rk
    eps = 1e-6
    dt = getattr(torch, dtn)
    x, w = randn((rows, d), dt), randn((d,), dt)
    got = rn.rmsnorm_cuda(x, w, eps).float()
    want = rn.rmsnorm_ref(x, w, eps).float()
    err = (got - want).abs().max().item()
    tol = RMS_TOL[dtn]
    if not torch.allclose(got, want, atol=tol, rtol=tol):
        breaches.append(f"rmsnorm {rows}x{d} {dtn}: {err:.3g}")
    w1 = (1.0 + w.float()).to(dt)
    nbytes = (2 * rows * d + d) * x.element_size()
    tpr, vecs = rk.launch_shape(d, x.element_size(), rows)
    rec = dict(
        rows=rows, d=d, dtype=dtn, max_abs_err=err,
        body=f"one pass, {tpr} threads x {vecs} vectors a row",
        ms=timed_ms(lambda: rn.rmsnorm_cuda(x, w, eps), 30, 3),
        device_ms=device_ms(lambda: rn.rmsnorm_cuda(x, w, eps), 30, 3),
        plain_ms=timed_ms(lambda: rn.rmsnorm_ref(x, w, eps), 30, 3),
        library_ms=timed_ms(lambda: F.rms_norm(x, (d,), w1, eps), 30, 3),
        library_device_ms=device_ms(
            lambda: F.rms_norm(x, (d,), w1, eps), 30, 3),
        bound_ms=nbytes / PEAK_BYTES_S * 1e3, bound_by="bytes")
    rec["device_tb_per_s"] = nbytes / (rec["device_ms"] * 1e-3) / 1e12
    phase("lm-kernel", "rmsnorm " + json.dumps(rec))
    return rec


def attention_case(device, randn, B, S, causal, window, dtn, heads,
                   breaches, Skv=None) -> dict:
    """Flash attention against its plain version on the card at one shape
    (``heads`` = (Hq, Hkv, hd); ``Skv`` keys, default S, for a
    non-causal case), with its time, the plain version's, the library
    call's (SDPA with ``enable_gqa``; a windowed case passes the boolean
    window mask) and the bound; a breach is appended to ``breaches``.
    Returns the record."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels.flash_attention import kernel as fk
    Hq, Hkv, hd = heads
    Skv = S if Skv is None else Skv
    dt = getattr(torch, dtn)
    q = randn((B, S, Hq, hd), dt)
    k, v = randn((B, Skv, Hkv, hd), dt), randn((B, Skv, Hkv, hd), dt)
    kw = dict(causal=causal, window=window)
    body = fk.body_for(dt, hd)
    before = dict(fk.LAUNCHES)
    got = fa.flash_attention_cuda(q, k, v, **kw).float()
    # bf16 must run the tensor-core body, f32 the CUDA-core one: the
    # expectation follows the dtype alone, not the wrapper's choice
    runs = {n: fk.LAUNCHES[n] - before[n] for n in before}
    if runs != {"flash_attention": 1,
                "flash_attention_tc": int(dt == torch.bfloat16)}:
        breaches.append(f"attention {dtn} hd {hd}: launches {runs} for "
                        "one call")
    want = fa.attention_ref(q, k, v, **kw).float()
    err = (got - want).abs().max().item()
    rr = rel_rms(got, want)
    tol, rms_tol = ATTN_TOL[dtn], ATTN_RMS_TOL[dtn]
    if not (torch.allclose(got, want, atol=tol, rtol=tol)
            and rr <= rms_tol):
        breaches.append(f"attention B={B} S={S} Skv={Skv} heads={heads} "
                        f"{kw} {dtn}: "
                        f"max {err:.3g} (tol {tol}), error RMS / output "
                        f"RMS {rr:.3g} (tol {rms_tol})")
    del got, want
    qh, kh, vh = (t.transpose(1, 2) for t in (q, k, v))
    mask = None
    if window:
        i = torch.arange(S, device=device)
        mask = (i[:, None] >= i[None, :]) & (i[:, None] - i[None, :]
                                              < window)

    def library():
        return F.scaled_dot_product_attention(
            qh, kh, vh, attn_mask=mask, is_causal=causal and mask is None,
            enable_gqa=True)

    try:
        lib_ms = timed_ms(library, 30, 3)
        lib_device_ms = device_ms(library, 30, 3)
    except TypeError:        # a PyTorch without enable_gqa
        lib_ms = lib_device_ms = None
    pairs = (attention_pairs(S, causal, window) if Skv == S
             else S * Skv)                  # non-causal, no window
    flops = 4.0 * B * Hq * hd * pairs
    t_ops = flops / PEAK_BF16_S * 1e3
    t_bytes = (2 * q.numel() + 2 * k.numel()) * q.element_size() \
        / PEAK_BYTES_S * 1e3
    rec = dict(
        B=B, S=S, Skv=Skv, Hq=Hq, Hkv=Hkv, hd=hd, causal=causal,
        window=window,
        dtype=dtn, body=body, max_abs_err=err, rel_rms_err=rr,
        ms=timed_ms(lambda: fa.flash_attention_cuda(q, k, v, **kw), 30, 3),
        device_ms=device_ms(lambda: fa.flash_attention_cuda(q, k, v, **kw),
                            30, 3),
        plain_ms=timed_ms(lambda: fa.attention_ref(q, k, v, **kw), 5, 1),
        library_ms=lib_ms, library_device_ms=lib_device_ms, flops=flops,
        bound_ms=max(t_ops, t_bytes),
        bound_by="operations" if t_ops >= t_bytes else "bytes")
    rec["device_tflop_per_s"] = flops / (rec["device_ms"] * 1e-3) / 1e12
    phase("lm-kernel", "flash_attention " + json.dumps(rec))
    return rec


def hybrid_kernel_cases(device) -> dict:
    """recurrentgemma-9b's kernels against their plain versions on the
    card: the RG-LRU scan at its prefill shape (B 4, S 2560, C 4096,
    float32) and at a ragged S and C; flash attention at its local layers'
    prefill shape (B 4, S 2560, 16 query heads and 1 KV head of 256,
    window 2048) in bfloat16 and float32.  Returns the records of the
    main-path cases (``rglru_scan``: the prefill shape;
    ``flash_attention_hd256``: bfloat16), ``max_abs_err`` the largest
    over each kernel's cases."""
    import torch
    from repro_torch.kernels import rglru as rg
    g = torch.Generator(device=device).manual_seed(17)

    def randn(shape, dt):
        return torch.randn(shape, generator=g, device=device).to(dt)

    out, breaches, errs = {}, [], []
    for B, S, C in ((4, 2560, 4096), (2, 777, 4000)):
        a = torch.rand((B, S, C), generator=g, device=device) * 0.5 + 0.499
        b = torch.randn((B, S, C), generator=g, device=device) * 0.3
        got = rg.rglru_scan_cuda(a, b)
        want = rg.rglru_scan_ref(a, b)
        err = (got - want).abs().max().item()
        errs.append(err)
        if not torch.allclose(got, want, atol=RGLRU_TOL, rtol=RGLRU_TOL):
            breaches.append(f"rglru_scan B={B} S={S} C={C}: max {err:.3g} "
                            f"(tol {RGLRU_TOL})")
        del got, want
        n = B * S * C
        t_bytes = 12.0 * n / PEAK_BYTES_S * 1e3
        t_ops = 2.0 * n / PEAK_FP32_S * 1e3
        rec = dict(
            B=B, S=S, C=C, dtype="float32", max_abs_err=err,
            ms=timed_ms(lambda: rg.rglru_scan_cuda(a, b), 30, 3),
            device_ms=device_ms(lambda: rg.rglru_scan_cuda(a, b), 30, 3),
            plain_ms=timed_ms(lambda: rg.rglru_scan_ref(a, b), 3, 1),
            library_ms=None, library_call="none: no PyTorch call computes "
            "a linear recurrence", bound_ms=max(t_bytes, t_ops),
            bound_by="bytes" if t_bytes >= t_ops else "operations")
        phase("lm-kernel", "rglru_scan " + json.dumps(rec))
        out.setdefault("rglru_scan", rec)
    out["rglru_scan"]["max_abs_err"] = max(errs)
    errs = []
    for dtn in ("bfloat16", "float32"):
        rec = attention_case(device, randn, 4, 2560, True, 2048, dtn,
                             (16, 1, 256), breaches)
        errs.append(rec["max_abs_err"])
        out.setdefault("flash_attention_hd256", rec)
    out["flash_attention_hd256"]["max_abs_err"] = max(errs)
    if breaches:
        raise AssertionError("hybrid kernels vs plain: "
                             + "; ".join(breaches))
    return out


def steps_groups(sess, device) -> tuple:
    """Kernel row 2's inputs on the planner's own users: the
    ``megafleet_100k`` session's users at their planned splits and
    servers (features from its devices, the hops from each user's access
    point to its server), x0 = 0.5, rows grouped by server.  Returns
    (feat (X, NF), x0 (X, 2), offsets (G + 1 ints), edges (G dicts of
    floats))."""
    import numpy as np
    import torch
    from repro_torch.core.costs import device_columns, edge_dict, \
        rows_to_device
    from repro_torch.kernels.ligd_step import pack_features
    prof, topo, fleet = sess.profile, sess.topo, sess.fleet
    f_l, f_e, w = prof.prefix_tables()
    srv = np.asarray(fleet.server)
    order = np.argsort(srv, kind="stable")
    s, srv = np.asarray(fleet.split)[order], srv[order]
    X = len(s)
    aps = topo.nearest_ap(sess.mobility.positions())[order]
    cols = {k: v[order] for k, v in device_columns(sess.devices).items()}
    dev = rows_to_device(dict(cols, hops=topo.hops[aps, srv].astype(
        np.float64)), device, X)

    def col(v):
        return torch.as_tensor(np.asarray(v, np.float32), device=device)

    feat = pack_features(col(f_l[s]), col(f_e[s]), col(w[s]),
                         col(np.full(X, prof.result_bits)),
                         col(f_e[s] > 0), dev)
    servers = np.unique(srv)
    offsets = [0] + np.searchsorted(srv, servers, side="right").tolist()
    edges = [{k: float(v) for k, v in
              edge_dict(topo.edges[int(z)], "cpu").items()}
             for z in servers]
    x0 = torch.full((X, 2), 0.5, dtype=torch.float32, device=device)
    return feat, x0, offsets, edges


def steps_errors(x, u, xr, ur, feat, x0) -> dict:
    """Kernel (x, u) against the plain version (xr, ur): max errors over
    all lanes and over the interior lanes alone (of the plain version),
    the interior share, how far the plain version moved x from x0 (a
    lane that barely moves checks little of the gradient) and whether the
    reference test's tolerances hold on every lane."""
    import torch
    from repro_torch.kernels.ligd_step import interior_lanes
    inner = interior_lanes(xr, feat)
    dx = (x - xr).abs().amax(1)
    du = (u - ur).abs()
    rel = du / ur.abs().clamp_min(1e-30)

    def top(v, mask=None):
        v = v if mask is None else v[mask]
        return v.max().item() if v.numel() else 0.0

    ok = bool(torch.allclose(x, xr, atol=STEPS_X_ATOL, rtol=0)
              and torch.allclose(u, ur, atol=STEPS_U_ATOL,
                                 rtol=STEPS_U_RTOL))
    return dict(
        interior_share=inner.float().mean().item(),
        x_moved_max=top((xr - x0).abs().amax(1)),
        x_max_abs_err=top(dx), u_max_abs_err=top(du),
        u_max_rel_err=top(rel), interior_x_max_abs_err=top(dx, inner),
        interior_u_max_abs_err=top(du, inner),
        interior_u_max_rel_err=top(rel, inner), within_tolerance=ok)


def steps_bound_ms(X: int, iters: int) -> tuple:
    """Least time the card could take for ``iters`` steps of X rows: the
    larger of the bytes (feat, x0 read once; x, U written once) over
    PEAK_BYTES_S and the operations of STEPS_OPS over the issue and MUFU
    rates.  Returns (ms, "bytes" or "operations")."""
    count = {"step": iters * X, "final": X, "setup": X}
    plain = sum(n * STEPS_OPS[k][0] for k, n in count.items())
    mufu = sum(n * STEPS_OPS[k][1] for k, n in count.items())
    t_ops = max((plain + mufu) / ISSUE_S, mufu / MUFU_S) * 1e3
    t_bytes = 4.0 * X * (16 + 2 + 2 + 1) / PEAK_BYTES_S * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def steps_case(sess, device) -> dict:
    """Kernel row 2 on the planner's own users (:func:`steps_groups`), 64
    steps, through ``ligd_steps_grouped``: one launch for every server's
    group, counted from zero over that pass.  Then the rows are held
    against the plain version (autograd) on the same card inputs, on
    every lane and on the lanes that end interior; the smallest group
    goes through ``ligd_steps`` alone and must equal its rows of the
    pass; a second case, built so that the optima are interior
    (``ref.steps_interior_case``, 100,000 users of 4 servers), is held
    the same way.  The pass is timed as a whole, and the largest and the
    smallest group's launch alone.  Returns the record; raises on a
    breach."""
    import torch
    from repro_torch.kernels.ligd_step import (edge_tuple_of, ligd_steps,
                                               ligd_steps_cuda,
                                               ligd_steps_grouped,
                                               ligd_steps_grouped_cuda,
                                               ligd_steps_grouped_ref,
                                               steps_interior_case)
    from repro_torch.kernels.ligd_step import steps as steps_kernel
    feat, x0, offsets, edges = steps_groups(sess, device)
    X = feat.shape[0]
    iters, lr = 64, 0.15
    steps_kernel.LAUNCHES["ligd_steps"] = 0
    x, u = ligd_steps_grouped(feat, x0, offsets, edges, iters=iters, lr=lr)
    torch.cuda.synchronize()
    launches = steps_kernel.LAUNCHES["ligd_steps"]
    xr, ur = ligd_steps_grouped_ref(feat, x0, offsets, edges, iters=iters,
                                    lr=lr)
    err = steps_errors(x, u, xr, ur, feat, x0)
    sizes = [b - a for a, b in zip(offsets, offsets[1:])]
    small = min(range(len(sizes)), key=sizes.__getitem__)
    big = max(range(len(sizes)), key=sizes.__getitem__)
    rows = slice(offsets[small], offsets[small + 1])
    xs, us = ligd_steps(feat[rows], x0[rows], edges[small], iters=iters,
                        lr=lr)
    alone_equal = bool(torch.equal(xs, x[rows]) and torch.equal(us, u[rows]))

    ifeat, ix0, ioffs, iedges = steps_interior_case(100_000, 4, 18, device)
    ix, iu = ligd_steps_grouped(ifeat, ix0, ioffs, iedges, iters=iters,
                                lr=lr)
    ierr = steps_errors(ix, iu, *ligd_steps_grouped_ref(
        ifeat, ix0, ioffs, iedges, iters=iters, lr=lr), ifeat, ix0)

    ets = [edge_tuple_of(e) for e in edges]

    def kernel_pass():
        ligd_steps_grouped_cuda(feat, x0, offsets, ets, iters=iters, lr=lr)

    def group_alone(j):
        a, b = offsets[j], offsets[j + 1]
        return lambda: ligd_steps_cuda(feat[a:b], x0[a:b], ets[j],
                                       iters=iters, lr=lr)

    bound, bound_by = steps_bound_ms(X, iters)
    rec = dict(
        users=X, groups=sizes, iters=iters, launches=launches, **err,
        max_abs_err=max(err["x_max_abs_err"], err["u_max_abs_err"]),
        smallest_group_alone_equal=alone_equal,
        interior_case={"users": ifeat.shape[0],
                       "groups": [b - a for a, b in zip(ioffs, ioffs[1:])],
                       **ierr},
        ms=timed_ms(kernel_pass, 30, 3),
        device_ms=device_ms(kernel_pass, 30, 3),
        plain_ms=timed_ms(lambda: ligd_steps_grouped_ref(
            feat, x0, offsets, edges, iters=iters, lr=lr), 3, 1),
        largest_group_ms=timed_ms(group_alone(big), 30, 3),
        largest_group_device_ms=device_ms(group_alone(big), 30, 3),
        smallest_group_device_ms=device_ms(group_alone(small), 30, 3),
        library_ms=None, library_call="none: no PyTorch call computes the "
        "steps", bound_ms=bound, bound_by=bound_by)
    phase("ligd-steps", json.dumps(rec))
    breaches = []
    if launches != 1:
        breaches.append(f"{launches} launches for {len(sizes)} groups, "
                        "expected 1")
    for name, e in (("megafleet_100k", err), ("interior case", ierr)):
        if not e["within_tolerance"]:
            breaches.append(
                f"{name}: x max abs {e['x_max_abs_err']:.3g} (tol "
                f"{STEPS_X_ATOL}), U max abs {e['u_max_abs_err']:.3g} / rel "
                f"{e['u_max_rel_err']:.3g} (tol {STEPS_U_ATOL} / "
                f"{STEPS_U_RTOL})")
    if ierr["interior_share"] < 0.9:
        breaches.append(f"interior case: only {ierr['interior_share']:.3f}"
                        " of lanes end interior")
    if not alone_equal:
        breaches.append("ligd_steps on the smallest group differs from its "
                        "rows of the grouped launch")
    if breaches:
        raise AssertionError("ligd_steps: " + "; ".join(breaches))
    return rec


def rel_rms(got, want) -> float:
    return ((got - want).square().mean().sqrt()
            / want.square().mean().sqrt()).item()


def rel_rms_held(got, want) -> float:
    """rel_rms, but inf where ``want`` is all zero: a gradient or a
    weight's change that did not happen holds nothing, and NaN would
    pass every ``> tol`` test."""
    return rel_rms(got, want) if bool(want.any()) else math.inf


def grad_errors(got, want, dtn: str) -> tuple:
    """One gradient of a backward kernel against its float32 reference:
    (max abs error, error RMS / reference RMS, within GRAD_TOL and
    GRAD_RMS_TOL for ``dtn``)."""
    import torch
    got, want = got.float(), want.float()
    tol = GRAD_TOL[dtn]
    err = (got - want).abs().max().item()
    rr = rel_rms(got, want)
    ok = bool(torch.allclose(got, want, rtol=tol,
                             atol=tol * want.abs().max().item()))
    return err, rr, ok and rr <= GRAD_RMS_TOL[dtn]


def body_of(launches: dict, before: dict, prefix: str) -> str:
    """The one body whose counter (``prefix`` + body) moved since
    ``before``; raises unless exactly one did."""
    moved = [k[len(prefix):] for k in launches
             if k.startswith(prefix) and launches[k] != before[k]]
    if len(moved) != 1:
        raise AssertionError(f"{prefix}*: bodies launched {moved}, "
                             "expected exactly one")
    return moved[0]


def moe_cuda_cores(x, wg, wu, wd):
    """The expert SwiGLU's CUDA-core body on bfloat16 inputs that
    ``body_for`` gives another body, launched through the library
    directly and not counted: at moonshot-v1-16b-a3b's decode it is what
    ran before the mma.sync body reached d 2048, and it is timed there
    beside that body."""
    import torch
    from repro_torch.kernels.moe_gemm import kernel as mk
    E, C, d = x.shape
    ff = wg.shape[2]
    y = torch.empty_like(x)
    lib = mk.library()
    rc = lib.mcsa_moe_swiglu_launch(
        x.data_ptr(), wg.data_ptr(), wu.data_ptr(), wd.data_ptr(),
        y.data_ptr(), None, None, E, C, d, ff, 0, mk.num_sms(x.device),
        mk.DTYPES[x.dtype], mk.BODIES["cuda_cores"],
        torch.cuda.current_stream(x.device).cuda_stream)
    if rc != 0:
        raise RuntimeError("moe_swiglu CUDA-core body: "
                           + lib.mcsa_cuda_error_string(rc).decode())
    return y


def moe_wkv_kernel_cases(device) -> dict:
    """The fused expert SwiGLU and WKV6 kernels against their plain
    versions on the card: MoE at granite-moe-1b-a400m's prefill shape
    (E 32, C 1280 = capacity_for(4096 tokens), d 1024, ff 512, bf16),
    its engine-prefill shape (C 320 = capacity_for(1024)), its engine
    decode shape (C 4 at 8 slots) and ragged cases (ff 1408, moonshot's
    width, and 1000; C 37) in float32 and bfloat16, and at
    moonshot-v1-16b-a3b's (E 64, d 2048, ff 1408) prefill (C 480) and
    decode (C 1, 4, 16) in both, where the bf16 cases also time and hold
    the CUDA-core body (``moe_cuda_cores``, the decode body there before
    the mma.sync body took d 2048); every case launched twice for the
    same bits; WKV6 at rwkv6-3b's
    prefill shape (B 4, S 1024, H 40, n 64, bf16 r/k/v) from a non-zero
    state, at a ragged S 777 with the model's decays
    (w = exp(-exp(clamp(x, -20, 10))), some exactly 0) from a state, and
    at S 1 with the state aliased as in decode.  Each case names the body
    that ran (from the per-body counters) and fails if it is not the one
    the plan should pick.  Returns, per kernel, the record of its
    main-path case (the prefill shape) with ``max_abs_err`` the largest
    over its cases, the MoE's with its bf16 moonshot decode records under
    ``decode_d2048``."""
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
    C_engine = capacity_for(1024, granite, 1.25)
    C_decode = capacity_for(8, granite, 2.0)
    moon = get_config("moonshot-v1-16b-a3b")
    mE, md, mff = moon.num_experts, moon.d_model, moon.d_ff
    moon_cases = tuple(
        (label, mE, C, md, mff, dtn,
         "cuda_cores" if dtn == "float32" else body)
        for label, C, body in (
            ("moonshot prefill", capacity_for(4 * 1024, moon, 1.25),
             "wgmma"),
            ("moonshot decode", 1, "mma"), ("moonshot decode", 4, "mma"),
            ("moonshot decode", 16, "mma"))
        for dtn in ("bfloat16", "float32"))
    errs, decode_d2048 = [], []
    for label, E_, C, d, ff_, dtn, want_body in (
            ("prefill", E, C_prefill, d, ff, "bfloat16", "wgmma"),
            ("engine prefill", E, C_engine, d, ff, "bfloat16", "wgmma"),
            ("decode", E, C_decode, d, ff, "bfloat16", "mma"),
            ("ragged", 4, 37, d, 1408, "float32", "cuda_cores"),
            ("ragged", 4, 37, d, 1408, "bfloat16", "wgmma"),
            ("ragged", 4, 37, d, 1000, "bfloat16", "wgmma"),
            *moon_cases):
        dt = getattr(torch, dtn)
        x = randn((E_, C, d)).to(dt)
        wg = randn((E_, d, ff_), d ** -0.5).to(dt)
        wu = randn((E_, d, ff_), d ** -0.5).to(dt)
        wd = randn((E_, ff_, d), ff_ ** -0.5).to(dt)
        before = dict(mg.LAUNCHES)
        got = mg.moe_swiglu_cuda(x, wg, wu, wd)
        body = body_of(mg.LAUNCHES, before, "moe_swiglu_")
        # the same bits on a second run (the ff slices sum in a fixed
        # order)
        same_bits = bool(torch.equal(got, mg.moe_swiglu_cuda(x, wg, wu, wd)))
        got = got.float()
        want = mg.moe_swiglu_ref(x, wg, wu, wd).float()
        err = (got - want).abs().max().item()
        rr = rel_rms(got, want)
        errs.append(err)
        tol, rms_tol = MOE_TOL[dtn], MOE_RMS_TOL[dtn]
        if not (torch.allclose(got, want, atol=tol, rtol=tol)
                and rr <= rms_tol):
            breaches.append(f"moe_swiglu {label} {dtn}: max {err:.3g} (tol "
                            f"{tol}), RMS ratio {rr:.3g} (tol {rms_tol})")
        if body != want_body:
            breaches.append(f"moe_swiglu {label} {dtn} C={C}: ran the "
                            f"{body} body, expected {want_body}")
        if not same_bits:
            breaches.append(f"moe_swiglu {label} {dtn} C={C}: two runs "
                            "gave other bits")
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
            case=label, E=E_, C=C, d=d, ff=ff_, dtype=dtn, body=body,
            same_bits=same_bits, max_abs_err=err, rel_rms_err=rr,
            flops=flops,
            ms=timed_ms(lambda: mg.moe_swiglu_cuda(x, wg, wu, wd), 30, 3),
            device_ms=device_ms(lambda: mg.moe_swiglu_cuda(x, wg, wu, wd),
                                30, 3),
            plain_ms=timed_ms(lambda: mg.moe_swiglu_ref(x, wg, wu, wd),
                              10, 2),
            library_ms=timed_ms(library, 30, 3),
            library_device_ms=device_ms(library, 30, 3),
            library_call="composition: 3 torch.bmm + silu (no single call)",
            bound_ms=max(t_ops, t_bytes),
            bound_by="operations" if t_ops >= t_bytes else "bytes")
        if label == "moonshot decode" and body == "mma":
            cc = moe_cuda_cores(x, wg, wu, wd).float()
            want = mg.moe_swiglu_ref(x, wg, wu, wd).float()
            rec.update(
                cuda_cores_max_abs_err=(cc - want).abs().max().item(),
                cuda_cores_ms=timed_ms(
                    lambda: moe_cuda_cores(x, wg, wu, wd), 30, 3),
                cuda_cores_device_ms=device_ms(
                    lambda: moe_cuda_cores(x, wg, wu, wd), 30, 3))
            if not (torch.allclose(cc, want, atol=tol, rtol=tol)
                    and rel_rms(cc, want) <= rms_tol):
                breaches.append(f"moe_swiglu {label} C={C}: the CUDA-core "
                                f"body breaks MOE_TOL")
            del cc, want
            decode_d2048.append({k: rec[k] for k in (
                "C", "body", "max_abs_err", "ms", "device_ms", "plain_ms",
                "library_ms", "library_device_ms", "bound_ms",
                "cuda_cores_ms", "cuda_cores_device_ms")})
        phase("lm-kernel", "moe_swiglu " + json.dumps(rec))
        if label == "prefill":
            out["moe_swiglu"] = rec
    out["moe_swiglu"]["max_abs_err"] = max(errs)
    out["moe_swiglu"]["decode_d2048"] = decode_d2048

    rwkv = get_config("rwkv6-3b")
    H, n = rwkv.rwkv_num_heads, rwkv.rwkv_head_dim
    errs = []
    for label, B, S, dtn, want_body in (
            ("prefill", 4, 1024, "bfloat16", "chunked"),
            ("prefill", 4, 1024, "float32", "chunked"),
            ("ragged, model decays", 1, 777, "bfloat16", "chunked"),
            ("decode, aliased state", 8, 1, "bfloat16", "serial")):
        dt = getattr(torch, dtn)
        r, k, v = (randn((B, S, H, n)).to(dt) for _ in range(3))
        if label.startswith("ragged"):
            # the model's decays (models/rwkv.py), log-decays spread past
            # both ends of the clamp: some w are exactly 0
            w = torch.exp(-torch.exp(torch.clamp(
                randn((B, S, H, n), 6.0) + 1.0, -20.0, 10.0)))
            if not bool((w == 0).any()):
                breaches.append("wkv6 ragged case: no w == 0 drawn")
        else:
            w = torch.rand((B, S, H, n), generator=g,
                           device=device) * 0.65 + 0.3
        u = randn((H, n), 0.5)
        s0 = randn((B, H, n, n), 0.5)
        want_y, want_s = wk.wkv6_ref(r, k, v, w, u, s0)
        before = dict(wk.LAUNCHES)
        if S == 1:
            state = s0.clone()
            got_y, got_s = wk.wkv6_cuda(r, k, v, w, u, state,
                                        state_out=state)
            if got_s.data_ptr() != state.data_ptr():
                breaches.append("wkv6 did not write the aliased state")
        else:
            got_y, got_s = wk.wkv6_cuda(r, k, v, w, u, s0)
        body = body_of(wk.LAUNCHES, before, "wkv6_")
        if body != want_body:
            breaches.append(f"wkv6 {label} S={S}: ran the {body} body, "
                            f"expected {want_body}")
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
            case=label, B=B, S=S, H=H, n=n, dtype=dtn, body=body,
            w_zero_share=(w == 0).float().mean().item(), max_abs_err=err,
            rel_rms_err=rr, state_ops=ops,
            ms=timed_ms(lambda: wk.wkv6_cuda(r, k, v, w, u, s0), 30, 3),
            device_ms=device_ms(lambda: wk.wkv6_cuda(r, k, v, w, u, s0),
                                30, 3),
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


def to_tree(tree, **kw):
    """``.to(**kw)`` on every tensor of a nested dict/list."""
    if isinstance(tree, dict):
        return {k: to_tree(v, **kw) for k, v in tree.items()}
    if isinstance(tree, list):
        return [to_tree(v, **kw) for v in tree]
    return tree.to(**kw)


def serve_cross(device, arch: str, seed: int = 3, layers: int = 2,
                window: int = 0, pattern: tuple = ()) -> None:
    """``arch`` at full width, ``layers`` layers (``window``, if given,
    replaces the sliding window, so that the prompts wrap its ring;
    ``pattern``, if given, the layer-type pattern, so that a cut keeps
    each kind of block), one
    64-token prompt: bf16 prefill logits on the card (kernels) against
    the CPU (plain versions), then 8 greedy tokens in float32, which must
    be equal.
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
    cfg = dataclasses.replace(get_config(arch), num_layers=layers)
    if window:
        cfg = dataclasses.replace(cfg, window_size=window)
    if pattern:
        cfg = dataclasses.replace(cfg, pattern=tuple(pattern))
    # drawn on the card (the host draws a full-width table ~10x slower),
    # kept on the host
    cpu_params = tfm.init_lm(cfg, torch.Generator(device).manual_seed(seed),
                             "cpu")
    tok = torch.randint(0, cfg.vocab_size, (1, 64),
                        generator=torch.Generator().manual_seed(seed + 1))
    logits = {}
    for dev in ("cpu", device):
        p = to_tree(cpu_params, device=dev)
        logits[str(dev)], _ = tfm.prefill(cfg, p, {"tokens": tok.to(dev)},
                                          cache_len=64)
    a = logits[str(device)].float().cpu()
    b = logits["cpu"].float()
    err = (a - b).abs().max().item()
    bf16_ok = bool(torch.allclose(a, b, atol=CROSS_ATOL, rtol=CROSS_RTOL))
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    toks, p32 = {}, {}
    for dev in ("cpu", device):
        p32[dev] = to_tree(cpu_params, device=dev, dtype=torch.float32)
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
        "layers": cfg.num_layers, "layer_types": cfg.layer_types(),
        "window": cfg.window_size, "prompt": 64,
        "bf16_logits_max_abs_err": err,
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


#: [admission]: chaos_singlefail_k3 at full fleet size, the preset's 200
#: compute units a server per 500 users scaled x200; server 2 is the one
#: its schedule kills at t = 30 s and brings back at t = 150 s
ADMISSION_USERS = 100_000
ADMISSION_R_CAPACITY = 40_000.0
ADMISSION_DEAD = 2
#: the policy matrix's cross-phase worlds (tools/policy_matrix.py)
MATRIX_SCENARIOS = ("capacitated_k3", "chaos_singlefail_k3")


def zero_sweep_launches(sweep_kernel) -> None:
    for k in sweep_kernel.LAUNCHES:
        sweep_kernel.LAUNCHES[k] = 0


def check_budgets_and_liveness(sess, where: str, budgets: bool = True
                               ) -> None:
    """No user offloads to a down server; with ``budgets`` (a policy
    that admits), no server's admitted r or B (the live table's
    offloading rows) exceeds its live budget."""
    import numpy as np
    fleet, topo = sess.fleet, sess.topo
    offl = fleet.split < sess.profile.num_layers
    up = topo.server_available()
    stranded = int((~up[fleet.server] & offl).sum())
    if stranded:
        raise AssertionError(f"{where}: {stranded} users offload to a "
                             "down server")
    for col, cap in ((fleet.r, topo.r_capacity), (fleet.B, topo.B_capacity)):
        if cap is None or not budgets:
            continue
        load = np.bincount(fleet.server[offl], weights=col[offl],
                           minlength=topo.num_servers)
        cap = np.asarray(cap, np.float64)
        if np.any(load > cap * (1 + 1e-9) + 1e-9):
            raise AssertionError(f"{where}: load {load.tolist()} over the "
                                 f"budget {cap.tolist()}")


def bit_for_bit(rec: dict, what: str) -> None:
    """The sweep equals its plain version exactly on this launch."""
    if rec["max_abs_err"] != 0 or rec["split_diff"] or rec["iters_max_diff"]:
        raise AssertionError(f"{what}: not bit for bit: " + json.dumps(rec))


def admission_path(sweep_kernel, sweep_ops) -> tuple:
    """[admission]: ``Session`` on chaos_singlefail_k3 at 100,000 users
    x K 3 on the card (device None), its 8 steps one by one, checking
    after each: nobody offloads to a down server, no budget is exceeded,
    the fault step's evacuated + degraded equal the users server 2
    carried, and while server 2's recovery hold lasts no evacuee lands
    on it.  Then the static plan's Li-GD launch, the first MLi-GD launch
    and the fault step's MLi-GD launch against the plain version, bit
    for bit.  Returns (launches, {label: compare_sweep record})."""
    import numpy as np
    import torch
    from repro_torch.api import Session, get_scenario
    sc = get_scenario("chaos_singlefail_k3").replace(
        num_users=ADMISSION_USERS, r_capacity=ADMISSION_R_CAPACITY)
    zero_sweep_launches(sweep_kernel)
    first, unspy = record_first_launches(sweep_ops)
    try:
        t0 = time.perf_counter()
        sess = Session(sc)                      # device=None -> the card
        torch.cuda.synchronize()
        plan_wall = time.perf_counter() - t0
    finally:
        unspy()
    if sess.device.type != "cuda":
        raise AssertionError(f"admission path ran on {sess.device}")
    check_budgets_and_liveness(sess, "admission plan")
    M = sess.profile.num_layers
    policy = sess.policy
    records = {"static plan Li-GD": first["ligd_sweep"]}
    evac = {"carried": None, "evacuated": None, "degraded": None,
            "hold_checked_evacuees": 0, "hold_after_recovery": None}
    t0 = time.perf_counter()
    for k in range(sc.steps):
        offl = sess.fleet.split < M
        carried = int((offl & (sess.fleet.server == ADMISSION_DEAD)).sum())
        seen, unspy = record_first_launches(sweep_ops)
        try:
            rep = sess.step()
        finally:
            unspy()
        if k == 0:
            records["first MLi-GD"] = seen["mligd_sweep"]
        where = f"admission step {k} (t={rep.t:g})"
        check_budgets_and_liveness(sess, where)
        ev = rep.evacuation
        if rep.faults is not None and ADMISSION_DEAD in rep.faults.server_down:
            records["fault-step MLi-GD"] = seen["mligd_sweep"]
            if len(ev.users) != carried or \
                    ev.evacuated + ev.degraded != carried:
                raise AssertionError(
                    f"{where}: server {ADMISSION_DEAD} carried {carried}, "
                    f"evacuation over {len(ev.users)}: {ev.evacuated} "
                    f"evacuated + {ev.degraded} degraded")
            evac.update(carried=carried, evacuated=ev.evacuated,
                        degraded=ev.degraded)
        if rep.faults is not None and ADMISSION_DEAD in rep.faults.server_up:
            evac["hold_after_recovery"] = int(policy._hold[ADMISSION_DEAD])
            if evac["hold_after_recovery"] != policy.recovery_hold_steps:
                raise AssertionError(f"{where}: recovery hold "
                                     f"{evac['hold_after_recovery']}")
        if ev is not None and policy._hold[ADMISSION_DEAD] > 0:
            users = ev.users[sess.fleet.split[ev.users] < M]
            if np.any(sess.fleet.server[users] == ADMISSION_DEAD):
                raise AssertionError(f"{where}: an evacuee landed on the "
                                     "held server")
            evac["hold_checked_evacuees"] += len(ev.users)
    sess.drain()
    torch.cuda.synchronize()
    steps_wall = time.perf_counter() - t0
    launches = dict(sweep_kernel.LAUNCHES)
    if not all(v > 0 for v in launches.values()):
        raise AssertionError(f"a kernel never launched: {launches}")
    if evac["carried"] is None or evac["hold_after_recovery"] is None:
        raise AssertionError(f"the scripted fault never fired: {evac}")
    check_fleet(sess.fleet, M, sess.topo.num_servers)
    m = sess.metrics()
    phase("admission", json.dumps({
        "scenario": sc.name, "users": sc.num_users, "K": sc.candidates_k,
        "r_capacity": sc.r_capacity, "steps": sc.steps,
        "static_rows": sc.num_users * sc.candidates_k,
        "plan_wall_s": plan_wall, "steps_wall_s": steps_wall,
        "timings": sess.timings, "launches": launches,
        "handoffs_per_step": m.handoffs.tolist(),
        "evacuation": evac, "admission": sess.admission,
        "faults": m.faults, "mean_T": m.mean_T.tolist()}))
    del sess
    recs = {}
    for label, (feat, x0, tab, kw) in records.items():
        name = "mligd_sweep" if kw["joint"] else "ligd_sweep"
        recs[label] = compare_sweep(name, f"{sc.name} x{ADMISSION_USERS} "
                                    f"{label}", feat, x0, tab, kw)
        bit_for_bit(recs[label], label)
    return launches, recs


def admission_cross() -> None:
    """[admission-cross]: the capacitated and chaos presets at their own
    sizes, card against CPU."""
    from repro_torch.api import Session, get_scenario
    for name in ("capacitated_k3", "chaos_singlefail_k3", "chaos_churn"):
        fleets = {}
        for dev in ("cuda", "cpu"):
            s = Session(get_scenario(name), device=dev)
            s.run()
            check_fleet(s.fleet, s.profile.num_layers, s.topo.num_servers)
            check_budgets_and_liveness(s, f"{name} on {dev}")
            fleets[dev] = s.fleet
        phase("admission-cross", f"{name} " + json.dumps(
            compare_fleets(fleets["cuda"], fleets["cpu"])))


def baselines_phase(sweep_kernel) -> dict:
    """[baselines]: every policy on megafleet_100k's 100,000 users (the
    plan and 2 steps) on the card, then the policy matrix's worlds card
    against CPU under tools/policy_matrix.py's invariants: finite,
    positive mean delay, nobody offloading to a down server, and MCSA no
    worse than the worst baseline.  Returns the sweep launches of the
    100,000-user runs (MCSA's)."""
    import numpy as np
    import torch
    from repro_torch.api import POLICIES, Session, get_scenario
    big = get_scenario("megafleet_100k").replace(steps=2)
    zero_sweep_launches(sweep_kernel)
    cells = {}
    for policy in sorted(POLICIES):
        t0 = time.perf_counter()
        s = Session(big, policy=policy)         # device=None -> the card
        m = s.run()
        torch.cuda.synchronize()
        check_fleet(s.fleet, s.profile.num_layers, s.topo.num_servers)
        cells[policy] = {"mean_T": float(m.mean_T.mean()),
                         "wall_s": time.perf_counter() - t0}
        if not (np.isfinite(cells[policy]["mean_T"])
                and cells[policy]["mean_T"] > 0):
            raise AssertionError(f"{policy}: mean delay {cells[policy]}")
    launches = dict(sweep_kernel.LAUNCHES)
    phase("baselines", f"{big.name} x{big.num_users} " + json.dumps(cells))
    for name in MATRIX_SCENARIOS:
        sc = get_scenario(name)
        cells = {}
        for policy in sorted(POLICIES):
            fleets = {}
            for dev in ("cuda", "cpu"):
                s = Session(sc, policy=policy, device=dev)
                m = s.run()
                check_fleet(s.fleet, s.profile.num_layers,
                            s.topo.num_servers)
                # the baselines admit nobody: budgets bind MCSA only
                check_budgets_and_liveness(s, f"{name}/{policy} on {dev}",
                                           budgets=policy == "mcsa")
                mean_T = float(m.mean_T.mean())
                if not (np.isfinite(mean_T) and mean_T > 0):
                    raise AssertionError(f"{name}/{policy} on {dev}: mean "
                                         f"delay {mean_T}")
                fleets[dev] = (s.fleet, mean_T)
            cross = compare_fleets(fleets["cuda"][0], fleets["cpu"][0])
            cells[policy] = {"mean_T": fleets["cuda"][1],
                             "server_differ": cross["server_differ"],
                             "split_differ": cross["split_differ"]}
        worst = max(c["mean_T"] for p, c in cells.items() if p != "mcsa")
        if cells["mcsa"]["mean_T"] > worst * (1 + 1e-6):
            raise AssertionError(f"{name}: MCSA worse than every baseline: "
                                 + json.dumps(cells))
        phase("baselines", f"{name} " + json.dumps(cells))
    return launches


def kernel_counters() -> tuple:
    """Every kernel wrapper's launch count (dicts, zeroed in place)."""
    from repro_torch.kernels.flash_attention import backward as fb
    from repro_torch.kernels.flash_attention import kernel as fk
    from repro_torch.kernels.ligd_step import kernel as sk
    from repro_torch.kernels.ligd_step import steps as tk
    from repro_torch.kernels.moe_gemm import backward as mb
    from repro_torch.kernels.moe_gemm import kernel as mk
    from repro_torch.kernels.rglru import backward as gb
    from repro_torch.kernels.rglru import kernel as gk
    from repro_torch.kernels.rmsnorm import backward as rb
    from repro_torch.kernels.rmsnorm import kernel as rk
    from repro_torch.kernels.wkv6 import backward as wb
    from repro_torch.kernels.wkv6 import kernel as wk
    return (fk.LAUNCHES, rk.LAUNCHES, sk.LAUNCHES, tk.LAUNCHES, mk.LAUNCHES,
            gk.LAUNCHES, wk.LAUNCHES, fb.LAUNCHES, rb.LAUNCHES, mb.LAUNCHES,
            gb.LAUNCHES, wb.LAUNCHES)


def kv_cache_gb(cfg, batch: int, length: int) -> float:
    """GB of bf16 k/v cache that ``batch`` sequences of ``length``
    positions hold in ``cfg``'s attention blocks: ``length`` rows a
    global block, a ring of min(window, length) a sliding-window one
    (recurrent states are left out: at most tens of MB)."""
    from repro_torch.configs.base import ATTN_GLOBAL, ATTN_LOCAL
    rows = sum(length if t == ATTN_GLOBAL
               else min(cfg.window_size, length) if t == ATTN_LOCAL else 0
               for t in cfg.layer_types())
    return 2 * batch * rows * cfg.num_kv_heads * cfg.head_dim * 2 / 1e9


#: serve_full_width's memory check: the peak may pass the estimate
#: (bf16 weights from num_params(), the engine's and the split
#: generation's k/v caches) by at most this share of it, and never by
#: less than SERVE_PEAK_FLOOR_GB: room for a prefill's activations and
#: the allocator's rounding (the largest excess read on the card is
#: recurrentgemma-9b's, 10.8 % at 4 x 2560 tokens), while the weights
#: are at least 72 % of every estimate (granite-moe-1b-a400m's), so a
#: second copy of them breaks the check in every configuration
SERVE_PEAK_SLACK = 0.15
SERVE_PEAK_FLOOR_GB = 0.5
#: internvl2-1b's full-width patch prefill: 4 sequences of 256 patch
#: embeddings (its frontend_len) and 768 tokens
VLM_BATCH = 4
VLM_TOKENS = 768


def rmsnorm_per_forward(cfg) -> int:
    """RMSNorm launches in one forward of ``cfg``: two a block and the
    final one, and 2 more an attention block with qk-norm, which
    normalises q and k (``models/transformer.py``)."""
    from repro_torch.configs.base import ATTN_GLOBAL, ATTN_LOCAL
    n_attn = sum(t in (ATTN_GLOBAL, ATTN_LOCAL) for t in cfg.layer_types())
    return 2 * cfg.num_layers + 1 + (2 * n_attn if cfg.qk_norm else 0)


def vlm_patch_prefill(cfg, params, device, counters) -> dict:
    """A VLM's prefill with its image prefix at full width: VLM_BATCH x
    (``cfg.frontend_len`` patch embeddings from ``vit_patch_embeds`` +
    VLM_TOKENS tokens) through ``prefill(..., {"tokens",
    "patch_embeds"})``, every count zeroed just before and read just
    after; then the first attention and RMSNorm launch at each shape held
    against the plain versions (``hold_lm_launches``), the logits finite
    and of shape (B, Vp), one tensor-core attention launch a layer and
    ``rmsnorm_per_forward`` RMSNorm launches.  Raises on a breach."""
    import torch
    from repro_torch.models import transformer as tfm
    from repro_torch.models.frontend import vit_patch_embeds
    gen = torch.Generator(device=device).manual_seed(11)
    patches = vit_patch_embeds(cfg, gen, VLM_BATCH, device)
    tokens = torch.randint(0, cfg.vocab_size, (VLM_BATCH, VLM_TOKENS),
                           generator=gen, device=device)
    seen, unspy = record_lm_launches()
    zero_counters(counters)
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, _ = tfm.prefill(cfg, params, {"tokens": tokens,
                                              "patch_embeds": patches},
                                cache_len=cfg.frontend_len + VLM_TOKENS)
        torch.cuda.synchronize()
        prefill_ms = (time.perf_counter() - t0) * 1e3
        launches = all_launches(counters)
    finally:
        unspy()
    held = hold_lm_launches(seen, "vlm-prefill")
    L = cfg.num_layers
    rec = {"batch": VLM_BATCH, "patches": cfg.frontend_len,
           "tokens": VLM_TOKENS, "prefill_ms": prefill_ms,
           "logits_shape": list(logits.shape),
           "logits_finite": bool(torch.isfinite(logits).all()),
           "launches": launches, "held": held}
    breaches = []
    if not rec["logits_finite"] or logits.shape[0] != VLM_BATCH:
        breaches.append(f"logits {rec['logits_shape']}, finite "
                        f"{rec['logits_finite']}")
    seq = cfg.frontend_len + VLM_TOKENS
    if [VLM_BATCH, seq, seq, cfg.num_heads, cfg.num_kv_heads,
            cfg.head_dim, 1, 0, 0] not in held["flash_attention"]["shapes"]:
        breaches.append("no attention launch over the whole image + "
                        "text sequence was held")
    for name, want in (("flash_attention", L), ("flash_attention_tc", L),
                       ("rmsnorm", rmsnorm_per_forward(cfg))):
        if launches[name] != want:
            breaches.append(f"{name}: {launches[name]} launches, expected "
                            f"{want}")
    if breaches:
        raise AssertionError("vlm-prefill: " + "; ".join(breaches))
    return rec


#: the configurations served last, in order: (arch, tag,
#: serve_full_width keywords), each after the earlier phases' memory is
#: returned (``release_memory``); gemma3-27b's 2048-token prompts pass
#: its 1024 window, and yi-34b (68.8 GB of weights) comes last.  Their
#: engine references stop at the first token (the one the engine must
#: match): 16 one-request generations of 32 tokens at 36-62 blocks would
#: take most of each phase's time
SERVED_LAST = (
    ("qwen3-8b", "serve-qwen3", {"ref_tokens": 1}),
    ("gemma3-27b", "serve-gemma3", {"prompt_len": 2048, "cache_len": 4096,
                                    "ref_tokens": 1}),
    ("moonshot-v1-16b-a3b", "serve-moonshot", {"ref_tokens": 1}),
    ("internvl2-1b", "serve-vlm", {"ref_tokens": 1}),
    ("yi-34b", "serve-yi", {"ref_tokens": 1}),
)


def serve_full_width(device, arch: str, tag: str, prompt_len: int = 1024,
                     cache_len: int = 2048, ref_tokens: int = 0) -> dict:
    """``arch`` as get_config gives it (full width and depth, bf16),
    random weights from ``serve_split.SEED``: the Li-GD split on its
    profile (one sweep launch), split generation of 4 prompts x
    ``prompt_len`` tokens, 32 new, at that split and at the middle split,
    each equal to unsplit; then the engine over 16 requests of
    128-``prompt_len`` prompt tokens, 32 new tokens each, 8 slots,
    ``cache_len``-token caches, whose first tokens
    must equal each request's own generation (later tokens are counted,
    not required: bf16 rounds differently at batch 8 and batch 1; with
    ``ref_tokens`` the one-request generations stop after that many
    tokens, and only those are compared).
    Every kernel's count is zeroed just before and read just after, and
    each kernel of the family must launch a whole number of times per
    forward (RMSNorm 2·L + 1, and 2 more an attention block with
    qk-norm, which normalises q and k).  For MoE, prints the capacities
    both factors give at the batches used and requires split and unsplit
    decode to agree (the split path decodes at ``CAPACITY_FACTOR``,
    ``decode_step`` at ``DECODE_CAPACITY_FACTOR``, as in the reference).
    Prints the free memory before the weights are drawn, the peak while
    they are and the peak while serving, which may pass the estimate
    from ``num_params()`` and the k/v caches (``kv_cache_gb``) by at most
    SERVE_PEAK_SLACK of it (SERVE_PEAK_FLOOR_GB at least).  A VLM then
    runs ``vlm_patch_prefill`` (record ``patch_prefill``, its own
    counts).  Raises on a breach."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ATTN_GLOBAL, ATTN_LOCAL, RGLRU, \
        RWKV6
    from repro_torch.launch import serve_split
    from repro_torch.models import transformer as tfm
    from repro_torch.models.moe import capacity_for
    from repro_torch.serving import InferenceEngine, SplitServer

    cfg = get_config(arch)
    batch, new, slots = 4, 32, 8
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
    t_phase = time.perf_counter()
    free_gb = torch.cuda.mem_get_info(device)[0] / 1e9
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params, tokens = serve_split.make_inputs(cfg, device=device, batch=batch,
                                             prompt_len=prompt_len)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    init_peak_gb = torch.cuda.max_memory_allocated() / 1e9
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
               for n in rng.integers(128, prompt_len + 1, 16)]
    eng = InferenceEngine(cfg, params, device=device, slots=slots,
                          cache_len=cache_len)
    rids = [eng.submit(p, max_new=new) for p in prompts]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    results = eng.run_to_completion()
    torch.cuda.synchronize()
    engine_s = time.perf_counter() - t0
    launches = {k: v for c in counters for k, v in c.items()}
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    weights_gb = cfg.num_params() * 2 / 1e9
    engine_kv_gb = kv_cache_gb(cfg, slots, cache_len)
    split_kv_gb = kv_cache_gb(cfg, batch, prompt_len + new)
    estimate_gb = weights_gb + engine_kv_gb + split_kv_gb
    slack_gb = max(SERVE_PEAK_FLOOR_GB, SERVE_PEAK_SLACK * estimate_gb)
    if peak_gb > estimate_gb + slack_gb:
        breaches.append(f"peak {peak_gb:.2f} GB, estimate {estimate_gb:.2f}"
                        f" GB + {slack_gb:.2f} GB")

    # one-request references (after the counts were read)
    ref_new = ref_tokens or new
    first_ok, later_same, later_all, prefix = 0, 0, 0, 0
    for rid, p in zip(rids, prompts):
        ref, _, _ = serve_split.unsplit_generate(
            cfg, params, torch.as_tensor(p, device=device)[None], ref_new)
        ref = ref[0].cpu().tolist()
        got = results[rid]
        first_ok += int(got[0] == ref[0])
        later_same += sum(int(a == b) for a, b in zip(got[1:], ref[1:]))
        later_all += len(ref) - 1
        prefix += next((i for i, (a, b) in enumerate(zip(got, ref))
                        if a != b), len(ref))
    L, types = cfg.num_layers, cfg.layer_types()
    n_attn = sum(t in (ATTN_GLOBAL, ATTN_LOCAL) for t in types)
    per_forward = {"rmsnorm": rmsnorm_per_forward(cfg), "ligd_sweep": 1}
    for name, n in (
            ("flash_attention", n_attn),              # prefill only
            ("rglru_scan", types.count(RGLRU)),       # prefill only
            ("wkv6", types.count(RWKV6)),
            ("moe_swiglu", L if cfg.num_experts else 0)):
        if n:
            per_forward[name] = n
    rec = {k: res[k] for k in ("split", "B_hz", "r", "match", "prefill_ms",
                               "decode_ms_per_step", "split_generate_s")}
    rec.update(
        model=cfg.name, layers=cfg.num_layers, d_model=cfg.d_model,
        params_b=cfg.num_params() / 1e9, prompt_len=prompt_len,
        window=cfg.window_size, engine_cache_len=cache_len,
        engine_prompt_lens=[len(p) for p in prompts], init_s=init_s,
        mid_split=mid, mid_match=mid_match, per_forward=per_forward,
        decode_tokens_per_s=batch / (res["decode_ms_per_step"] * 1e-3),
        engine_requests=len(results),
        engine_complete=sum(len(results[r]) == new for r in rids),
        engine_s=engine_s, engine_tokens_per_s=16 * new / engine_s,
        engine_first_token_equal=first_ok, engine_reference_tokens=ref_new,
        engine_later_token_share_equal=(later_same / later_all
                                        if later_all else None),
        engine_mean_equal_prefix=prefix / len(rids),
        launches=launches, free_before_init_gb=free_gb,
        init_peak_gb=init_peak_gb, peak_mem_gb=peak_gb,
        weights_gb=weights_gb, engine_kv_gb=engine_kv_gb,
        split_kv_gb=split_kv_gb, estimate_gb=estimate_gb,
        peak_slack_gb=slack_gb,
        moe_capacities=caps)
    if cfg.frontend == "vit":
        rec["patch_prefill"] = vlm_patch_prefill(cfg, params, device,
                                                 kernel_counters())
    rec["phase_s"] = time.perf_counter() - t_phase
    phase(tag, json.dumps(rec))
    if not (res["match"] and mid_match):
        breaches.append("split generation != unsplit")
    if rec["engine_complete"] != 16:
        breaches.append(f"{16 - rec['engine_complete']} requests incomplete")
    if first_ok != 16:
        breaches.append(f"{16 - first_ok} first tokens differ from one-"
                        "request generation")
    for body, why in (("moe_swiglu_wgmma", "prefill"),
                      ("moe_swiglu_mma", "decode"),
                      ("wkv6_chunked", "prefill"),
                      ("wkv6_serial", "decode")):
        family = body.rsplit("_", 1)[0]
        if family in per_forward and launches[body] <= 0:
            breaches.append(f"{family}: no {why} launch on its {body} "
                            "body")
    if launches["flash_attention_tc"] != launches["flash_attention"]:
        breaches.append(f"{launches['flash_attention']} attention launches "
                        f"in bf16 serving, {launches['flash_attention_tc']} "
                        "of them on the tensor-core body")
    for name, per in per_forward.items():
        if launches[name] <= 0 or launches[name] % per:
            breaches.append(f"{name}: {launches[name]} launches, expected a "
                            f"positive multiple of {per}")
    if breaches:
        raise AssertionError(f"{tag}: " + "; ".join(breaches))
    del params, eng
    torch.cuda.empty_cache()
    return rec


#: [tools]: the twins of the reference's smoke tools and examples as a
#: user runs them on the card (each preset at its own size; mobility_sim
#: at 100,000 users), with the line each run must end with
TOOL_RUNS = (
    ("tools/torch_chaos_smoke.py", ["--scenario", "chaos_singlefail_k3"],
     "CHAOS_SMOKE_OK"),
    ("tools/torch_chaos_smoke.py", ["--scenario", "chaos_churn"],
     "CHAOS_SMOKE_OK"),
    ("tools/torch_serve_smoke.py", [], "SERVE_SMOKE_OK"),
    ("tools/torch_serve_smoke.py", ["--adaptive"], "ADAPTIVE_SMOKE_OK"),
    ("tools/torch_policy_matrix.py", [], "POLICY_MATRIX_OK"),
    ("examples/torch_quickstart.py", [], "done."),
    ("examples/torch_mobility_sim.py", ["--users", "100000", "--minutes",
                                        "8"], "fleet mean latency:"),
)


def run_script(path: Path, argv: list) -> str:
    """What ``main()`` of the script at ``path`` (a tool or example, not a
    package module) prints when run in this process with the command line
    ``argv`` (``sys.argv`` is set, since some ``main``s read it); raises
    on an exit code other than 0 or None."""
    import importlib.util
    import io
    spec = importlib.util.spec_from_file_location(f"_script_{path.stem}",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    buf, argv0 = io.StringIO(), sys.argv
    sys.argv = [str(path), *argv]
    try:
        with contextlib.redirect_stdout(buf):
            rc = mod.main()
    finally:
        sys.argv = argv0
    if rc not in (None, 0):
        raise AssertionError(f"{path.name} {argv}: exit {rc}")
    return buf.getvalue()


def tools_phase(counters) -> dict:
    """[tools]: every run of TOOL_RUNS on the card, in this process, with
    the twins' default device (the card).  A spy on ``Session.__init__``
    notes each session's device: every run must build at least one, all
    on ``cuda``, and its output must end with its line.  Every count is
    zeroed just before the first run and read after the last; the sweep
    must have launched.  Prints each run's wall time, sessions and last
    lines.  Returns the launches."""
    import torch
    from repro_torch.api import Session
    devices = []
    init = Session.__init__

    def spy(self, *args, **kw):
        init(self, *args, **kw)
        devices.append(self.device.type)

    Session.__init__ = spy
    zero_counters(counters)
    t_all = time.perf_counter()
    try:
        for rel, argv, last in TOOL_RUNS:
            devices.clear()
            t0 = time.perf_counter()
            lines = run_script(ROOT / rel, argv).splitlines()
            torch.cuda.synchronize()
            phase("tools", json.dumps({
                "run": " ".join([rel, *argv]),
                "wall_s": time.perf_counter() - t0, "lines": len(lines),
                "sessions": len(devices),
                "session_devices": sorted(set(devices)),
                "tail": lines[-13:]}))
            if not (lines and lines[-1].startswith(last)):
                raise AssertionError(f"tools: {rel} {argv} did not end with "
                                     f"{last!r}")
            if not devices or set(devices) != {"cuda"}:
                raise AssertionError(f"tools: {rel} {argv} built sessions "
                                     f"on {devices}, expected cuda")
    finally:
        Session.__init__ = init
    launches = all_launches(counters)
    phase("tools", json.dumps({"wall_s": time.perf_counter() - t_all,
                               "launches": launches}))
    if launches["ligd_sweep"] <= 0 or launches["mligd_sweep"] <= 0:
        raise AssertionError(f"tools: the sweep never launched: {launches}")
    return launches


#: [serve-loop]: the serve_chaos_k3 world at its own size, its pools'
#: engines starcoder2-3b as get_config gives it (30 layers, d 3072, 24/2
#: heads of 128, bf16), random weights from this seed on the card
SERVE_LOOP_SEED = 0
#: card vs CPU serving summaries ([serve-loop-cross]): counts exact,
#: floats within 1e-6 relative.  A virtual time t sums per-token times
#: T·scale/max_new, and the card's and the CPU's planners agree on T to
#: ~1e-7 relative, so a difference of two times (a queue delay: a pool
#: clock minus a ready time, both ~240 s) keeps ~1e-7·t of absolute
#: error; such values are held to SERVE_HORIZON_RTOL times the run's
#: virtual horizon, absolute
SERVE_CROSS_RTOL = 1e-6
SERVE_HORIZON_RTOL = 2e-7


class FullWidthEngines:
    """Engine factory for the data plane's ``engine_factory`` seam: the
    port's ``InferenceEngine`` for ``cfg`` on ``device``, one parameter
    set (``init_lm`` from a seeded generator on the card) shared by
    every engine, a revived pool's rebuild included; ``built`` keeps
    each engine made, ``d_model`` prices the re-prefill relay (16 bits
    a unit, as the default factory's)."""

    def __init__(self, cfg, cache_len: int, device, seed: int):
        import torch
        from repro_torch.models import transformer as tfm
        self.cfg, self.cache_len, self.device = cfg, cache_len, device
        self.params = tfm.init_lm(
            cfg, torch.Generator(device=device).manual_seed(seed), device)
        self.built = []

    @property
    def d_model(self) -> int:
        return int(self.cfg.d_model)

    def __call__(self, slots: int):
        from repro_torch.serving import InferenceEngine
        eng = InferenceEngine(self.cfg, self.params, device=self.device,
                              slots=int(slots), cache_len=self.cache_len)
        self.built.append(eng)
        return eng


def serving_session(sc, factory, device):
    """``Session(sc)`` whose data plane builds its engines with
    ``factory``, through the reference's ``ServingDataPlane(...,
    engine_factory=...)`` seam: the session's default plane is replaced
    before the first step, as the reference's tests/test_dataplane.py
    does (its engines are built lazily, so nothing is thrown away).  A
    revived pool's slots come from the session's live ledger."""
    from repro_torch.api import Session
    from repro_torch.serving import ServingDataPlane
    sess = Session(sc, device=device)
    sess.dataplane = ServingDataPlane(
        sc.serving, sess.topo, num_layers=sess.profile.num_layers,
        slots=sess._serving_slots(), slots_fn=sess._serving_slots,
        engine_factory=factory)
    return sess


def record_lm_launches() -> tuple:
    """Spy on the attention and RMSNorm kernel wrappers the models
    launch through: keep a copy of the inputs of the first launch at
    each new shape (attention: B, Sq, Skv, Hq, Hkv, hd, causal, window,
    q offset),
    then launch as before (each wrapper still counts its launch once).
    Returns (records by (kernel, shape), a function that removes the
    spies)."""
    from repro_torch.kernels.flash_attention import ops as fops
    from repro_torch.kernels.rmsnorm import ops as rops
    seen = {}
    flash, rms = fops.flash_attention_cuda, rops.rmsnorm_cuda

    def flash_spy(q, k, v, **kw):
        B, Sq, Hq, hd = q.shape
        key = ("flash_attention", (B, Sq, k.shape[1], Hq, k.shape[2], hd,
                                   int(kw.get("causal", True)),
                                   kw.get("window", 0),
                                   kw.get("q_offset") or 0), q.dtype)
        if key not in seen:
            seen[key] = (q.clone(), k.clone(), v.clone(), kw)
        return flash(q, k, v, **kw)

    def rms_spy(x, w, eps):
        key = ("rmsnorm", tuple(x.shape), x.dtype)
        if key not in seen:
            seen[key] = (x.clone(), w.clone(), eps)
        return rms(x, w, eps)

    fops.flash_attention_cuda, rops.rmsnorm_cuda = flash_spy, rms_spy

    def unspy():
        fops.flash_attention_cuda, rops.rmsnorm_cuda = flash, rms
    return seen, unspy


def hold_lm_launches(seen: dict, tag: str) -> dict:
    """Each recorded launch against its plain version on the same card
    tensors, at ATTN_TOL / ATTN_RMS_TOL and RMS_TOL.  Returns
    {kernel: {"shapes": [...], "max_abs_err": x}}; raises on a breach."""
    import torch
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import rmsnorm as rn
    out, breaches = {}, []
    for (name, shape, dt), args in sorted(seen.items(),
                                          key=lambda kv: str(kv[0])):
        dtn = str(dt).replace("torch.", "")
        if name == "flash_attention":
            q, k, v, kw = args
            got = fa.flash_attention_cuda(q, k, v, **kw).float()
            want = fa.attention_ref(q, k, v, **kw).float()
            tol, rms_tol = ATTN_TOL[dtn], ATTN_RMS_TOL[dtn]
            rr = rel_rms(got, want)
            ok = (torch.allclose(got, want, atol=tol, rtol=tol)
                  and rr <= rms_tol)
        else:
            x, w, eps = args
            got = rn.rmsnorm_cuda(x, w, eps).float()
            want = rn.rmsnorm_ref(x, w, eps).float()
            tol = RMS_TOL[dtn]
            ok = bool(torch.allclose(got, want, atol=tol, rtol=tol))
        err = (got - want).abs().max().item()
        rec = out.setdefault(name, {"shapes": [], "max_abs_err": 0.0})
        rec["shapes"].append(list(shape))
        rec["max_abs_err"] = max(rec["max_abs_err"], err)
        if not ok:
            breaches.append(f"{name} {list(shape)} {dtn}: {err:.3g}")
    if breaches:
        raise AssertionError(f"{tag}: recorded launches vs plain: "
                             + "; ".join(breaches))
    return out


def record_loop_launches() -> tuple:
    """The closed loop's spies: every sweep launch
    (``record_sweep_launches``) and the first attention and RMSNorm
    launch at each shape (``record_lm_launches``).  Returns (sweep
    records, LM records, a function that removes every spy)."""
    from repro_torch.kernels.ligd_step import ops as sweep_ops
    sweeps, unspy_sweep = record_sweep_launches(sweep_ops)
    lm, unspy_lm = record_lm_launches()

    def unspy():
        unspy_sweep()
        unspy_lm()
    return sweeps, lm, unspy


def hold_loop_launches(sweeps: list, lm: dict, launches: dict,
                       tag: str) -> dict:
    """``hold_sweep_launches`` and ``hold_lm_launches`` on one run's
    records; call it after the run's counts (``launches``) were read,
    since holding launches each kernel again.  Raises unless every sweep
    launch the counts saw was held.  Returns {kernel: record}."""
    held = hold_sweep_launches(sweeps, tag)
    for name in ("ligd_sweep", "mligd_sweep"):
        n = held.get(name, {}).get("launches", 0)
        if n != launches[name]:
            raise AssertionError(f"{tag}: {name} held {n} of "
                                 f"{launches[name]} launches")
    held.update(hold_lm_launches(lm, tag))
    return held


def compare_serving(a, b, where: str, atol: float = 0.0) -> float:
    """Two serving summaries (nested dicts/lists): ints, bools, strings
    and None equal; floats within SERVE_CROSS_RTOL relative or ``atol``
    absolute.  Returns the largest relative float difference; raises on
    a breach."""
    if isinstance(b, dict):
        if not isinstance(a, dict) or set(a) != set(b):
            raise AssertionError(f"{where}: keys {a} != {b}")
        return max([compare_serving(a[k], b[k], f"{where}.{k}", atol)
                    for k in b], default=0.0)
    if isinstance(b, (list, tuple)):
        if len(a) != len(b):
            raise AssertionError(f"{where}: {a} != {b}")
        return max([compare_serving(x, y, f"{where}[{i}]", atol)
                    for i, (x, y) in enumerate(zip(a, b))], default=0.0)
    if isinstance(b, float):
        d = abs(a - b)
        if d > max(SERVE_CROSS_RTOL * abs(b), atol):
            raise AssertionError(f"{where}: {a} vs {b}")
        return d / max(abs(b), 1e-30)
    if type(a) is not type(b) or a != b:
        raise AssertionError(f"{where}: {a!r} != {b!r}")
    return 0.0


def all_launches(counters) -> dict:
    return {k: v for c in counters for k, v in c.items()}


def zero_counters(counters) -> None:
    for c in counters:
        c.update(dict.fromkeys(c, 0))


def check_serving(s: dict, where: str, failovers: bool) -> None:
    """The data plane's invariants on one summary."""
    bad = []
    if s["lost"] != 0:
        bad.append(f"lost {s['lost']}")
    if s["submitted"] != s["completed"] + s["device"] + s["degraded"]:
        bad.append("submitted != completed + device + degraded")
    if s["shed"] > s["degraded"]:
        bad.append(f"shed {s['shed']} > degraded {s['degraded']}")
    if s["tokens_emitted"] <= 0:
        bad.append("no token emitted")
    if failovers and s["failover_events"] < 1:
        bad.append("no mid-stream failover")
    if bad:
        raise AssertionError(f"{where}: " + "; ".join(bad))


def serve_loop(device) -> tuple:
    """[serve-loop]: ``serve_chaos_k3`` at its own size (500 users, K 3,
    server 0 down from t = 30 to 150 s, 800 requests) on the card, its
    pools' engines full-width, full-depth starcoder2-3b in bf16.  Every
    kernel count is zeroed just before the session is built and read
    just after its run; every sweep launch and the first attention and
    RMSNorm launch at each shape are recorded and held against the plain
    versions after the counts were read.  Returns (record, launches)."""
    import torch
    from repro_torch.api import get_scenario
    from repro_torch.configs import get_config
    sc = get_scenario("serve_chaos_k3")
    cfg = get_config("starcoder2-3b")
    t0 = time.perf_counter()
    factory = FullWidthEngines(cfg, sc.serving.cache_len, device,
                               SERVE_LOOP_SEED)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()
    counters = kernel_counters()
    sweeps, seen, unspy = record_loop_launches()
    zero_counters(counters)
    try:
        t0 = time.perf_counter()
        sess = serving_session(sc, factory, device)
        slots = [p.slots for p in sess.dataplane.pools]
        m = sess.run()
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
        launches = all_launches(counters)
    finally:
        unspy()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    s = m.serving
    breaches = []
    try:
        check_serving(s, "serve-loop", failovers=True)
    except AssertionError as exc:
        breaches.append(str(exc))
    if sess.device.type != "cuda":
        breaches.append(f"session on {sess.device}")
    off_card = [i for i, e in enumerate(factory.built)
                if e.device.type != "cuda"
                or any(not t.is_cuda for t in tensors_of(e.params))
                or any(not t.is_cuda for t in tensors_of(e.state.caches))]
    if not factory.built or off_card:
        breaches.append(f"engines off the card: {off_card} of "
                        f"{len(factory.built)}")
    L = cfg.num_layers
    for name in ("ligd_sweep", "mligd_sweep", "flash_attention",
                 "flash_attention_tc", "rmsnorm"):
        if launches[name] <= 0:
            breaches.append(f"{name}: no launch")
    prefills, rem = divmod(launches["flash_attention"], L)
    forwards, rem2 = divmod(launches["rmsnorm"], 2 * L + 1)
    if rem or rem2:
        breaches.append(f"launches not whole forwards: attention "
                        f"{launches['flash_attention']}, RMSNorm "
                        f"{launches['rmsnorm']}")
    held = hold_loop_launches(sweeps, seen, launches, "serve-loop")
    rec = {
        "scenario": sc.name, "users": sc.num_users, "steps": sc.steps,
        "engine": cfg.name, "layers": L, "d_model": cfg.d_model,
        "heads": [cfg.num_heads, cfg.num_kv_heads, cfg.head_dim],
        "dtype": cfg.dtype, "init_s": init_s, "wall_s": wall_s,
        "timings": sess.timings, "engines_built": len(factory.built),
        "slots": slots, "prefills": prefills,
        "decode_steps": forwards - prefills,
        "split": {k: s[k] for k in (
            "failover_events", "failovers_migrate", "failovers_reprefill",
            "relays", "relays_migrate", "relays_reprefill",
            "relay_s_migrate", "relay_s_reprefill", "recompute_s_total")},
        "relay_bits": [e.relay_bits for e in sess.dataplane.events],
        "peak_mem_gb": peak_gb, "launches": launches,
        "held_launches": held,
        "summary": {k: v for k, v in s.items() if k != "per_server"},
        "serving_failovers": m.faults["serving_failovers"]}
    phase("serve-loop", json.dumps(rec))
    if breaches:
        raise AssertionError("serve-loop: " + "; ".join(breaches))
    del sess, factory
    torch.cuda.empty_cache()
    return rec, launches


def tensors_of(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from tensors_of(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from tensors_of(v)
    else:
        yield tree


def serve_identity(device) -> None:
    """[serve-identity]: streams killed mid-decode on server 0 and moved
    to server 1, once with ``failover_mode`` forced to ``migrate`` and
    once to ``reprefill``, on a 2-layer cut of starcoder2-3b at full
    width in float32 with TF32 off: each failed-over request's tokens
    must equal its uninterrupted run's (the reference's
    tests/test_dataplane.py contract), and each event carries the forced
    mode.  Raises on a breach."""
    import dataclasses
    from types import SimpleNamespace
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.serving import DONE, ServeConfig, ServingDataPlane
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = dataclasses.replace(get_config("starcoder2-3b"), num_layers=2,
                              dtype="float32")
    factory = FullWidthEngines(cfg, 32, device, SERVE_LOOP_SEED + 1)
    topo = SimpleNamespace(
        num_servers=2, server_aps=np.arange(2, dtype=np.int64),
        edges=[SimpleNamespace(B_backhaul=1e6) for _ in range(2)],
        hops=np.ones((2, 2), np.float64))
    X, num_layers = 3, 4                  # split 1 < 4: served at the edge

    def fleet(z):
        return SimpleNamespace(server=np.full(X, z, np.int64),
                               split=np.ones(X, np.int64), T=np.ones(X))

    down0 = SimpleNamespace(server_down=np.asarray([0], np.int64),
                            server_up=np.asarray([], np.int64))
    recs, breaches = {}, []
    for mode in ("migrate", "reprefill"):
        scfg = ServeConfig(arrival_rate=5.0, arrival_seed=2, max_requests=4,
                           prompt_len=6, max_new=6, cache_len=32,
                           deadline_s=500.0, token_time_scale=6.0,
                           min_slots=4, max_slots=4, failover_mode=mode)

        def run(kill):
            plane = ServingDataPlane(scfg, topo, num_layers=num_layers,
                                     slots=np.asarray([4, 4]),
                                     engine_factory=factory)
            plane.step(3.0, 0.0, fleet=fleet(0))
            in_flight = plane.in_flight()
            if kill:
                plane.step(3.0, 3.0, fleet=fleet(1), faults=down0)
            plane.drain()
            return plane, in_flight

        (intact, _), (failed, live) = run(False), run(True)
        a, b = intact.requests, failed.requests
        equal = sum(b[r].tokens == a[r].tokens for r in b if r in a)
        modes = [e.mode for e in failed.events]
        recs[mode] = {"requests": len(b), "in_flight_at_kill": live,
                      "failovers": len(modes), "modes": sorted(set(modes)),
                      "relay_bits": [e.relay_bits for e in failed.events],
                      "tokens_equal": equal,
                      "tokens": [b[r].tokens for r in sorted(b)]}
        if set(a) != set(b) or equal != len(b):
            breaches.append(f"{mode}: {equal} of {len(b)} streams equal "
                            "their uninterrupted run")
        if not modes or set(modes) != {mode}:
            breaches.append(f"{mode}: failover modes {modes}")
        if any(r.status != DONE for r in b.values()):
            breaches.append(f"{mode}: a stream did not finish on the edge")
    phase("serve-identity", json.dumps({
        "model": cfg.name, "layers": cfg.num_layers, "d_model": cfg.d_model,
        "dtype": cfg.dtype, "tf32": False, **recs}))
    if breaches:
        raise AssertionError("serve-identity: " + "; ".join(breaches))
    del factory
    torch.cuda.empty_cache()


def serve_adaptive(counters) -> tuple:
    """[serve-adaptive]: ``serve_hotspot_k3`` on the card with its own
    (reduced) engines, feedback off and on, the same seed: the closed
    loop must degrade strictly fewer requests and end with a lower p99
    token latency (tools/serve_smoke.py --adaptive's assertions), and
    neither run may lose a request.  Each run's sweep launches, and its
    first attention and RMSNorm launch at each shape, are held against
    the plain versions after its counts were read.  Returns (the
    feedback-on run's metrics, launches of both runs, the holds by
    run)."""
    import dataclasses
    from repro_torch.api import Session, get_scenario
    sc = get_scenario("serve_hotspot_k3")
    runs, launches, held = {}, {}, {}
    for fb in (False, True):
        s_fb = sc.replace(serving=dataclasses.replace(sc.serving,
                                                      feedback=fb))
        sweeps, lm, unspy = record_loop_launches()
        zero_counters(counters)
        try:
            t0 = time.perf_counter()
            sess = Session(s_fb)               # device=None -> the card
            m = sess.run()
            wall_s = time.perf_counter() - t0
            run_launches = all_launches(counters)
        finally:
            unspy()
        for k, v in run_launches.items():
            launches[k] = launches.get(k, 0) + v
        held[f"feedback={fb}"] = hold_loop_launches(
            sweeps, lm, run_launches, f"serve-adaptive feedback={fb}")
        if sess.dataplane._factory.device.type != "cuda":
            raise AssertionError("serve-adaptive: engines off the card")
        check_serving(m.serving, f"serve-adaptive feedback={fb}",
                      failovers=False)
        runs[fb] = (m, wall_s, sess.timings)
    (off, _, _), (on, _, _) = runs[False], runs[True]
    rec = {("on" if fb else "off"): {
        "degraded": m.serving["degraded"], "shed": m.serving["shed"],
        "timeouts": m.serving["timeouts"],
        "token_latency_p99_s": m.serving["token_latency_p99_s"],
        "peak_compute_mult": (max(m.telemetry["compute_mult_max"])
                              if m.telemetry else 1.0),
        "wall_s": w, "serve_s": t["serve_s"],
        "telemetry_s": t["telemetry_s"],
        "held_launches": held[f"feedback={fb}"]}
        for fb, (m, w, t) in runs.items()}
    phase("serve-adaptive", json.dumps(rec))
    a, b = on.serving, off.serving
    if not (a["degraded"] < b["degraded"]
            and a["token_latency_p99_s"] is not None
            and b["token_latency_p99_s"] is not None
            and a["token_latency_p99_s"] < b["token_latency_p99_s"]):
        raise AssertionError(f"serve-adaptive: the closed loop must beat "
                             f"the open loop: {rec}")
    return on, launches, held


def serve_loop_cross(counters, hotspot_card) -> tuple:
    """[serve-loop-cross]: ``serve_chaos_k3`` and ``serve_hotspot_k3``
    with their own (reduced) engines, on the card and on the CPU (the
    hotspot's card run is [serve-adaptive]'s feedback-on run): counts in
    ``metrics().serving`` equal, floats and the telemetry multipliers
    within SERVE_CROSS_RTOL (differences of virtual times within
    SERVE_HORIZON_RTOL of the horizon).  The chaos card run's sweep
    launches, and its first attention and RMSNorm launch at each shape,
    are held against the plain versions after its counts were read.
    Returns (the card runs' launches, the hold)."""
    from repro_torch.api import Session, get_scenario
    launches, rec, held = {}, {}, {}
    for name in ("serve_chaos_k3", "serve_hotspot_k3"):
        sc = get_scenario(name)
        if name == "serve_hotspot_k3":
            card = hotspot_card
        else:
            sweeps, lm, unspy = record_loop_launches()
            zero_counters(counters)
            try:
                card = Session(sc, device="cuda").run()
                launches = all_launches(counters)
            finally:
                unspy()
            held = hold_loop_launches(sweeps, lm, launches,
                                      f"serve-loop-cross {name}")
        cpu = Session(sc, device="cpu").run()
        check_serving(card.serving, f"serve-loop-cross {name}",
                      failovers=sc.faults is not None)
        atol = SERVE_HORIZON_RTOL * cpu.serving["virtual_time_s"]
        rel = {"serving": compare_serving(card.serving, cpu.serving,
                                          f"{name} serving", atol),
               "telemetry": compare_serving(card.telemetry, cpu.telemetry,
                                            f"{name} telemetry", atol),
               "serving_failovers": compare_serving(
                   (card.faults or {}).get("serving_failovers"),
                   (cpu.faults or {}).get("serving_failovers"),
                   f"{name} serving_failovers", atol)}
        rec[name] = {"max_rel_diff": rel, **{k: card.serving[k] for k in (
            "submitted", "completed", "device", "degraded", "shed",
            "failover_events", "failovers_migrate", "failovers_reprefill",
            "tokens_emitted")}}
    phase("serve-loop-cross", json.dumps({**rec, "held_launches": held}))
    return launches, held


#: [enc-dec]: seamless-m4t-large-v2 as get_config gives it (24 encoder
#: and 24 decoder layers, d 1024, 16/16 heads of 64, ff 8192, vocab
#: 256,206, bf16), random weights from ENC_DEC_SEED on the card: 4
#: sources of ENC_FRAMES audio frames from the frontend stub (1000 is off
#: the 64-key tile), a decoder prompt of ENC_PROMPT tokens, ENC_STEPS
#: greedy decode steps.  Card against CPU on a cut of 2 encoder and 2
#: decoder layers at full width, one source of ENC_CROSS_FRAMES frames
ENC_DEC_SEED = 0
ENC_FRAMES = 1000
ENC_PROMPT = 16
ENC_STEPS = 32
ENC_CROSS_FRAMES = 250
#: [kv-int8]: starcoder2-3b at full width, 4 prompts of 1024 tokens into
#: KV_CACHE_LEN-row caches, KV_STEPS decode steps
KV_CACHE_LEN = 2048
KV_STEPS = 32
#: [cnn-split]: the chain CNNs at CNN_BATCH images; megafleet_100k's NiN
#: fleet in chunks of at most CNN_CHUNK images (NiN's largest activation
#: is 786 KB an image, so the 100,000 images at once would need 78 GB).
#: Card against CPU on CNN_CROSS_IMAGES images, in float32 with cuDNN's
#: TF32 off (torch.backends.cudnn.allow_tf32 = False) to the CPU tests'
#: tolerance, rtol 1e-4 / atol 1e-5 (the same float32 products summed in
#: another order); and under PyTorch's default, TF32 on, where the
#: convolutions round their inputs to a 10-bit mantissa (~5e-4 a
#: product): the largest difference within CNN_TF32_TOL of the output's
#: largest magnitude.  Split against unsplit on the card: bit for bit,
#: under the default (TF32 on)
CNN_BATCH = 256
CNN_CHUNK = 8192
CNN_CROSS_IMAGES = 16
CNN_RTOL, CNN_ATOL = 1e-4, 1e-5
CNN_TF32_TOL = 2e-2
#: [ligd-oracle]: the autodiff oracle against the sweep at the reference's
#: own tolerances (tests/test_ligd.py:149-190, tests/test_mligd.py:89-120):
#: split and R exact, B, r, U (and T, E, C, U_recalc, U_back for MLi-GD)
#: to ORACLE_RTOL relative, per-split iteration counts within 1; on
#: megafleet_100k's ORACLE_USERS users, a split may differ only on a
#: named near-tie (the two best per-split U, or the two R vertices,
#: within ORACLE_RTOL), as tests/torch_diff.py names them
ORACLE_RTOL = 1e-4
ORACLE_USERS = 4096
#: the reference tests' fleets, drawn as those tests draw them
ORACLE_CASES = (
    dict(name="nin_hetero_warm", model="nin", seed=7, X=48, edges="pool",
         max_iters=150, warm_start=True),
    dict(name="nin_hetero_cold", model="nin", seed=7, X=48, edges="pool",
         max_iters=150, warm_start=False),
    dict(name="vgg16_shared", model="vgg16", seed=11, X=12,
         edges="shared", max_iters=80, warm_start=True),
    dict(name="mligd_relay_back", model="nin", seed=5, X=12, joint=True,
         new_edge=dict(c_min=2e9, rho_min=5e-3, r_max=4.0), hops_back=1.0,
         vertex=1, max_iters=150),
    dict(name="mligd_resolve", model="nin", seed=5, X=12, joint=True,
         new_edge=dict(c_min=500e9, rho_min=1e-5, r_max=64.0),
         hops_back=10.0, vertex=0, max_iters=150),
)


def release_memory() -> float:
    """Collect garbage (a reference cycle can keep an earlier phase's
    tensors alive), return the allocator's cached blocks, and give the GB
    still allocated: the baseline under a phase's peak memory."""
    import gc
    import torch
    gc.collect()
    torch.cuda.empty_cache()
    return torch.cuda.memory_allocated() / 1e9


def enc_dec(device, counters) -> tuple:
    """[enc-dec]: seamless-m4t-large-v2 at full width and depth on the
    card.  Every kernel count is zeroed just before ``prefill`` and read
    after the last ``decode_step``; the first attention and RMSNorm
    launch at each shape (the non-causal encoder, the causal decoder
    prefill, cross attention at prefill and at every decode step) is
    held against its plain version.  Decode is held against a
    teacher-forced prefill of the prompt and the generated tokens: each
    source's first token must be equal, later tokens are counted.  Then
    row 3 is timed at the new shapes, and the 2 + 2-layer cut runs card
    against CPU.  Returns (record, launches, held launches)."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import transformer as tfm
    from repro_torch.models.frontend import audio_frame_embeds

    cfg = get_config("seamless-m4t-large-v2")
    B = 4
    live_gb = release_memory()
    t0 = time.perf_counter()
    gen = torch.Generator(device).manual_seed(ENC_DEC_SEED)
    params = tfm.init_lm(cfg, gen, device)
    src = audio_frame_embeds(cfg, gen, B, ENC_FRAMES, device)
    tokens = torch.randint(0, cfg.vocab_size, (B, ENC_PROMPT),
                           generator=gen, device=device)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(t.numel() for t in tensors_of(params))
    # the process's first prefill of this model, timed apart: it pays
    # for loading the library kernels its shapes need
    batch = {"tokens": tokens, "src_embeds": src}
    t0 = time.perf_counter()
    tfm.prefill(cfg, params, batch, cache_len=ENC_PROMPT + ENC_STEPS)
    torch.cuda.synchronize()
    cold_ms = (time.perf_counter() - t0) * 1e3
    torch.cuda.reset_peak_memory_stats()
    lm_seen, unspy = record_lm_launches()
    zero_counters(counters)
    try:
        t0 = time.perf_counter()
        logits, caches = tfm.prefill(
            cfg, params, batch, cache_len=ENC_PROMPT + ENC_STEPS)
        cur = torch.argmax(logits[:, :cfg.vocab_size], dim=-1)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        out = [cur]
        for i in range(ENC_STEPS):
            _, cur, caches = tfm.decode_step(cfg, params, cur[:, None],
                                             ENC_PROMPT + i, caches)
            out.append(cur)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
    finally:
        unspy()
    launches = all_launches(counters)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    cache_gb = sum(t.numel() * t.element_size()
                   for t in tensors_of(caches)) / 1e9
    gen_tok = torch.stack(out, dim=1)                     # (B, 1 + steps)
    del caches

    # teacher forcing: the prompt and every generated token but the last
    # in one prefill; its greedy pick at each position from S - 1 on
    full = torch.cat([tokens, gen_tok[:, :-1]], dim=1)
    kv_memory = tfm._encode(cfg, params, src)
    h = tfm._assemble_inputs(cfg, params, {"tokens": full})
    h, _ = tfm.apply_stack(cfg, params, h, mode="prefill",
                           positions=tfm._positions(h),
                           cache_len=full.shape[1], kv_memory=kv_memory)
    forced = torch.stack([tfm.head(cfg, params, h[:, i:i + 1])[1]
                          for i in range(ENC_PROMPT - 1, full.shape[1])],
                         dim=1)
    first_equal = int((forced[:, 0] == gen_tok[:, 0]).sum().item())
    later_share = (forced[:, 1:] == gen_tok[:, 1:]).float().mean().item()
    del h, kv_memory, params
    torch.cuda.empty_cache()
    held = hold_lm_launches(lm_seen, "[enc-dec]")
    del lm_seen

    L, E = cfg.num_layers, cfg.num_enc_layers
    per_prefill = {"flash_attention": E + 2 * L,
                   "rmsnorm": 2 * E + 1 + 3 * L + 1}
    per_step = {"flash_attention": L, "rmsnorm": 3 * L + 1}
    want = {k: per_prefill[k] + ENC_STEPS * per_step[k] for k in per_step}
    rec = dict(
        model=cfg.name, encoder_layers=E, decoder_layers=L,
        d_model=cfg.d_model, heads=[cfg.num_heads, cfg.num_kv_heads,
                                    cfg.head_dim],
        params_b=cfg.num_params() / 1e9, params_b_counted=n_params / 1e9,
        batch=B, frames=ENC_FRAMES, prompt=ENC_PROMPT, steps=ENC_STEPS,
        init_s=init_s, first_prefill_ms=cold_ms, prefill_ms=(t1 - t0) * 1e3,
        decode_ms_per_step=(t2 - t1) / ENC_STEPS * 1e3,
        peak_mem_gb=peak_gb, live_gb_before=live_gb, cache_gb=cache_gb,
        first_tokens_equal=first_equal,
        later_token_share_equal=later_share,
        launches=launches, expected_launches=want,
        held={k: v["shapes"] for k, v in held.items()})
    phase("enc-dec", json.dumps(rec))
    breaches = []
    if first_equal != B:
        breaches.append(f"{B - first_equal} first tokens differ from "
                        "teacher-forced prefill")
    for name, n in want.items():
        if launches[name] != n:
            breaches.append(f"{name}: {launches[name]} launches, expected "
                            f"{n}")
    if launches["flash_attention_tc"] != launches["flash_attention"]:
        breaches.append("an attention launch left the tensor-core body")
    shapes = {tuple(s[1:3]) + (s[6],) for s in
              held["flash_attention"]["shapes"]}
    for need in ((ENC_FRAMES, ENC_FRAMES, 0), (ENC_PROMPT, ENC_PROMPT, 1),
                 (ENC_PROMPT, ENC_FRAMES, 0), (1, ENC_FRAMES, 0)):
        if need not in shapes:
            breaches.append(f"no attention launch (Sq, Skv, causal) = "
                            f"{need} was held")
    if breaches:
        raise AssertionError("[enc-dec]: " + "; ".join(breaches))

    # row 3 at the encoder-decoder's shapes, timed beside its plain
    # version, SDPA and the bound
    g = torch.Generator(device=device).manual_seed(23)

    def randn(shape, dt):
        return torch.randn(shape, generator=g, device=device).to(dt)

    heads = (cfg.num_heads, cfg.num_kv_heads, cfg.head_dim)
    cases, errs = {}, []
    for label, S, Skv, causal in (
            ("encoder", ENC_FRAMES, ENC_FRAMES, False),
            ("decoder_prefill", ENC_PROMPT, ENC_PROMPT, True),
            ("cross_prefill", ENC_PROMPT, ENC_FRAMES, False),
            ("cross_decode", 1, ENC_FRAMES, False)):
        cases[label] = attention_case(device, randn, B, S, causal, 0,
                                      "bfloat16", heads, breaches, Skv=Skv)
        errs.append(cases[label]["max_abs_err"])
    # and RMSNorm at its rows: the encoder's, the decoder prefill's and a
    # decode step's
    rms_errs = []
    for label, rows in (("rmsnorm_encoder", B * ENC_FRAMES),
                        ("rmsnorm_prefill", B * ENC_PROMPT),
                        ("rmsnorm_decode", B)):
        cases[label] = rmsnorm_case(randn, rows, cfg.d_model, "bfloat16",
                                    breaches)
        rms_errs.append(cases[label]["max_abs_err"])
    if breaches:
        raise AssertionError("[enc-dec] kernels vs plain: "
                             + "; ".join(breaches))
    enc_dec_cross(device, cfg)
    torch.cuda.empty_cache()
    held["flash_attention"]["max_abs_err"] = max(
        held["flash_attention"]["max_abs_err"], *errs)
    held["rmsnorm"]["max_abs_err"] = max(held["rmsnorm"]["max_abs_err"],
                                         *rms_errs)
    return rec, launches, held, cases


def enc_dec_cross(device, cfg) -> None:
    """seamless-m4t-large-v2 cut to 2 encoder and 2 decoder layers at full
    width, one source of ENC_CROSS_FRAMES frames and a 16-token prompt:
    bf16 prefill logits on the card (kernels) against the CPU (plain
    versions) at CROSS_ATOL / CROSS_RTOL, then 8 greedy tokens in float32
    (TF32 off), which must be equal.  Raises on a breach."""
    import dataclasses
    import torch
    from repro_torch.launch.serve_split import _sync
    from repro_torch.models import transformer as tfm

    torch.backends.cuda.matmul.allow_tf32 = False
    cut = dataclasses.replace(cfg, num_layers=2, num_enc_layers=2)
    cpu_params = tfm.init_lm(cut, torch.Generator(device).manual_seed(3),
                             "cpu")
    g = torch.Generator().manual_seed(4)
    src = torch.randn((1, ENC_CROSS_FRAMES, cut.d_model), generator=g)
    tok = torch.randint(0, cut.vocab_size, (1, ENC_PROMPT), generator=g)
    logits = {}
    for dev in ("cpu", device):
        p = to_tree(cpu_params, device=dev)
        logits[str(dev)], _ = tfm.prefill(
            cut, p, {"tokens": tok.to(dev), "src_embeds": src.to(dev)},
            cache_len=ENC_PROMPT)
    a, b = logits[str(device)].float().cpu(), logits["cpu"].float()
    err = (a - b).abs().max().item()
    bf16_ok = bool(torch.allclose(a, b, atol=CROSS_ATOL, rtol=CROSS_RTOL))
    cut32 = dataclasses.replace(cut, dtype="float32")
    toks = {}
    for dev in ("cpu", device):
        p = to_tree(cpu_params, device=dev, dtype=torch.float32)
        lg, caches = tfm.prefill(
            cut32, p, {"tokens": tok.to(dev), "src_embeds": src.to(dev)},
            cache_len=ENC_PROMPT + 8)
        cur = torch.argmax(lg[:, :cut.vocab_size], dim=-1)
        out = [cur]
        for i in range(7):
            _, cur, caches = tfm.decode_step(cut32, p, cur[:, None],
                                             ENC_PROMPT + i, caches)
            out.append(cur)
        _sync(torch.device(dev))
        toks[str(dev)] = torch.stack(out, dim=1).cpu()
    same = bool(torch.equal(toks["cpu"], toks[str(device)]))
    phase("enc-dec-cross", json.dumps({
        "model": cut.name, "encoder_layers": 2, "decoder_layers": 2,
        "frames": ENC_CROSS_FRAMES, "prompt": ENC_PROMPT,
        "bf16_logits_max_abs_err": err, "bf16_within_tol": bf16_ok,
        "f32_tokens_equal": same, "f32_tokens": toks["cpu"].tolist()}))
    if not (bf16_ok and same):
        raise AssertionError(f"[enc-dec] card vs CPU: bf16 logits err "
                             f"{err:.3g} (tol {CROSS_ATOL}/{CROSS_RTOL}), "
                             f"f32 tokens equal: {same}")


def kv_int8(device, counters) -> tuple:
    """[kv-int8]: starcoder2-3b at full width and depth, 4 prompts of
    1024 tokens: ``prefill`` then KV_STEPS ``decode_step`` s into
    KV_CACHE_LEN-row caches, first with the bf16 cache, then with
    ``kv_quant=True`` (its kernel counts zeroed just before and read just
    after).  The int8 run's prompt rows must equal ``quantize_kv`` of the
    bf16 run's k/v (the same prefill, bit for bit) on the CPU: scales
    exactly, codes exactly except a code one apart where x / scale sits
    on a .5 tie (counted); its first token must equal the bf16 run's,
    later tokens are counted.  Returns (record, launches)."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.launch import serve_split
    from repro_torch.models import transformer as tfm
    from repro_torch.models.attention import quantize_kv

    cfg = get_config("starcoder2-3b")
    live_gb = release_memory()
    params, tokens = serve_split.make_inputs(cfg, device=device, batch=4,
                                             prompt_len=1024)
    S = tokens.shape[1]
    runs = {}
    launches = None
    for quant in (False, True):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        if quant:
            zero_counters(counters)
        t0 = time.perf_counter()
        logits, caches = tfm.prefill(cfg, params, {"tokens": tokens},
                                     cache_len=KV_CACHE_LEN,
                                     kv_quant=quant)
        cur = torch.argmax(logits[:, :cfg.vocab_size], dim=-1)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        out, first_logits = [cur], None
        for i in range(KV_STEPS):
            lg, cur, caches = tfm.decode_step(cfg, params, cur[:, None],
                                              S + i, caches)
            first_logits = lg.float() if first_logits is None \
                else first_logits
            out.append(cur)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        if quant:
            launches = all_launches(counters)
        runs[quant] = dict(
            tokens=torch.stack(out, dim=1).cpu(),
            first_decode_logits=first_logits,
            prefill_ms=(t1 - t0) * 1e3,
            decode_ms_per_step=(t2 - t1) / KV_STEPS * 1e3,
            peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9,
            cache_bytes=sum(t.numel() * t.element_size()
                            for t in tensors_of(caches)),
            prompt_rows=[{n: c[n][:, :S].cpu() for n in c} for c in caches])
        del caches
    q, f = runs[True], runs[False]
    scales_equal, ties, off, worst = True, 0, 0, 0
    for cq, cf in zip(q["prompt_rows"], f["prompt_rows"]):
        for n in ("k", "v"):
            codes, scales = quantize_kv(cf[n])
            scales_equal &= bool(torch.equal(scales, cq[n + "_scale"]))
            d = (codes.int() - cq[n].int()).abs()
            r = cf[n].float() / scales[..., None]
            tie = ((r - r.floor()) - 0.5).abs() <= 1e-6
            worst = max(worst, int(d.max().item()))
            ties += int(((d == 1) & tie).sum().item())
            off += int(((d > 0) & ~((d == 1) & tie)).sum().item())
    diff = (q["first_decode_logits"] - f["first_decode_logits"]).abs()
    rec = dict(
        model=cfg.name, batch=4, prompt=S, cache_len=KV_CACHE_LEN,
        steps=KV_STEPS, live_gb_before=live_gb,
        **{f"int8_{k}": q[k] for k in ("prefill_ms", "decode_ms_per_step",
                                        "peak_mem_gb", "cache_bytes")},
        **{f"bf16_{k}": f[k] for k in ("prefill_ms", "decode_ms_per_step",
                                        "peak_mem_gb", "cache_bytes")},
        cache_ratio=q["cache_bytes"] / f["cache_bytes"],
        scales_equal=scales_equal, codes_off_by_one_on_ties=ties,
        codes_differing_otherwise=off, codes_max_abs_diff=worst,
        first_tokens_equal=int((q["tokens"][:, 0]
                                == f["tokens"][:, 0]).sum().item()),
        later_token_share_equal=(q["tokens"][:, 1:] == f["tokens"][:, 1:])
        .float().mean().item(),
        first_decode_logits_max_abs_diff=diff.max().item(),
        launches=launches)
    phase("kv-int8", json.dumps(rec))
    bad = []
    if not scales_equal:
        bad.append("scales differ from quantize_kv on the CPU")
    if off:
        bad.append(f"{off} codes differ from quantize_kv on the CPU off a "
                   "rounding tie")
    if rec["first_tokens_equal"] != 4:
        bad.append("a first token differs from the bf16-cache run")
    if launches["flash_attention"] != cfg.num_layers or \
            launches["rmsnorm"] != 2 * cfg.num_layers + 1 + KV_STEPS * (
                2 * cfg.num_layers + 1):
        bad.append(f"launches {launches}")
    if bad:
        raise AssertionError("[kv-int8]: " + "; ".join(bad))
    del params
    torch.cuda.empty_cache()
    return rec, launches


@contextlib.contextmanager
def cudnn_tf32(on: bool):
    """``torch.backends.cudnn.allow_tf32`` set for a ``with`` block and
    restored after it."""
    import torch
    old = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = on
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = old


def cnn_split(device, counters) -> tuple:
    """[cnn-split]: NiN, YOLOv2 and VGG16 on their repo configs, random
    float32 weights and CNN_BATCH images from a seed on the card: at every
    split s in 0..M, ``split_inference`` equals ``forward`` bit for bit
    and ships ``out_bits[s-1] / 16`` elements an image (``in_bits / 8``
    at s = 0), as the planner's profile prices it; card against CPU at
    both TF32 settings (tolerances above).  Then megafleet_100k's static
    plan on the card (its sweep launch held bit for bit): its 100,000 NiN
    users grouped by planned split, each group's device half and edge
    half in chunks of at most CNN_CHUNK images, images/s and peak memory
    (every kernel count zeroed before the session, read after the last
    chunk).  Returns (record, launches, held sweep launches)."""
    import numpy as np
    import torch
    from repro_torch.api import Session, get_scenario
    from repro_torch.configs import get_config
    from repro_torch.core.profile import profile_chain_cnn
    from repro_torch.kernels.ligd_step import ops as sweep_ops
    from repro_torch.models import chain_cnn as cnn

    nets, bad = {}, []
    for name in ("nin", "yolov2", "vgg16"):
        cfg = get_config(name)
        g = torch.Generator(device=device).manual_seed(5)
        params = cnn.init_cnn(cfg, g, device)
        x = torch.randn((CNN_BATCH, cfg.in_hw, cfg.in_hw, cfg.in_ch),
                        generator=g, device=device)
        prof = profile_chain_cnn(cfg)
        full = cnn.forward(cfg, params, x)
        split_equal, shipped_ok = 0, 0
        for s in range(cfg.num_layers + 1):
            inter, out = cnn.split_inference(cfg, params, x, s)
            split_equal += int(torch.equal(out, full))
            want = prof.in_bits / 8 if s == 0 else prof.out_bits[s - 1] / 16
            shipped_ok += int(inter[0].numel() == want)
        ms = timed_ms(lambda: cnn.forward(cfg, params, x), 10, 2)
        xs = x[:CNN_CROSS_IMAGES]
        want = cnn.forward(cfg, to_tree(params, device="cpu"), xs.cpu())
        scale = want.abs().max().item()
        errs = {}
        for tf32 in (False, True):
            with cudnn_tf32(tf32):
                got = cnn.forward(cfg, params, xs).cpu()
            errs[tf32] = ((got - want).abs().max().item(),
                          bool(torch.allclose(got, want, rtol=CNN_RTOL,
                                              atol=CNN_ATOL)))
        rec = dict(layers=cfg.num_layers, in_hw=cfg.in_hw, batch=CNN_BATCH,
                   splits=cfg.num_layers + 1, split_equal=split_equal,
                   shipped_equal_profile=shipped_ok, forward_ms=ms,
                   images_per_s=CNN_BATCH / (ms * 1e-3),
                   cross_images=CNN_CROSS_IMAGES, out_max_abs=scale,
                   cross_max_abs_err_tf32_off=errs[False][0],
                   cross_max_abs_err_tf32_on=errs[True][0])
        phase("cnn-split", f"{name} " + json.dumps(rec))
        nets[name] = rec
        if split_equal != cfg.num_layers + 1:
            bad.append(f"{name}: split != unsplit at "
                       f"{cfg.num_layers + 1 - split_equal} splits")
        if shipped_ok != cfg.num_layers + 1:
            bad.append(f"{name}: shipped size != profile")
        if not errs[False][1]:
            bad.append(f"{name}: card (TF32 off) vs CPU {errs[False][0]:.3g}"
                       f" (rtol {CNN_RTOL}, atol {CNN_ATOL})")
        if not errs[True][0] <= CNN_TF32_TOL * scale:
            bad.append(f"{name}: card (TF32 on) vs CPU {errs[True][0]:.3g} "
                       f"> {CNN_TF32_TOL} x {scale:.3g}")
        del params, x, full
    torch.cuda.empty_cache()

    sc = get_scenario("megafleet_100k")
    cfg = get_config("nin")
    params = cnn.init_cnn(cfg, torch.Generator(device=device).manual_seed(6),
                          device)
    g = torch.Generator(device=device).manual_seed(7)
    sweeps, unspy = record_sweep_launches(sweep_ops)
    torch.cuda.synchronize()
    live_gb = release_memory()
    torch.cuda.reset_peak_memory_stats()
    zero_counters(counters)
    try:
        t0 = time.perf_counter()
        sess = Session(sc)                         # the static plan
        splits = np.asarray(sess.fleet.split)
        t1 = time.perf_counter()
        groups, finite = {}, True
        for s in np.unique(splits):
            n = int((splits == s).sum())
            groups[int(s)] = n
            for lo in range(0, n, CNN_CHUNK):
                m = min(CNN_CHUNK, n - lo)
                x = torch.randn((m, cfg.in_hw, cfg.in_hw, cfg.in_ch),
                                generator=g, device=device)
                inter = cnn.forward_range(cfg, params, x, 0, int(s))
                out = cnn.forward_range(cfg, params, inter, int(s),
                                        cfg.num_layers)
                finite &= bool(torch.isfinite(out).all().item())
        torch.cuda.synchronize()
        t2 = time.perf_counter()
    finally:
        unspy()
    launches = all_launches(counters)
    held = hold_sweep_launches(sweeps, "[cnn-split]")
    fleet = dict(
        scenario=sc.name, users=int(len(splits)), chunk=CNN_CHUNK,
        users_per_split=groups, plan_s=t1 - t0, run_s=t2 - t1,
        images_per_s=len(splits) / (t2 - t1),
        peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9,
        live_gb_before=live_gb, launches=launches)
    phase("cnn-split", "megafleet_100k " + json.dumps(fleet))
    if not finite:
        bad.append("megafleet_100k: a non-finite output")
    if sum(groups.values()) != sc.num_users:
        bad.append("megafleet_100k: users lost in grouping")
    if bad:
        raise AssertionError("[cnn-split]: " + "; ".join(bad))
    del params, sess
    torch.cuda.empty_cache()
    return dict(nets=nets, fleet=fleet), launches, held


def oracle_columns(case: dict) -> dict:
    """The host columns of an ORACLE_CASES fleet, drawn as the reference
    tests draw them: {"dev": (X,) columns, "edge": (X,) columns or None
    for the shared default server}."""
    import numpy as np
    from repro_torch.core.costs import DeviceFleet, EdgeParams, \
        stack_edges_np
    rng = np.random.default_rng(case["seed"])
    X = case["X"]
    if case.get("joint"):
        return {"dev": dict(DeviceFleet(c_dev=rng.uniform(3e9, 60e9, X))
                            .arrays), "edge": None}
    w = rng.uniform(0.1, 1.0, (3, X))
    w /= w.sum(0)
    dev = DeviceFleet(c_dev=rng.uniform(2e9, 100e9, X),
                      p_tx=rng.uniform(0.2, 1.0, X),
                      alpha=rng.uniform(3e-11, 3e-10, X),
                      k_rounds=rng.uniform(20.0, 200.0, X),
                      w_T=w[0], w_E=w[1], w_C=w[2],
                      hops=rng.integers(0, 6, X)).arrays
    edge = None
    if case["edges"] == "pool":
        pool = [EdgeParams(),
                EdgeParams(c_min=8e9, rho_min=1e-3, r_max=8.0),
                EdgeParams(c_min=200e9, B_max=4e7, gamma_B=1.5)]
        idx = rng.integers(0, len(pool), X)
        edge = {k: v[idx] for k, v in stack_edges_np(pool).items()}
    return {"dev": dict(dev), "edge": edge}


def oracle_args(case: dict, device, origs=None) -> tuple:
    """(solve function, its arguments but the config, LiGDConfig) of an
    ORACLE_CASES fleet on ``device``.  MLi-GD's frozen original strategies
    are ``origs``, or each user's autodiff Li-GD solve against the default
    server (as the reference test freezes them)."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.core.costs import EdgeParams, edge_dict, rows_to_device
    from repro_torch.core.ligd import LiGDConfig, solve_ligd_batch
    from repro_torch.core.mligd import orig_strategy_dict, solve_mligd_batch
    from repro_torch.core.profile import profile_of
    cols = oracle_columns(case)
    prof = profile_of(get_config(case["model"]))
    X = case["X"]
    devs = rows_to_device(cols["dev"], device, X)
    cfg = LiGDConfig(max_iters=case["max_iters"],
                     warm_start=case.get("warm_start", True))
    if not case.get("joint"):
        edge = (edge_dict(EdgeParams(), device) if cols["edge"] is None
                else rows_to_device(cols["edge"], device, X))
        return solve_ligd_batch, (prof, devs, edge), cfg
    edge_orig = edge_dict(EdgeParams(), device)
    if origs is None:
        prev = solve_ligd_batch(prof, devs, edge_orig,
                                LiGDConfig(solver="autodiff"))
        origs = orig_strategy_dict(prof, edge_orig, prev)
    hops = torch.full((X,), float(case["hops_back"]), dtype=torch.float32,
                      device=device)
    return solve_mligd_batch, (prof, devs, edge_dict(
        EdgeParams(**case["new_edge"]), device), origs, hops), cfg


def oracle_errors(fused, oracle, ties=None) -> tuple:
    """The sweep's result against the oracle's (LiGDResult or
    MLiGDResult, tensors or arrays): (errors, list of breaches of the
    reference's tolerances).  ``ties``: (X,) bool, the users whose
    discrete choices may differ (named near-ties); None: none may."""
    import numpy as np

    def a(t):
        return np.asarray(t.detach().cpu().numpy() if hasattr(t, "detach")
                          else t, np.float64)

    X = len(a(oracle.split))
    ties = np.zeros(X, bool) if ties is None else np.asarray(ties)
    discrete = ("split",) + (("R",) if hasattr(oracle, "R") else ())
    agree = np.ones(X, bool)
    err, bad = {}, []
    for f in discrete:
        d = a(getattr(fused, f)) != a(getattr(oracle, f))
        agree &= ~d
        err[f"{f}_differ"] = int(d.sum())
        if (d & ~ties).any():
            bad.append(f"{f} differs at users "
                       f"{np.nonzero(d & ~ties)[0].tolist()[:20]}")
    floats = ("B", "r", "U") + (("T", "E", "C", "U_recalc", "U_back")
                                if hasattr(oracle, "R") else ())
    for f in floats:
        x, y = a(getattr(fused, f))[agree], a(getattr(oracle, f))[agree]
        rel = float(np.max(np.abs(x - y) / np.maximum(np.abs(y), 1e-30),
                           initial=0.0))
        err[f"{f}_rel"] = rel
        if not rel <= ORACLE_RTOL:
            bad.append(f"{f} rel {rel:.3g} > {ORACLE_RTOL}")
    dit = np.abs(a(fused.iters_per_layer) - a(oracle.iters_per_layer))
    err["iters_max_diff"] = int(dit.max(initial=0))
    err["near_ties"] = int(ties.sum())
    if dit.max(initial=0) > 1:
        bad.append(f"iteration counts differ by {int(dit.max())}")
    return err, bad


def oracle_ties(launch, oracle) -> "np.ndarray":
    """(X,) bool named near-ties of one recorded solve: the two best
    per-split U of its sweep launch (``launch``: the recorded inputs, run
    through the plain version, which the kernel equals bit for bit) within
    ORACLE_RTOL, or, for MLi-GD, the oracle's two R vertices within
    ORACLE_RTOL (tests/torch_diff.py's rule)."""
    import numpy as np
    from repro_torch.kernels.ligd_step import ligd_sweep_ref, \
        mligd_sweep_ref
    feat, x0, tab, kw = launch
    kw = dict(kw)
    ref = mligd_sweep_ref if kw.pop("joint") else ligd_sweep_ref
    u = np.sort(ref(feat, x0, tab, chunk=1, **kw)[0].double().cpu().numpy(),
                axis=0)
    ties = (u[1] - u[0]) <= ORACLE_RTOL * np.abs(u[0])
    if hasattr(oracle, "R"):
        u1 = oracle.U_recalc.double().cpu().numpy()
        u2 = oracle.U_back.double().cpu().numpy()
        ties |= np.abs(u1 - u2) <= ORACLE_RTOL * np.abs(u1)
    return ties


def ligd_oracle(device, counters) -> tuple:
    """[ligd-oracle]: the autodiff oracle (``solver="autodiff"``,
    ``torch.autograd`` on the card) against rows 1a and 1b.  First on the
    reference tests' fleets (ORACLE_CASES); then on megafleet_100k with
    ORACLE_USERS users: its Session (the sweep) runs with every
    Li-GD/MLi-GD solve call recorded, and each is solved again by the
    oracle on the same card tensors.  Every sweep launch of the phase is
    held bit for bit against the plain version.  Every kernel count is
    zeroed at the start and read before the holds.  Returns (record,
    launches, held sweep launches)."""
    import dataclasses
    import torch
    from repro_torch.api import Session, get_scenario
    from repro_torch.core import planner as planner_mod
    from repro_torch.kernels.ligd_step import ops as sweep_ops

    sweeps, unspy_sweep = record_sweep_launches(sweep_ops)
    zero_counters(counters)
    cases, bad = {}, []
    calls = []
    solve_l, solve_m = planner_mod.solve_ligd_batch, \
        planner_mod.solve_mligd_batch

    def clone(tree):
        if isinstance(tree, dict):
            return {k: clone(v) for k, v in tree.items()}
        if isinstance(tree, (list, tuple)):
            return [clone(v) for v in tree]
        return tree.clone() if torch.is_tensor(tree) else tree

    def spy(fn):
        def wrapped(profile, *args):
            first = len(sweeps)
            res = fn(profile, *args)
            calls.append((fn, profile, clone(args[:-1]), args[-1], res,
                          sweeps[first:]))
            return res
        return wrapped

    try:
        for case in ORACLE_CASES:
            fn, args, cfg = oracle_args(case, device)
            fused = fn(*args, cfg)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            oracle = fn(*args, dataclasses.replace(cfg, solver="autodiff"))
            torch.cuda.synchronize()
            err, breaches = oracle_errors(fused, oracle)
            if "vertex" in case and not bool(
                    (oracle.R == case["vertex"]).all().item()):
                breaches.append(f"not every user on vertex R = "
                                f"{case['vertex']}")
            cases[case["name"]] = dict(X=case["X"], oracle_s=(
                time.perf_counter() - t0), **err)
            bad += [f"{case['name']}: {b}" for b in breaches]
        sc = get_scenario("megafleet_100k").replace(num_users=ORACLE_USERS)
        planner_mod.solve_ligd_batch = spy(solve_l)
        planner_mod.solve_mligd_batch = spy(solve_m)
        try:
            sess = Session(sc)
            sess.run()
            torch.cuda.synchronize()
        finally:
            planner_mod.solve_ligd_batch = solve_l
            planner_mod.solve_mligd_batch = solve_m
        mega = []
        for fn, profile, tensors, cfg, fused, launched in calls:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            oracle = fn(profile, *tensors,
                        dataclasses.replace(cfg, solver="autodiff"))
            torch.cuda.synchronize()
            oracle_s = time.perf_counter() - t0
            kind = "mligd" if hasattr(oracle, "R") else "ligd"
            if len(launched) != 1:
                bad.append(f"megafleet {kind} call: {len(launched)} sweep "
                           "launches, expected 1")
                continue
            err, breaches = oracle_errors(
                fused, oracle, oracle_ties(launched[0], oracle))
            mega.append(dict(kind=kind, X=int(fused.split.shape[0]),
                             oracle_s=oracle_s, **err))
            bad += [f"megafleet {kind} call {len(mega)}: {b}"
                    for b in breaches]
    finally:
        unspy_sweep()
    launches = all_launches(counters)
    held = hold_sweep_launches(sweeps, "[ligd-oracle]")
    rec = dict(cases=cases, megafleet=dict(users=ORACLE_USERS,
                                           calls=mega), launches=launches)
    phase("ligd-oracle", json.dumps(rec))
    if not mega or not any(m["kind"] == "mligd" for m in mega):
        bad.append("megafleet_100k made no Li-GD and MLi-GD solve")
    if bad:
        raise AssertionError("[ligd-oracle]: " + "; ".join(bad))
    return rec, launches, held


# ---------------------------------------------------------------------------
# training: rows 3 and 4's backward kernels, full-width starcoder2-3b
# ---------------------------------------------------------------------------
#: [train-kernels]' attention cases: (B, S, (Hq, Hkv, hd), window, dtype,
#: key offset c: the keys are randn + c); starcoder2-3b's shape, qwen3-8b's
#: GQA ratio 4, 16/8 heads of 64, gemma3-27b's window-1024 local layer at
#: S 2048, float32, and keys that share an offset at the first two shapes
#: (D from the bf16 output breaches GRAD_RMS_TOL in dq there:
#: tests/test_torch_attn_bwd_rounding.py)
TRAIN_ATTN_CASES = (
    (4, 1024, (24, 2, 128), 0, "bfloat16", 0.0),
    (4, 1024, (32, 8, 128), 0, "bfloat16", 0.0),
    (4, 1024, (16, 8, 64), 0, "bfloat16", 0.0),
    (2, 2048, (32, 16, 128), 1024, "bfloat16", 0.0),
    (2, 1024, (24, 2, 128), 0, "float32", 0.0),
    (4, 1024, (24, 2, 128), 0, "bfloat16", 2.0),
    (4, 1024, (24, 2, 128), 0, "bfloat16", 4.0),
    (4, 1024, (32, 8, 128), 0, "bfloat16", 2.0),
    (4, 1024, (32, 8, 128), 0, "bfloat16", 4.0),
    (2, 2560, (16, 1, 256), 2048, "bfloat16", 2.0),
)
#: non-causal attention (the encoder-decoder's encoder and cross
#: attention): seamless-m4t-large-v2's 16/16 heads of 64 at 1024 frames
TRAIN_ATTN_NONCAUSAL = ((4, 1024, (16, 16, 64), "bfloat16", 0.0),)
#: row 3 at a q offset (context-parallel attention: a rank's sequence
#: shard of S/4 q rows against all S keys), forward and backward at
#: offsets 0, S/4 and 3S/4: (B, S, (Hq, Hkv, hd), window, dtype) at
#: starcoder2-3b's, recurrentgemma-9b's (window 2048) and granite's
#: heads, in bfloat16 (tensor cores) and float32 (CUDA cores), each held
#: against its plain version under ATTN_TOL / ATTN_RMS_TOL and GRAD_TOL /
#: GRAD_RMS_TOL, with SDPA given the same boolean mask beside it
TRAIN_ATTN_OFFSET_CASES = (
    (1, 4096, (24, 2, 128), 0, "bfloat16"),
    (1, 4096, (16, 1, 256), 2048, "bfloat16"),
    (1, 4096, (16, 8, 64), 1024, "bfloat16"),
    (1, 4096, (24, 2, 128), 0, "float32"),
    (1, 4096, (16, 1, 256), 2048, "float32"),
    (1, 4096, (16, 8, 64), 1024, "float32"),
)
#: [train-kernels]' expert SwiGLU backward cases (E, C, d, ff, dtype):
#: granite-moe-1b-a400m's training shape (C = capacity_for(4096)), a
#: decode-sized capacity, and float32
TRAIN_MOE_CASES = ((32, 1280, 1024, 512, "bfloat16"),
                   (32, 4, 1024, 512, "bfloat16"),
                   (4, 100, 256, 128, "float32"))
#: the RG-LRU scan backward at recurrentgemma-9b's training shape (B, S,
#: C), with a near 1 and a near 0
TRAIN_RGLRU_CASES = ((2, 2560, 4096, 1.0), (2, 2560, 4096, 0.0))
#: the WKV6 backward at rwkv6-3b's training shape (B, S, H, n, dtype,
#: from a nonzero state with its gradient), w = 0 and w = 1 entries in
#: every case; S 1024 runs the chunked body, S 64 (the longest that
#: backward.body_for leaves to it) the serial one
TRAIN_WKV_CASES = ((4, 1024, 40, 64, "bfloat16", False),
                   (4, 1024, 40, 64, "bfloat16", True),
                   (4, 64, 40, 64, "bfloat16", True))
#: operations a state element a step that the WKV6 backward needs: the
#: recurrence's re-run (a multiply and a multiply-add), Ĝ's update (the
#: same two) and one multiply-add each for S·dy, Ĝ·v, Ĝᵀ·k and Ĝ ⊙ S
#: (the forward's count is 3); the serial body of csrc/wkv6_bwd.cu issues
#: 12 (it re-runs the recurrence twice, and both thread halves update Ĝ),
#: the chunked body about 8 plus the sums inside each 16-step sub-chunk
WKV_BWD_OPS = 8
#: [train-kernels]' RMSNorm cases: starcoder2-3b's norms at B 4 x S 1024,
#: qwen3-8b's qk-norm rows (4 x 1024 tokens x 32 heads, 128 wide), and
#: the norms in float32
TRAIN_RMS_CASES = ((4096, 3072, "bfloat16"), (131072, 128, "bfloat16"),
                   (4096, 3072, "float32"))
#: [train]: full-width starcoder2-3b, B 4 x S 1024, remat, 4 AdamW steps
TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS = 4, 1024, 4
#: the predicted peak device memory of [train] (GB): bf16
#: weights and gradients and float32 m and v (12 bytes a parameter,
#: 51.8 GB), saved block inputs, one block's recompute and the logits
TRAIN_PEAK_PREDICTED_GB = (55.0, 60.0)
#: the four families' full-width training phases: (tag, config, layers
#: kept (None: all), batch, sequence, AdamW steps, predicted peak GB).
#: The peaks were predicted before the first run as 12 bytes a parameter
#: (bf16 weights and gradients, float32 m and v) plus the loss head
#: (about three float32 copies of the B·S x vocab logits) or AdamW's
#: float32 temporaries on the largest leaf, whichever is larger, plus
#: saved block inputs and one block's recompute.  recurrentgemma-9b
#: keeps 12 of its 38 layers (4 periods of rglru, rglru, local at full
#: width): all 38 would need 103 GB for weights and optimiser state
#: alone.  Its 2560-token sequences pass its 2048-token window.
TRAIN_FAMILIES = (
    ("train-moe", "granite-moe-1b-a400m", None, 4, 1024, 3, (17.0, 24.0)),
    ("train-rwkv", "rwkv6-3b", None, 4, 1024, 3, (38.0, 46.0)),
    ("train-hybrid", "recurrentgemma-9b", 12, 2, 2560, 3, (50.0, 66.0)),
    ("train-enc-dec", "seamless-m4t-large-v2", None, 4, 1024, 3,
     (28.0, 42.0)),
)
#: [train-cross]: card against CPU on one reduced float32 model: the loss
#: to 1e-5 relative; every gradient leaf to 1e-4 in error RMS over the
#: CPU's RMS (float32 math summed in other orders, as the CPU tests hold
#: the port to the reference); the updated parameters' change to 1e-2 of
#: its own RMS per leaf (AdamW's first step moves an element by about
#: lr x sign(g), so a gradient within rounding of zero may move it the
#: other way; every other element agrees to the gradients' precision)
TRAIN_CROSS_LOSS_RTOL = 1e-5
TRAIN_CROSS_GRAD_RMS = 1e-4
TRAIN_CROSS_UPDATE_RMS = 1e-2
#: the launcher's resumed run against its straight-through run on the
#: card: the final loss to 1e-3 relative (the embedding's backward may
#: add its rows in another order on a rerun); the phase reports whether
#: the two are also equal bit for bit
TRAIN_RESUME_RTOL = 1e-3
#: [train-cross]'s reduced float32 model of each later family (kwargs of
#: ``configs.reduced``): granite-moe's experts (4, top 2; the float32
#: expert SwiGLU backward), rwkv6's 64-wide heads (its 128-token
#: sequences run the chunked forward), recurrentgemma's (rglru, rglru,
#: local) with heads of 256 (the float32 attention backward at head_dim
#: 256) and an 8-token window, and seamless-m4t's encoder and cross
#: attention
TRAIN_CROSS_FAMILIES = (
    ("granite-moe-1b-a400m", dict(layers=2, d_model=256, heads=4,
                                  kv_heads=2, d_ff=128)),
    ("rwkv6-3b", dict(layers=2, d_model=256, heads=4, d_ff=512)),
    ("recurrentgemma-9b", dict(layers=3, d_model=512, heads=2, kv_heads=1,
                               d_ff=512)),
    ("seamless-m4t-large-v2", dict(layers=2, d_model=256, heads=4,
                                   kv_heads=4, d_ff=512)),
)


def train_kernel_cases(device) -> dict:
    """[train-kernels]: each backward kernel against float32 autograd
    through its plain version on the card, at GRAD_TOL / GRAD_RMS_TOL,
    twice (the two runs must give the same bits), with its time (median
    of 30, CUDA events), the plain backward's, the library backward's
    (``F.scaled_dot_product_attention`` with ``enable_gqa`` and the
    window mask; ``F.rms_norm``) and the bound.  Returns the records of
    the main-path cases (starcoder2-3b's shapes), ``max_abs_err`` the
    largest over each kernel's cases."""
    import torch
    g = torch.Generator(device=device).manual_seed(12)

    def randn(shape, dt):
        return torch.randn(shape, generator=g, device=device).to(dt)

    out, breaches = {}, []
    errs = {"flash_attention_bwd": [], "rmsnorm_bwd": [],
            "moe_swiglu_bwd": [], "rglru_scan_bwd": [], "wkv6_bwd": []}
    fwd_errs = []
    for B, S, heads, window, dtn in TRAIN_ATTN_OFFSET_CASES:
        for q_offset in (0, S // 4, 3 * S // 4):
            rec = attention_bwd_case(device, randn, B, S, heads, window,
                                     dtn, breaches, q_offset=q_offset)
            fwd_errs.append(rec["fwd"]["max_abs_err"])
            errs["flash_attention_bwd"].append(rec["max_abs_err"])
    out["flash_attention_offset_fwd_err"] = max(fwd_errs)
    for B, S, heads, window, dtn, c in TRAIN_ATTN_CASES:
        rec = attention_bwd_case(device, randn, B, S, heads, window, dtn,
                                 breaches, key_offset=c)
        errs["flash_attention_bwd"].append(rec["max_abs_err"])
        if (B, S, heads, dtn, c) == (4, 1024, (24, 2, 128), "bfloat16", 0.0):
            out["flash_attention_bwd"] = rec
        if heads[2] == 256:
            out["flash_attention_bwd_hd256"] = rec
    for B, S, heads, dtn, c in TRAIN_ATTN_NONCAUSAL:
        rec = attention_bwd_case(device, randn, B, S, heads, 0, dtn,
                                 breaches, key_offset=c, causal=False)
        errs["flash_attention_bwd"].append(rec["max_abs_err"])
    for E, C, d, ff, dtn in TRAIN_MOE_CASES:
        rec = moe_bwd_case(randn, E, C, d, ff, dtn, breaches)
        errs["moe_swiglu_bwd"].append(rec["max_abs_err"])
        if (C, dtn) == (1280, "bfloat16"):
            out["moe_swiglu_bwd"] = rec
    for B, S, C, a_near in TRAIN_RGLRU_CASES:
        rec = rglru_bwd_case(device, g, B, S, C, a_near, breaches)
        errs["rglru_scan_bwd"].append(rec["max_abs_err"])
        if a_near == 1.0:
            out["rglru_scan_bwd"] = rec
    for B, S, H, n, dtn, with_s0 in TRAIN_WKV_CASES:
        rec = wkv6_bwd_case(device, g, B, S, H, n, dtn, with_s0, breaches)
        errs["wkv6_bwd"].append(rec["max_abs_err"])
        if not with_s0:
            out["wkv6_bwd"] = rec
        if rec["body"] == "serial":
            serial = rec
    out["wkv6_bwd"]["serial"] = {k: serial[k] for k in (
        "S", "max_abs_err", "rel_rms_err", "ms", "device_ms", "plain_ms",
        "bound_ms")}
    for rows, d, dtn in TRAIN_RMS_CASES:
        rec = rmsnorm_bwd_case(randn, rows, d, dtn, breaches)
        errs["rmsnorm_bwd"].append(rec["max_abs_err"])
        if (rows, d, dtn) == (4096, 3072, "bfloat16"):
            out["rmsnorm_bwd"] = rec
    for name, e in errs.items():
        out[name]["max_abs_err"] = max(e)
    if breaches:
        raise AssertionError("[train-kernels]: " + "; ".join(breaches))
    return out


def _hold_grads(label, got, want, dtn, breaches) -> tuple:
    """grad_errors over pairs of gradients: (max abs error, largest rel
    RMS); a breach is appended to ``breaches``."""
    err = rr = 0.0
    for name, a, b in zip(("d" + n for n in label), got, want):
        e, r, ok = grad_errors(a, b, dtn)
        err, rr = max(err, e), max(rr, r)
        if not ok:
            breaches.append(f"{name}: max {e:.3g}, rel RMS {r:.3g}")
    return err, rr


def key_band(Sq: int, Skv: int, causal: bool, window: int,
             q_offset: int = 0) -> int:
    """Keys that some query row reaches under the masks (row i at key
    position q_offset + i): the k/v rows a bound counts as read."""
    lo = max(0, q_offset - window + 1) if window else 0
    hi = min(Skv, q_offset + Sq) if causal else Skv
    return max(hi - lo, 0)


def attention_bwd_case(device, randn, B, S, heads, window, dtn,
                       breaches, key_offset: float = 0.0,
                       causal: bool = True, q_offset=None) -> dict:
    """The attention backward kernel at one shape (``heads`` = (Hq, Hkv,
    hd); keys randn + ``key_offset``; causal unless ``causal`` is False)
    on the forward kernel's output: in bf16 the training forward's (with
    LSE and residual), whose output must equal the serving forward's bit
    for bit.  With ``q_offset`` (context-parallel attention), S/4 query
    rows at key positions q_offset.. against all S keys, and the forward
    too: held against its plain version under ATTN_TOL / ATTN_RMS_TOL and
    timed beside SDPA given the same boolean mask (``attn_mask``).  The
    bounds count the pairs the masks leave (``ops.pairs``) at the type's
    peak (bf16 tensor cores, float32 CUDA cores) and the bytes of q, the
    output, the keys some row reaches (``key_band``) and dk/dv whole."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels.flash_attention import backward as fb
    from repro_torch.kernels.flash_attention.ops import pairs
    Hq, Hkv, hd = heads
    dt = getattr(torch, dtn)
    Sq, off = (S, 0) if q_offset is None else (S // 4, q_offset)
    label = (f"attention bwd {B}x{S} {heads} w{window} {dtn} "
             f"c{key_offset:g}{'' if causal else ' non-causal'}"
             + ("" if q_offset is None else f" q {Sq}@{off}"))
    q = randn((B, Sq, Hq, hd), dt)
    k = (randn((B, S, Hkv, hd), torch.float32) + key_offset).to(dt)
    v, dout = randn((B, S, Hkv, hd), dt), randn((B, Sq, Hq, hd), dt)
    kw = dict(causal=causal, window=window)
    if q_offset is not None:
        kw["q_offset"] = q_offset
    o = fa.flash_attention_cuda(q, k, v, **kw)
    body = fb.body_for(dt, hd)
    out_same, kw_b = None, kw
    if dt == torch.bfloat16:
        o_t, lse, o_lo = fa.flash_attention_cuda(q, k, v, stats=True, **kw)
        out_same = torch.equal(o_t, o)
        if not out_same:
            breaches.append(f"{label}: the training forward's output "
                            "differs from the serving forward's")
        kw_b = dict(kw, lse=lse, out_lo=o_lo)
        del o_t
    fwd = None
    if q_offset is not None:
        want = fa.attention_ref(q, k, v, **kw).float()
        fwd = dict(max_abs_err=(o.float() - want).abs().max().item(),
                   rel_rms_err=rel_rms(o.float(), want))
        tol, rms_tol = ATTN_TOL[dtn], ATTN_RMS_TOL[dtn]
        if not (torch.allclose(o.float(), want, atol=tol, rtol=tol)
                and fwd["rel_rms_err"] <= rms_tol):
            breaches.append(
                f"{label} forward: max {fwd['max_abs_err']:.3g} (tol "
                f"{tol}), error RMS / output RMS {fwd['rel_rms_err']:.3g} "
                f"(tol {rms_tol})")
        del want
    before = dict(fb.LAUNCHES)
    got = fb.flash_attention_bwd_cuda(q, k, v, o, dout, **kw_b)
    again = fb.flash_attention_bwd_cuda(q, k, v, o, dout, **kw_b)
    torch.cuda.synchronize()
    ran_tc = fb.LAUNCHES["flash_attention_bwd_tc"] - before[
        "flash_attention_bwd_tc"]
    if ran_tc != (2 if body == "tensor_cores" else 0):
        breaches.append(f"{label}: {ran_tc} tensor-core launches for the "
                        f"{body} body")
    same = all(torch.equal(a, b) for a, b in zip(got, again))
    if not same:
        breaches.append(f"{label}: two runs differ")
    leaves = [t.float().requires_grad_() for t in (q, k, v)]
    want = torch.autograd.grad(fa.attention_ref(*leaves, **kw), leaves,
                               dout.float())
    sub = []
    err, rr = _hold_grads("qkv", got, want, dtn, sub)
    breaches.extend(f"{label} {b}" for b in sub)
    rr_by = {f"d{n}": grad_errors(a, b, dtn)[1]
             for n, a, b in zip("qkv", got, want)}
    del got, again, want, leaves
    qh, kh, vh = (t.transpose(1, 2).detach().requires_grad_()
                  for t in (q, k, v))
    mask = None
    if window or q_offset is not None:
        qp = off + torch.arange(Sq, device=device)[:, None]
        kp = torch.arange(S, device=device)[None, :]
        mask = (qp >= kp) & ((qp - kp < window) if window else True)
    lib_ms = lib_fwd_ms = None
    try:
        def library():
            return F.scaled_dot_product_attention(
                qh, kh, vh, attn_mask=mask,
                is_causal=causal and mask is None, enable_gqa=True)
        if fwd is not None:
            lib_fwd_ms = timed_ms(lambda: library().detach(), 30, 3)
        lo = library()
        dh = dout.transpose(1, 2)
        lib_ms = timed_ms(lambda: torch.autograd.grad(
            lo, (qh, kh, vh), dh, retain_graph=True), 30, 3)
        del lo
    except TypeError:        # a PyTorch without enable_gqa
        pass
    n = pairs(Sq, S, causal, window, off)
    flops = 4.0 * B * Hq * hd * n
    peak = PEAK_BF16_S if dt == torch.bfloat16 else PEAK_FP32_S
    es = q.element_size()
    band = B * key_band(Sq, S, causal, window, off) * Hkv * hd
    t_ops = 2.5 * flops / peak * 1e3
    t_bytes = (4 * q.numel() + 2 * band + 2 * k.numel()) * es \
        / PEAK_BYTES_S * 1e3
    call = (lambda: fb.flash_attention_bwd_cuda(q, k, v, o, dout, **kw_b))
    rec = dict(
        B=B, S=S, Sq=Sq, q_offset=q_offset, Hq=Hq, Hkv=Hkv, hd=hd,
        window=window, dtype=dtn, causal=causal, key_offset=key_offset,
        body=body, pairs=n,
        nsplit=(fb.group_split(B, Sq, S, Hq, Hkv, causal, window, hd, off)
                if body == "tensor_cores" else None),
        max_abs_err=err, rel_rms_err=rr, rel_rms_by_grad=rr_by,
        same_bits=same, out_same_bits=out_same,
        ms=timed_ms(call, 30, 3), device_ms=device_ms(call, 30, 3),
        plain_ms=timed_ms(lambda: fa.attention_bwd_ref(q, k, v, o, dout,
                                                       **kw_b), 5, 1),
        library_ms=lib_ms, flops=2.5 * flops, bound_ms=max(t_ops, t_bytes),
        bound_by="operations" if t_ops >= t_bytes else "bytes")
    rec["tflop_per_s"] = 2.5 * flops / (rec["ms"] * 1e-3) / 1e12
    if fwd is not None:
        f_ops = flops / peak * 1e3
        f_bytes = (2 * q.numel() + 2 * band) * es / PEAK_BYTES_S * 1e3
        fwd.update(
            ms=timed_ms(lambda: fa.flash_attention_cuda(q, k, v, **kw),
                        30, 3),
            plain_ms=timed_ms(lambda: fa.attention_ref(q, k, v, **kw), 5,
                              1),
            library_ms=lib_fwd_ms, bound_ms=max(f_ops, f_bytes),
            bound_by="operations" if f_ops >= f_bytes else "bytes")
        rec["fwd"] = fwd
    phase("train-kernels", "flash_attention_bwd " + json.dumps(rec))
    return rec


def moe_bwd_case(randn, E: int, C: int, d: int, ff: int, dtn: str,
                 breaches) -> dict:
    """The fused expert SwiGLU backward kernel at one shape against
    float32 autograd through the plain forward, twice for the same bits;
    its bound counts the function's 12·E·C·d·ff operations (dH, dWd, dx's
    two, dWg, dWu), not the kernel's recomputation of x·Wg and x·Wu."""
    import torch
    from repro_torch.kernels import moe_gemm as mg
    from repro_torch.kernels.moe_gemm import backward as mb
    dt = getattr(torch, dtn)
    label = f"moe bwd E{E} C{C} d{d} ff{ff} {dtn}"
    x, dy = randn((E, C, d), torch.float32).to(dt), \
        randn((E, C, d), torch.float32).to(dt)
    wg = (randn((E, d, ff), torch.float32) * d ** -0.5).to(dt)
    wu = (randn((E, d, ff), torch.float32) * d ** -0.5).to(dt)
    wd = (randn((E, ff, d), torch.float32) * ff ** -0.5).to(dt)
    body = mb.body_for(dt, C, d, ff)
    before = dict(mb.LAUNCHES)
    got = mb.moe_swiglu_bwd_cuda(x, wg, wu, wd, dy)
    again = mb.moe_swiglu_bwd_cuda(x, wg, wu, wd, dy)
    torch.cuda.synchronize()
    ran_tc = mb.LAUNCHES["moe_swiglu_bwd_tc"] - before["moe_swiglu_bwd_tc"]
    if ran_tc != (2 if body == "wgmma" else 0):
        breaches.append(f"{label}: {ran_tc} wgmma launches for the {body} "
                        "body")
    same = all(torch.equal(a, b) for a, b in zip(got, again))
    if not same:
        breaches.append(f"{label}: two runs differ")
    leaves = [t.float().requires_grad_() for t in (x, wg, wu, wd)]
    want = torch.autograd.grad(mg.moe_swiglu_ref(*leaves), leaves,
                               dy.float())
    sub = []
    err, rr = _hold_grads(("x", "wg", "wu", "wd"), got, want, dtn, sub)
    breaches.extend(f"{label} {b}" for b in sub)
    del got, again, want, leaves
    flops = 12.0 * E * C * d * ff
    peak = PEAK_BF16_S if dtn == "bfloat16" else PEAK_FP32_S
    t_ops = flops / peak * 1e3
    t_bytes = 2 * (2 * x.numel() + 3 * wg.numel()) * x.element_size() \
        / PEAK_BYTES_S * 1e3
    xl, gl, ul, dl = (t.detach().requires_grad_() for t in (x, wg, wu, wd))

    def library():
        import torch.nn.functional as F
        yl = torch.bmm(F.silu(torch.bmm(xl, gl)) * torch.bmm(xl, ul), dl)
        return torch.autograd.grad(yl, (xl, gl, ul, dl), dy)

    call = (lambda: mb.moe_swiglu_bwd_cuda(x, wg, wu, wd, dy))
    rec = dict(
        E=E, C=C, d=d, ff=ff, dtype=dtn, body=body,
        max_abs_err=err, rel_rms_err=rr, same_bits=same, flops=flops,
        ms=timed_ms(call, 30, 3), device_ms=device_ms(call, 30, 3),
        plain_ms=timed_ms(lambda: mg.moe_swiglu_bwd_ref(x, wg, wu, wd, dy),
                          10, 2),
        library_ms=timed_ms(library, 30, 3),
        library_call="composition: autograd of 3 torch.bmm + silu (no "
        "single call)",
        bound_ms=max(t_ops, t_bytes),
        bound_by="operations" if t_ops >= t_bytes else "bytes")
    rec["tflop_per_s"] = flops / (rec["ms"] * 1e-3) / 1e12
    phase("train-kernels", "moe_swiglu_bwd " + json.dumps(rec))
    return rec


def rglru_bwd_case(device, g, B: int, S: int, C: int, a_near: float,
                   breaches) -> dict:
    """The RG-LRU scan backward kernel at one shape (a within 1e-3 of 1 or
    of 0) against float32 autograd through the plain scan, twice for the
    same bits; bound by its 20 bytes an element."""
    import torch
    from repro_torch.kernels import rglru as rg
    from repro_torch.kernels.rglru import backward as gb
    label = f"rglru bwd {B}x{S}x{C} a~{a_near:g}"
    jitter = torch.rand((B, S, C), generator=g, device=device) * 1e-3
    a = 1.0 - jitter if a_near == 1.0 else jitter
    b = torch.randn((B, S, C), generator=g, device=device)
    dh = torch.randn((B, S, C), generator=g, device=device)
    h = rg.rglru_scan_cuda(a, b)
    got = gb.rglru_scan_bwd_cuda(a, h, dh)
    again = gb.rglru_scan_bwd_cuda(a, h, dh)
    torch.cuda.synchronize()
    same = all(torch.equal(x, y) for x, y in zip(got, again))
    if not same:
        breaches.append(f"{label}: two runs differ")
    leaves = [a.clone().requires_grad_(), b.clone().requires_grad_()]
    want = torch.autograd.grad(rg.rglru_scan_ref(*leaves), leaves, dh)
    sub = []
    err, rr = _hold_grads(("a", "b"), got, want, "float32", sub)
    breaches.extend(f"{label} {x}" for x in sub)
    del got, again, want, leaves
    nbytes = 20 * a.numel()
    call = (lambda: gb.rglru_scan_bwd_cuda(a, h, dh))
    rec = dict(
        B=B, S=S, C=C, a_near=a_near, max_abs_err=err, rel_rms_err=rr,
        same_bits=same, ms=timed_ms(call, 30, 3),
        device_ms=device_ms(call, 30, 3), by_kernel_us=by_kernel(call),
        plain_ms=timed_ms(lambda: rg.rglru_scan_bwd_ref(a, h, dh), 3, 1),
        library_ms=None, bound_ms=nbytes / PEAK_BYTES_S * 1e3,
        bound_by="bytes")
    rec["tb_per_s"] = nbytes / (rec["ms"] * 1e-3) / 1e12
    phase("train-kernels", "rglru_scan_bwd " + json.dumps(rec))
    return rec


def wkv6_bwd_case(device, g, B: int, S: int, H: int, n: int, dtn: str,
                  with_s0: bool, breaches) -> dict:
    """The WKV6 backward kernel at one shape against float32 autograd
    through the plain recurrence, twice for the same bits: bf16 r/k/v,
    float32 w with entries exactly 0 and 1, from a nonzero state with the
    final state's gradient (and ds0) when ``with_s0``; bound by
    WKV_BWD_OPS operations a state element a step."""
    import torch
    from repro_torch.kernels import wkv6 as wk
    from repro_torch.kernels.wkv6 import backward as wb
    dt = getattr(torch, dtn)
    label = f"wkv6 bwd {B}x{S}x{H}x{n} {dtn}{' s0' if with_s0 else ''}"

    def rn(shape, scale=1.0):
        return torch.randn(shape, generator=g, device=device) * scale

    r, k, v = (rn((B, S, H, n), 0.5).to(dt) for _ in range(3))
    w = torch.rand((B, S, H, n), generator=g, device=device)
    w[..., ::7] = 0.0
    w[..., 3::11] = 1.0
    u, dy = rn((H, n), 0.5), rn((B, S, H, n))
    s0 = rn((B, H, n, n), 0.5) if with_s0 else None
    ds = rn((B, H, n, n)) if with_s0 else None
    body = wb.body_for(S, n)
    before = dict(wb.LAUNCHES)
    got = wb.wkv6_bwd_cuda(r, k, v, w, u, s0, dy, ds)
    again = wb.wkv6_bwd_cuda(r, k, v, w, u, s0, dy, ds)
    torch.cuda.synchronize()
    if body_of(wb.LAUNCHES, before, "wkv6_bwd_") != body:
        breaches.append(f"{label}: not the {body} body")
    same = all((x is None and y is None) or torch.equal(x, y)
               for x, y in zip(got, again))
    if not same:
        breaches.append(f"{label}: two runs differ")
    leaves = [t.float().requires_grad_() for t in (r, k, v, w, u)]
    if with_s0:
        leaves.append(s0.clone().requires_grad_())
    y, s_fin = wk.wkv6_ref(*leaves[:5], leaves[5] if with_s0 else None)
    outs, grads = ([y, s_fin], [dy, ds]) if with_s0 else ([y], [dy])
    want = torch.autograd.grad(outs, leaves, grads)
    del y, s_fin, outs
    names = ("r", "k", "v", "w", "u", "s0")
    sub = []
    err, rr = _hold_grads(names, [t for t in got if t is not None], want,
                          dtn, sub)
    breaches.extend(f"{label} {x}" for x in sub)
    del got, again, want, leaves
    ops = float(WKV_BWD_OPS) * B * S * H * n * n
    t_ops = ops / ISSUE_S * 1e3
    t_bytes = (r.numel() * (6 * r.element_size() + 12)
               + (4 * s0.numel() * 4 if with_s0 else 0)
               + 2 * u.numel() * 4) / PEAK_BYTES_S * 1e3
    call = (lambda: wb.wkv6_bwd_cuda(r, k, v, w, u, s0, dy, ds))
    rec = dict(
        B=B, S=S, H=H, n=n, dtype=dtn, with_s0=with_s0, body=body,
        w_zero_share=(w == 0).float().mean().item(),
        w_one_share=(w == 1).float().mean().item(), max_abs_err=err,
        rel_rms_err=rr, same_bits=same, state_ops=ops,
        workspace_mb=wb.workspace_bytes(B, S, H, n, body) / 1e6,
        ms=timed_ms(call, 10, 2), device_ms=device_ms(call, 10, 2),
        by_kernel_us=by_kernel(call),
        plain_ms=timed_ms(lambda: wk.wkv6_bwd_ref(r, k, v, w, u, s0, dy,
                                                  ds), 2, 1),
        library_ms=None, bound_ms=max(t_ops, t_bytes),
        bound_by="operations" if t_ops >= t_bytes else "bytes",
        bound_ops_ms=t_ops, bound_bytes_ms=t_bytes)
    phase("train-kernels", "wkv6_bwd " + json.dumps(rec))
    return rec


def rmsnorm_bwd_case(randn, rows: int, d: int, dtn: str, breaches) -> dict:
    """The RMSNorm backward kernel at one shape (eps 1e-6)."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import rmsnorm as rn
    from repro_torch.kernels.rmsnorm import backward as rb
    eps = 1e-6
    dt = getattr(torch, dtn)
    x, w, gy = randn((rows, d), dt), randn((d,), dt), randn((rows, d), dt)
    got = rb.rmsnorm_bwd_cuda(x, w, gy, eps)
    again = rb.rmsnorm_bwd_cuda(x, w, gy, eps)
    torch.cuda.synchronize()
    same = all(torch.equal(a, b) for a, b in zip(got, again))
    if not same:
        breaches.append(f"rmsnorm bwd {rows}x{d} {dtn}: two runs differ")
    xf, wf = x.float().requires_grad_(), w.float().requires_grad_()
    want = torch.autograd.grad(rn.rmsnorm_ref(xf, wf, eps), (xf, wf),
                               gy.float())
    sub = []
    err, rr = _hold_grads(("x", "w"), got, want, dtn, sub)
    breaches.extend(f"rmsnorm bwd {rows}x{d} {dtn} {b}" for b in sub)
    xl = x.detach().requires_grad_()
    wl = (1.0 + w.float()).to(dt).requires_grad_()
    yl = F.rms_norm(xl, (d,), wl, eps)
    nbytes = (3 * rows * d + 2 * d) * x.element_size()
    tpr, v, nblocks = rb.launch_shape(rows, d, x.element_size())
    call = (lambda: rb.rmsnorm_bwd_cuda(x, w, gy, eps))
    rec = dict(
        rows=rows, d=d, dtype=dtn, max_abs_err=err, rel_rms_err=rr,
        same_bits=same, body=f"{tpr} threads a row x {v} vectors, "
        f"{nblocks} blocks",
        ms=timed_ms(call, 30, 3), device_ms=device_ms(call, 30, 3),
        plain_ms=timed_ms(lambda: rn.rmsnorm_bwd_ref(x, w, gy, eps), 30,
                          3),
        library_ms=timed_ms(lambda: torch.autograd.grad(
            yl, (xl, wl), gy, retain_graph=True), 30, 3),
        bound_ms=nbytes / PEAK_BYTES_S * 1e3, bound_by="bytes")
    rec["tb_per_s"] = nbytes / (rec["ms"] * 1e-3) / 1e12
    phase("train-kernels", "rmsnorm_bwd " + json.dumps(rec))
    return rec


@contextlib.contextmanager
def plain_version_calls():
    """Count calls of every language-model kernel's plain versions
    (attention, RMSNorm, the expert SwiGLU, the RG-LRU scan, WKV6) through
    their ``ops`` modules (forward and backward) for a ``with`` block;
    yields the dict of counts."""
    from repro_torch.kernels.flash_attention import ops as fops
    from repro_torch.kernels.moe_gemm import ops as mops
    from repro_torch.kernels.rglru import ops as gops
    from repro_torch.kernels.rmsnorm import ops as rops
    from repro_torch.kernels.wkv6 import ops as wops
    names = ((fops, "attention_ref"), (fops, "attention_bwd_ref"),
             (rops, "rmsnorm_ref"), (rops, "rmsnorm_bwd_ref"),
             (mops, "moe_swiglu_ref"), (mops, "moe_swiglu_bwd_ref"),
             (gops, "rglru_scan_ref"), (gops, "rglru_scan_bwd_ref"),
             (wops, "wkv6_ref"), (wops, "wkv6_bwd_ref"))
    calls = dict.fromkeys((n for _, n in names), 0)
    saved = [(mod, n, getattr(mod, n)) for mod, n in names]

    def spy(n, fn):
        def wrapped(*a, **kw):
            calls[n] += 1
            return fn(*a, **kw)
        return wrapped

    for mod, n, fn in saved:
        setattr(mod, n, spy(n, fn))
    try:
        yield calls
    finally:
        for mod, n, fn in saved:
            setattr(mod, n, fn)


def train_launches_per_step(cfg, B: int, S: int, remat: bool = True,
                            src_len: int = 0, moe_rows: int = 0) -> dict:
    """The kernel launches (the non-zero counts of ``kernel_counters``)
    that one ``loss_fn`` forward and backward makes for ``cfg`` at batch
    B x S tokens (an encoder-decoder's source ``src_len`` frames, S if
    0; an MoE's buffer ``moe_rows`` rows an expert, capacity_for(B·S) if
    0): each block's kernels forward twice under ``remat`` (its own run
    and the recompute) and backward once, the encoder's too, with each
    body's count (attention's tensor cores for bf16, forward and
    backward; the MoE's by capacity, forward and backward; WKV6's by S,
    forward and backward); the final norm (and an encoder's enc_norm)
    once each way."""
    import torch
    from repro_torch.configs.base import RGLRU, RWKV6
    from repro_torch.kernels.flash_attention import backward as fb
    from repro_torch.kernels.moe_gemm import backward as mb
    from repro_torch.kernels.moe_gemm import kernel as mk
    from repro_torch.kernels.wkv6 import backward as wb
    from repro_torch.kernels.wkv6 import kernel as wk
    from repro_torch.models.moe import capacity_for
    from repro_torch.models.transformer import CAPACITY_FACTOR, encoder_cfg
    dt = getattr(torch, cfg.dtype)
    f = 2 if remat else 1
    n = {}

    def add(name, times):
        n[name] = n.get(name, 0) + times

    def attention(c):
        add("flash_attention", f)
        if dt == torch.bfloat16:
            add("flash_attention_tc", f)
        add("flash_attention_bwd", 1)
        if fb.body_for(dt, c.head_dim) == "tensor_cores":
            add("flash_attention_bwd_tc", 1)

    def norms(k):
        add("rmsnorm", f * k)
        add("rmsnorm_bwd", k)

    stacks = [(cfg, S)]
    if cfg.enc_dec:
        stacks.insert(0, (encoder_cfg(cfg), src_len or S))
        add("rmsnorm", 1)                   # enc_norm, outside the blocks
        add("rmsnorm_bwd", 1)
    for c, length in stacks:
        for lt in c.layer_types():
            norms(2)
            if lt == RWKV6:
                add("wkv6", f)
                add("wkv6_" + wk.body_for(length, c.rwkv_head_dim), f)
                add("wkv6_bwd", 1)
                add("wkv6_bwd_" + wb.body_for(length, c.rwkv_head_dim), 1)
                continue
            if lt == RGLRU:
                add("rglru_scan", f)
                add("rglru_scan_bwd", 1)
            else:
                attention(c)
                if c.qk_norm:
                    norms(2)
            if c.enc_dec:                   # a decoder block's cross
                attention(c)
                norms(1)
            if c.num_experts:
                cap = moe_rows or capacity_for(B * length, c,
                                               CAPACITY_FACTOR)
                add("moe_swiglu", f)
                add("moe_swiglu_" + mk.body_for(dt, cap, c.d_model, c.d_ff),
                    f)
                add("moe_swiglu_bwd", 1)
                if mb.body_for(dt, cap, c.d_model, c.d_ff) == "wgmma":
                    add("moe_swiglu_bwd_tc", 1)
    add("rmsnorm", 1)                       # final_norm, outside them
    add("rmsnorm_bwd", 1)
    return n


@contextlib.contextmanager
def grads_seen():
    """Record, for each AdamW update in a ``with`` block, each gradient
    leaf's largest magnitude (one device tensor an update, read after
    the block).  Yields the list of those tensors."""
    import torch
    from repro_torch._tree import leaves
    from repro_torch.optim import adamw
    update, seen = adamw.update, []

    def spy(cfg, grads, *a, **kw):
        seen.append(torch.stack([g.detach().abs().amax().float()
                                 for g in leaves(grads)]))
        return update(cfg, grads, *a, **kw)

    adamw.update = spy
    try:
        yield seen
    finally:
        adamw.update = update


def train_full_width(device, counters, tag: str = "train",
                     arch: str = "starcoder2-3b", layers=None,
                     batch_size: int = TRAIN_BATCH, seq: int = TRAIN_SEQ,
                     n_steps: int = TRAIN_STEPS,
                     predicted_gb=TRAIN_PEAK_PREDICTED_GB) -> tuple:
    """[train] (and each of TRAIN_FAMILIES): ``arch`` at full width (and
    full depth unless ``layers`` cuts it; random weights from a seed),
    batch_size x seq tokens (an encoder-decoder as many source frames),
    remat, ``n_steps`` AdamW steps through ``make_train_step``, after
    ``release_memory()``.  Every count is zeroed just before each step
    and read just after it, and must equal ``train_launches_per_step``:
    each block's kernels forward twice (its own run and the recompute)
    and backward once, every forward and backward body the one the shape
    picks, and no plain-version call.  Every loss and grad norm must be
    finite and every parameter leaf's gradient non-zero on step 1 (the
    MoE router's through the aux loss among them).  Returns (record,
    launches of the whole run)."""
    import dataclasses
    import math
    import torch
    from repro_torch._tree import leaves
    from repro_torch.configs import get_config
    from repro_torch.models import transformer as tfm
    from repro_torch.optim import adamw
    from repro_torch.optim.schedules import cosine_with_warmup
    from repro_torch.runtime.data import DataConfig, batch_at
    from repro_torch.runtime.train import TrainConfig, make_train_step

    cfg = get_config(arch)
    if layers is not None:
        cfg = dataclasses.replace(cfg, num_layers=layers)
    want = train_launches_per_step(cfg, batch_size, seq)
    live_gb = release_memory()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = tfm.init_lm(cfg, torch.Generator(device).manual_seed(0),
                         device)
    opt = adamw.init(params)
    step_fn = make_train_step(cfg, TrainConfig(remat=True),
                              lr_schedule=cosine_with_warmup(2, 10))
    dcfg = DataConfig(seed=0, seq_len=seq, global_batch=batch_size)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    steps, total_launches, bad = [], {}, []
    with plain_version_calls() as plain, grads_seen() as seen:
        for s in range(n_steps):
            batch = batch_at(cfg, dcfg, s, device)
            torch.cuda.synchronize()
            zero_counters(counters)
            t0 = time.perf_counter()
            params, opt, m = step_fn(params, opt, batch)
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
            launches = all_launches(counters)
            for k, v in launches.items():
                total_launches[k] = total_launches.get(k, 0) + v
            moved = {k: v for k, v in launches.items() if v}
            if moved != want:
                bad.append(f"step {s + 1} launches {moved}, want {want}")
            steps.append(dict(loss=float(m["loss"]), aux=float(m["aux"]),
                              grad_norm=float(m["grad_norm"]), s=dt))
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    zero_grads = int((seen[0] == 0).sum().item())
    n_leaves = len(leaves(params))
    if any(v for v in plain.values()):
        bad.append(f"plain versions called: {plain}")
    if zero_grads:
        bad.append(f"{zero_grads} of {n_leaves} parameter leaves got a "
                   "zero gradient on step 1")
    if not all(math.isfinite(x["loss"]) and math.isfinite(x["grad_norm"])
               for x in steps):
        bad.append(f"non-finite loss or grad norm: {steps}")
    if cfg.num_experts and not all(x["aux"] > 0 for x in steps):
        bad.append(f"MoE aux loss not positive: {steps}")
    warm = sorted(x["s"] for x in steps[1:])
    step_s = warm[len(warm) // 2]
    tokens = batch_size * seq
    n_params = cfg.num_params()
    rec = dict(
        model=cfg.name, layers=cfg.num_layers,
        layers_of_config=get_config(arch).num_layers, params=n_params,
        batch=batch_size, seq=seq, remat=True, steps=steps,
        setup_s=setup_s, step_s_median_after_first=step_s,
        tokens_per_s=tokens / step_s,
        model_flops_share=6.0 * n_params * tokens / step_s / PEAK_BF16_S,
        peak_gb=peak_gb, peak_gb_predicted=list(predicted_gb),
        live_gb_before=live_gb, leaves=n_leaves,
        leaves_with_zero_grad_step1=zero_grads,
        launches_per_step=want, plain_version_calls=plain)
    phase(tag, json.dumps(rec))
    if bad:
        raise AssertionError(f"[{tag}]: " + "; ".join(bad))
    del params, opt, m, batch
    release_memory()
    return rec, total_launches


def _loss_and_grads(cfg, params, batch):
    import torch
    from repro_torch._tree import leaves
    from repro_torch.models import transformer as tfm
    flat = leaves(params)
    for p in flat:
        p.requires_grad_(True)
    total, _ = tfm.loss_fn(cfg, params, batch)
    return float(total.detach()), torch.autograd.grad(total, flat)


def _cross_one(device, counters, cfg, seed: int = 5) -> tuple:
    """One reduced float32 model, card against CPU on the same weights
    and batch (2 x 128 tokens): the loss, every gradient leaf and one
    AdamW step's update; the card's loss-and-gradient launches must be
    ``train_launches_per_step``'s.  Returns (record, launches, problems)."""
    import torch
    from repro_torch._tree import leaves
    from repro_torch.models import transformer as tfm
    from repro_torch.optim import adamw
    from repro_torch.runtime.data import DataConfig, batch_at
    from repro_torch.runtime.train import make_train_step

    cpu_params = tfm.init_lm(cfg, torch.Generator().manual_seed(seed),
                             "cpu")
    cpu_batch = batch_at(cfg, DataConfig(seed=seed, seq_len=128,
                                         global_batch=2), 0, "cpu")
    card_params = to_tree(cpu_params, device=device)
    card_batch = {k: v.to(device) for k, v in cpu_batch.items()}
    zero_counters(counters)
    loss_card, g_card = _loss_and_grads(cfg, card_params, card_batch)
    torch.cuda.synchronize()
    moved = {k: v for k, v in all_launches(counters).items() if v}
    loss_cpu, g_cpu = _loss_and_grads(cfg, cpu_params, cpu_batch)
    grad_rr = max(rel_rms(a.cpu(), b) for a, b in zip(g_card, g_cpu))
    before = [p.detach().clone() for p in leaves(cpu_params)]
    step = make_train_step(cfg)
    card_params, _, _ = step(card_params, adamw.init(card_params),
                             card_batch)
    cpu_params, _, _ = step(cpu_params, adamw.init(cpu_params), cpu_batch)
    update_rr = max(rel_rms(a.detach().cpu() - p0, b.detach() - p0)
                    for a, b, p0 in zip(leaves(card_params),
                                        leaves(cpu_params), before))
    launches = all_launches(counters)
    want = train_launches_per_step(cfg, 2, 128)
    rec = dict(loss_card=loss_card, loss_cpu=loss_cpu,
               loss_rel_diff=abs(loss_card - loss_cpu) / abs(loss_cpu),
               grad_rel_rms_max=grad_rr, update_rel_rms_max=update_rr,
               launches_loss_and_grads=moved)
    bad = []
    if rec["loss_rel_diff"] > TRAIN_CROSS_LOSS_RTOL:
        bad.append(f"loss {loss_card} vs CPU {loss_cpu}")
    if grad_rr > TRAIN_CROSS_GRAD_RMS:
        bad.append(f"gradient rel RMS {grad_rr:.3g}")
    if update_rr > TRAIN_CROSS_UPDATE_RMS:
        bad.append(f"update rel RMS {update_rr:.3g}")
    if moved != want:
        bad.append(f"launches {moved}, want {want}")
    return rec, launches, [f"{cfg.name}: {b}" for b in bad]


def train_cross(device, counters) -> tuple:
    """[train-cross]: the card against the CPU on one reduced float32
    starcoder2 model (2 layers, d 256, 4/2 heads of 64) and on one
    reduced float32 model of each later family (TRAIN_CROSS_FAMILIES),
    each with the same weights and batch: the loss, every gradient leaf
    and one AdamW step's update (TRAIN_CROSS_*); then ``launch.train`` on
    the card at ``--size smoke``: 4 steps straight through, and 2 steps,
    a simulated preemption (``--stop-after 2``) and a ``--resume`` to 4,
    the two final losses within TRAIN_RESUME_RTOL.  Returns (record,
    launches of the card's runs)."""
    import dataclasses
    import tempfile
    from repro_torch.configs import get_config, reduced
    from repro_torch.launch import train as launch_train

    cfg = dataclasses.replace(
        reduced(get_config("starcoder2-3b"), layers=2, d_model=256,
                heads=4, kv_heads=2, d_ff=1024), dtype="float32")
    base, launches, bad = _cross_one(device, counters, cfg)
    families = {}
    for arch, kw in TRAIN_CROSS_FAMILIES:
        fcfg = dataclasses.replace(reduced(get_config(arch), **kw),
                                   dtype="float32")
        frec, flaunch, fbad = _cross_one(device, counters, fcfg)
        frec["head_dim"] = fcfg.head_dim
        families[fcfg.name] = frec
        bad.extend(fbad)
        for k, v in flaunch.items():
            launches[k] = launches.get(k, 0) + v

    args = ["--arch", "starcoder2-3b", "--size", "smoke", "--steps", "4",
            "--seq", "64", "--batch", "2", "--ckpt-every", "2"]
    build = ROOT / "build"
    build.mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=build) as tmp:
        zero_counters(counters)
        straight = launch_train.run(launch_train.parse_args(args))
        first = launch_train.run(launch_train.parse_args(
            args + ["--ckpt-dir", tmp, "--stop-after", "2", "--resume"]))
        second = launch_train.run(launch_train.parse_args(
            args + ["--ckpt-dir", tmp, "--resume"]))
        for k, v in all_launches(counters).items():
            launches[k] = launches.get(k, 0) + v
    resumed = {**first["losses"], **second["losses"]}
    final_straight, final_resumed = straight["losses"][3], resumed[3]
    rec = dict(
        model=f"{cfg.name} f32 (2 layers, d 256, 4/2 heads of 64)",
        **base, families=families,
        launcher_straight=straight["losses"],
        launcher_resumed=resumed, resume_start=second["start"],
        resume_rel_diff=abs(final_resumed - final_straight)
        / abs(final_straight),
        resume_bit_for_bit=resumed == straight["losses"],
        launches=launches)
    phase("train-cross", json.dumps(rec))
    if not (first["preempted"] and second["start"] == 2
            and sorted(resumed) == [0, 1, 2, 3]):
        bad.append(f"preempt/resume: {first} {second}")
    if rec["resume_rel_diff"] > TRAIN_RESUME_RTOL:
        bad.append(f"resumed loss {final_resumed} vs straight "
                   f"{final_straight}")
    for k in ("flash_attention_bwd", "rmsnorm_bwd", "moe_swiglu_bwd",
              "rglru_scan_bwd", "wkv6_bwd"):
        if not launches.get(k):
            bad.append(f"{k} never launched")
    if bad:
        raise AssertionError("[train-cross]: " + "; ".join(bad))
    return rec, launches


#: [mesh]: tensor and data parallelism of every family and the sharded
#: static plan, run by MESH_WORLD ranks that share card 0 (so
#: init_world picks gloo: NCCL refuses two ranks on one device),
#: spawned after every library is built, meeting through a FileStore;
#: every collective, and the world, end within these
MESH_WORLD = 4
MESH_COLLECTIVE_TIMEOUT_S = 300.0
MESH_WORLD_TIMEOUT_S = 720.0
#: (a) the static plan on a data-2 mesh: full-size megafleet_100k (K 1,
#: 50,000 users a rank) and capacitated_k3 (K 3: 1500 Li-GD rows, 750 a
#: rank), against the one-process plan on the same card: splits and
#: servers equal, B, r, U, T, E, C within U_RTOL
MESH_PLAN_SCENARIOS = ("megafleet_100k", "capacitated_k3")
#: (b) full-width starcoder2-3b cut to 1 of its 30 layers (so that (d)
#: and (e) fit in the run's time), TRAIN_BATCH x TRAIN_SEQ tokens, remat,
#: MESH_STEPS AdamW step at the optimizer's own rate (no schedule: a
#: warm-up starts at 0 and would leave every weight where it was) on the
#: data 2 x model 2 mesh (ZeRO-1 over data, the tensor-parallel blocks
#: over model), against the one-process step on the same card from the
#: same weights and batch: float32 at TRAIN_CROSS_* (the loss; every
#: gradient leaf and, by the triangle inequality, grad_norm at
#: TRAIN_CROSS_GRAD_RMS; every leaf's change at TRAIN_CROSS_UPDATE_RMS, a
#: leaf that did not move a breach), bfloat16 at MESH_BF16_*.  Gloo
#: stages every collective through the host at about 1 GB/s here, so a
#: data-parallel float32 step takes 5-9 s (PR 28's first run).  One step
#: and one mesh, where PR 31 took two steps on model 2, data 2 and data 2
#: x model 2, so that (g) and (h) fit in the run's time: model 2 alone
#: stays covered by (e) and (g), data 2 alone by (d)'s granite-moe and
#: (c)'s launcher runs (several ZeRO-1 steps)
MESH_TRAIN_ARCH, MESH_TRAIN_LAYERS, MESH_STEPS = "starcoder2-3b", 1, 1
MESH_SHAPES = (("data 2 x model 2", (2, 2)),)
MESH_DTYPES = (("float32", MESH_SHAPES), ("bfloat16", MESH_SHAPES))
#: bfloat16, mesh against one process, set from the rounding argument in
#: PERF.md §6 (PR 28) before the first card run: a bf16 rounding is off
#: by at most 2^-8 relative (RMS about 2.3e-3); each row-parallel output
#: (wo, wd) adds about two roundings (each rank's partial sum, the
#: all-reduce), so the residual of 4 blocks drifts by about 2.3e-3 x 2 x
#: sqrt(8) = 1.3e-2 relative (the 1 run here, MESH_TRAIN_LAYERS, less);
#: per-token logit noise of that size moves the mean loss of 4096
#: tokens by about 2e-5 relative (1e-3 allowed);
#: gradients carry it plus one rounding of each rank's half-batch
#: gradient (5e-2 allowed in error RMS, and grad_norm with it); AdamW's
#: first step moves an element by lr x sign(g), so a fraction of about
#: 0.8 x 5e-2 of elements may move the other way: the change's error RMS
#: over its RMS up to 2 x sqrt(0.04) = 0.4
MESH_BF16_LOSS_RTOL = 1e-3
MESH_BF16_GRAD_RMS = 5e-2
MESH_BF16_UPDATE_RMS = 0.4
#: (c) launch.train --mesh host under torch.distributed.run (2 ranks,
#: the 100m member of qwen3-8b's family), preempted after 2 steps of 4
#: and resumed by one process, each loss against an unbroken
#: one-process run within TRAIN_RESUME_RTOL
MESH_LAUNCH_ARGS = ("--size", "100m", "--steps", "4", "--ckpt-every", "2")
#: (c)'s worlds, started together: qwen3-8b's alone, where PR 29 added
#: granite-moe's (an MoE under the global capacity rule of a data mesh),
#: so that (g) and (h) fit in the run's time; (d)'s granite-moe data 2
#: holds that rule on the card
MESH_LAUNCH_ARCHS = ("qwen3-8b",)
#: (d) every other family at its published widths on a mesh, depth cut
#: (recurrentgemma-9b keeps its three blocks of three kinds; the others
#: keep 1-2, so that (e) fits in the run's time)
#: (label, config, layers kept (an encoder-decoder's encoder too),
#: (data, model), batch, sequence): the shapes of its [train-*] phase
#: (internvl2-1b, which has none: [serve-vlm]'s 4 x (256 patches + 768
#: tokens)).  Each runs MESH_STEPS float32 AdamW step (no schedule, as
#: (b)) on the mesh from
#: the same weights (init_lm for the mesh, cut by shard_lm_params) and
#: batches as a one-process run on the card, held at TRAIN_CROSS_*
#: (loss, aux, grad_norm, the step-1 gradient of every leaf, every
#: leaf's change).  The one-process run goes first, on rank 0 while the
#: others wait; its results stay on the host and the card is freed
#: before the ranks start.  At data 2 x model 2 an MoE's capacity and
#: aux are per data shard: its one-process run takes each shard's rows
#: through the one-process path (a shard's capacity) and averages the
#: gradients and metrics.  Assignments that the capacity rule (factor
#: 1.25) drops are counted and printed
MESH_FAMILY_CASES = (
    ("granite-moe data 2", "granite-moe-1b-a400m", 2, (2, 1), 4, 1024),
    ("granite-moe data 2 x model 2", "granite-moe-1b-a400m", 2, (2, 2), 4,
     1024),
    ("rwkv6-3b data 2 x model 2", "rwkv6-3b", 2, (2, 2), 4, 1024),
    ("recurrentgemma-9b data 2 x model 2", "recurrentgemma-9b", 3, (2, 2),
     2, 2560),
    ("seamless-m4t data 2 x model 2", "seamless-m4t-large-v2", 1, (2, 2),
     4, 1024),
    ("internvl2-1b model 4", "internvl2-1b", 2, (1, 4), 4, 1024),
)

#: (e) serving on a mesh: (label, config, layers kept (an encoder-decoder's
#: encoder too), (data, model), batch, prompt, cache length, source
#: frames, dtype, int8 caches), each at its published widths with depth
#: cut: a prefill, then MESH_SERVE_STEPS greedy decode steps through
#: launch.steps.build_decode's fn on the rank's shards, against one
#: process on the card from the same weights (init_lm for the mesh, cut
#: by shard_lm_params) and prompts; the one-process run goes first, on
#: rank 0 while the others wait, its results on the host and the card
#: freed before the ranks draw their weights, one rank at a time.  Each
#: decode step takes the one-process run's token as its input
#: (float32: the same as the mesh's own greedy pick, which must equal
#: it).  starcoder2-3b's 2 kv heads on tp 4 shard the caches' length
#: (the online-softmax merge), again with int8 caches and in bfloat16;
#: gemma3-27b's 16 kv heads on tp 2 shard by heads, its rings of 1024
#: wrap during decode; granite-moe decodes expert-parallel at capacity
#: factor 2.0 per data shard (drops printed); rwkv6-3b's state by heads,
#: 20 a rank; recurrentgemma-9b's batch of 1 does not shard, so its
#: 2048-slot ring shards over (data, model) (long_500k's layout) and its
#: RG-LRU state by channels; seamless-m4t's encoder on the mesh and its
#: cross caches by heads
MESH_SERVE_CASES = (
    ("starcoder2-3b model 4", "starcoder2-3b", 2, (1, 4), 4, 1024, 2048, 0,
     "float32", False),
    ("starcoder2-3b model 4 int8", "starcoder2-3b", 2, (1, 4), 4, 1024,
     2048, 0, "float32", True),
    ("gemma3-27b data 2 x model 2", "gemma3-27b", 6, (2, 2), 4, 1024, 2048,
     0, "float32", False),
    ("granite-moe data 2 x model 2", "granite-moe-1b-a400m", 4, (2, 2), 4,
     1024, 2048, 0, "float32", False),
    ("rwkv6-3b data 2 x model 2", "rwkv6-3b", 4, (2, 2), 4, 1024, 2048, 0,
     "float32", False),
    ("recurrentgemma-9b data 2 x model 2", "recurrentgemma-9b", 3, (2, 2),
     1, 2560, 4096, 0, "float32", False),
    ("seamless-m4t data 2 x model 2", "seamless-m4t-large-v2", 2, (2, 2), 4,
     256, 512, 1024, "float32", False),
    ("starcoder2-3b model 4 bf16", "starcoder2-3b", 2, (1, 4), 4, 1024,
     2048, 0, "bfloat16", False),
)
#: 4 (8 before), for the run's time
MESH_SERVE_STEPS = 4
#: float32, mesh against one process, set from PERF.md §6's argument
#: before the first card run: the mesh reorders float32 sums (the
#: all-reduce of each row-parallel output's 2 or 4 partials, the
#: online-softmax merge of a length-sharded cache, products of other
#: shapes), each off by about 2^-24 = 6e-8 of its output; a few dozen of
#: them through at most 6 blocks and the unembedding move a logit by
#: about 1e-6 of the largest, so 1e-5 of the largest |value| bounds every
#: logit and every float cache leaf; int8 codes within one step on at
#: most MESH_SERVE_CODE_SHARE of them (a rounding tie the sums move)
MESH_SERVE_RTOL = 1e-5
MESH_SERVE_CODE_SHARE = 1e-3
#: (g) context-parallel attention on model 4 (the attention weights
#: replicated, the sequence sharded, k/v and the output all-gathered),
#: float32 at published widths with depth cut: starcoder2-3b (2 layers;
#: its 2 kv heads do not divide 4, so its decode cache shards by length)
#: and recurrentgemma-9b (its three blocks of three kinds, the local
#: window 2048 under 2560 tokens, one kv head).  Training: (d)'s
#: machinery, MESH_STEPS step against one process at TRAIN_CROSS_*
#: (loss, grad_norm, every gradient leaf, every leaf's change);
#: (label, config, layers, (data, model), batch, sequence)
MESH_CP_TRAIN_CASES = (
    ("starcoder2-3b model 4 cp", "starcoder2-3b", 2, (1, 4), 2, 2048),
    ("recurrentgemma-9b model 4 cp", "recurrentgemma-9b", 3, (1, 4), 1,
     2560),
)
#: (g) serving under the flag: (e)'s machinery and cases' fields
#: (a prefill of a sequence the axis divides, then MESH_SERVE_STEPS
#: decode steps, every head on every rank), MESH_SERVE_RTOL, every
#: greedy token equal
MESH_CP_SERVE_CASES = (
    ("starcoder2-3b model 4 cp", "starcoder2-3b", 2, (1, 4), 2, 2048, 4096,
     0, "float32", False),
    ("recurrentgemma-9b model 4 cp", "recurrentgemma-9b", 3, (1, 4), 1,
     2560, 4096, 0, "float32", False),
)
#: (h) the engine on a data 2 x model 2 mesh (InferenceEngine(env=)):
#: starcoder2-3b at published width, MESH_ENGINE_LAYERS layers, float32,
#: MESH_ENGINE_PROMPTS requests of mixed lengths in MESH_ENGINE_SLOTS
#: slots of MESH_ENGINE_CACHE positions, MESH_ENGINE_NEW greedy tokens
#: each, once without and once with context-parallel attention; every
#: token on every rank equal to a one-process engine's on the card.
#: Then one split-server generation (SplitServer(env=), a batch of 2 x
#: MESH_ENGINE_SPLIT_PROMPT tokens at block 1) against the one-process
#: split server
MESH_ENGINE_ARCH, MESH_ENGINE_LAYERS = "starcoder2-3b", 2
MESH_ENGINE_PROMPTS = (96, 200, 64, 333, 128, 250, 77, 180)
MESH_ENGINE_SLOTS, MESH_ENGINE_CACHE, MESH_ENGINE_NEW = 4, 512, 8
MESH_ENGINE_SPLIT_PROMPT = 128


def int8_flip_bound(flipped: int, positions: int) -> float:
    """(e)'s int8 chain, set before the card run: the largest move, over
    the largest |logit|, of a one-process decode's logits when its
    prefill's int8 codes are replaced by the mesh prefill's, ``flipped``
    of them one step apart (a rounding tie the mesh's sums move).  A
    flipped code moves one cached k or v element by one scale step, at
    most 1/127 of its row's largest |value|, and enters a later decode
    step through the softmax weight of its position, 1/T on average over
    the T = ``positions`` prompt positions a step attends; the logits
    move by at most that sum over the flipped codes, flipped / (127 T).
    The two prefills' float leaves (each row's scale) are held to
    MESH_SERVE_RTOL of each other and move the logits by as much, which
    the bound adds (with no flipped code, it is MESH_SERVE_RTOL)."""
    return MESH_SERVE_RTOL + flipped / (127.0 * positions)


#: bfloat16 (case 1 again, the served dtype), beside MESH_BF16_*: each
#: bf16 rounding is off by up to 2^-8 (RMS about 2.3e-3); a block's two
#: row-parallel outputs add about two roundings each (the rank's partial,
#: the all-reduce), so the residual of 2 blocks drifts by about 2.3e-3 x 2
#: x sqrt(4) = 9e-3 relative, and a logit (a product over d of the
#: drifted residual) by as much of the largest; 3e-2 of the largest
#: |value| bounds the logits and cache leaves.  A greedy token may differ
#: only where the one-process top-2 gap is under that bound
MESH_SERVE_BF16_RTOL = 3e-2
#: (f) every architecture x cell program at full size on layout-only
#: envs (nothing allocated): 10 x 4 on each, the 7 full-attention
#: architectures' long_500k refused; the host's RSS may grow by less
#: than this
MESH_CELL_LAYOUTS = ({"data": 16, "model": 16},
                     {"pod": 2, "data": 16, "model": 16})
MESH_CELL_RSS_GB = 1.0


#: [dryrun] (a): ``launch.dryrun.main`` over every architecture x cell x
#: production mesh, counted on ``meta``, in one worker process a group
#: of architectures, one worker a host core (8 on the card's machine)
#: (the groups balanced by their counting time, so that the longest,
#: gemma3-27b's, sets the phase's), 66 ok, 14 skipped; a worker may not
#: touch the card, and its peak RSS (VmHWM, or VmRSS sampled every 20 ms
#: where the host reports no VmHWM) may grow by less than DRYRUN_RSS_GB
#: past its imports
DRYRUN_GROUPS = (("gemma3-27b",), ("moonshot-v1-16b-a3b",), ("yi-34b",),
                 ("seamless-m4t-large-v2",), ("rwkv6-3b",),
                 ("recurrentgemma-9b", "internvl2-1b"),
                 ("qwen3-8b", "starcoder2-3b"), ("granite-moe-1b-a400m",))
DRYRUN_RSS_GB = 1.0
DRYRUN_TIMEOUT_S = 420
#: [dryrun] (b): starcoder2-3b at full width and depth, [train]'s shape
#: and a decode step at batch TRAIN_BATCH into a cache of DRYRUN_CACHE,
#: counted on ``meta`` and run on the card under the count; the step
#: timed by CUDA events, median of DRYRUN_STEPS.  The dry run's tracked
#: peak above the arguments is held to the card's
#: (``max_memory_allocated`` above the arguments) within DRYRUN_PEAK_RTOL
#: of the card's plus DRYRUN_PEAK_ATOL_BYTES, set before the first card
#: run from the rehearsal on ``meta``: the caching allocator rounds
#: each block up to 512 bytes (a few kB over the few hundred storages
#: live at the train peak, counted on ``meta``), and the card may
#: allocate inside the run what no aten op returns (a cuBLAS workspace)
DRYRUN_CACHE = 1024
DRYRUN_STEPS = 5
DRYRUN_PEAK_RTOL = 0.02
DRYRUN_PEAK_ATOL_BYTES = 64 * 2 ** 20


def _mesh_tolerances(dtn: str) -> tuple:
    """(loss rtol, gradient and grad-norm error RMS, change error RMS)."""
    if dtn == "float32":
        return (TRAIN_CROSS_LOSS_RTOL, TRAIN_CROSS_GRAD_RMS,
                TRAIN_CROSS_UPDATE_RMS)
    return MESH_BF16_LOSS_RTOL, MESH_BF16_GRAD_RMS, MESH_BF16_UPDATE_RMS


def _nonzero(counters) -> dict:
    return {k: v for k, v in all_launches(counters).items() if v}


def _add_launches(total: dict, launches: dict) -> None:
    for k, v in launches.items():
        total[k] = total.get(k, 0) + v


def mesh_plan_rank(device, counters, total: dict) -> dict:
    """(a) on a rank of the data-2 mesh (ranks 0 and 1; the others only
    build the mesh): each scenario's static plan sharded over the mesh,
    then unsharded on this rank alone, compared."""
    import numpy as np
    import torch
    from repro_torch.api import get_scenario
    from repro_torch.api.policies import make_policy
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.runtime.meshenv import make_env
    env = make_env(make_mesh((2,), ("data",)))
    if not env.member:
        return {}
    out = {}
    for name in MESH_PLAN_SCENARIOS:
        sc = get_scenario(name)
        profile, devices = sc.build_profile(), sc.build_devices()
        topo = sc.build_topology()
        aps = topo.nearest_ap(sc.build_mobility(topo).positions())
        plans, walls, launches = {}, {}, {}
        for kind, e in (("mesh", env), ("one", None)):
            planner = make_policy(None, sc, profile, sc.build_topology(),
                                  device=device)
            torch.cuda.synchronize()
            zero_counters(counters)
            t0 = time.perf_counter()
            _, _, fleet = planner.plan_static(devices, aps, env=e)
            torch.cuda.synchronize()
            walls[kind] = time.perf_counter() - t0
            launches[kind] = _nonzero(counters)
            plans[kind] = fleet
        _add_launches(total, launches["mesh"])
        a, b = plans["mesh"], plans["one"]
        rel = {f: float(np.max(np.abs(getattr(a, f) - getattr(b, f))
                               / np.maximum(np.abs(getattr(b, f)), 1e-30)))
               for f in ("B", "r", "U", "T", "E", "C")}
        out[name] = dict(
            users=len(aps), K=sc.candidates_k,
            rows_per_rank=len(aps) * sc.candidates_k // env.dp,
            wall_s_mesh=walls["mesh"], wall_s_one=walls["one"],
            launches_mesh=launches["mesh"],
            splits_equal=bool(np.array_equal(a.split, b.split)),
            servers_equal=bool(np.array_equal(a.server, b.server)),
            max_rel=rel, bit_for_bit=all(
                np.array_equal(getattr(a, f), getattr(b, f))
                for f in ("split", "server", "B", "r", "U", "T", "E", "C")))
    return out


def _mesh_cfg(dtn: str):
    import dataclasses
    from repro_torch.configs import get_config
    return dataclasses.replace(get_config(MESH_TRAIN_ARCH),
                               num_layers=MESH_TRAIN_LAYERS, dtype=dtn)


def _mesh_batches(cfg, device) -> list:
    from repro_torch.runtime.data import DataConfig, batch_at
    dcfg = DataConfig(seed=0, seq_len=TRAIN_SEQ, global_batch=TRAIN_BATCH)
    return [batch_at(cfg, dcfg, s, device) for s in range(MESH_STEPS)]


def mesh_baseline(cfg, device) -> dict:
    """(b)'s one-process run, on rank 0 alone: the step-1 gradient of
    every leaf, then MESH_STEPS train steps; the weights before and after
    and the gradients kept on the card for the comparisons."""
    import torch
    from repro_torch._tree import leaves
    from repro_torch.models import transformer as tfm
    from repro_torch.optim import adamw
    from repro_torch.runtime.train import (TrainConfig, loss_and_grads,
                                           make_train_step)
    release_memory()
    torch.cuda.reset_peak_memory_stats()
    tcfg = TrainConfig(remat=True)
    params = tfm.init_lm(cfg, torch.Generator(device).manual_seed(0),
                         device)
    p0 = [p.detach().clone() for p in leaves(params)]
    batches = _mesh_batches(cfg, device)
    _, _, g1 = loss_and_grads(cfg, params, batches[0], tcfg=tcfg)
    step = make_train_step(cfg, tcfg)
    opt, steps = adamw.init(params), []
    for b in batches:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params, opt, m = step(params, opt, b)
        torch.cuda.synchronize()
        steps.append(dict(loss=float(m["loss"]),
                          grad_norm=float(m["grad_norm"]),
                          s=time.perf_counter() - t0))
    p2 = [p.detach() for p in leaves(params)]
    peak = torch.cuda.max_memory_allocated() / 1e9
    del opt, m
    release_memory()
    return {"p0": p0, "g1": g1, "p2": p2, "steps": steps, "peak_gb": peak}


def mesh_train_run(cfg, env, device, counters, base, total: dict) -> dict:
    """(b) on one mesh, on each member: this rank's slices of the same
    weights (init_lm for the mesh, cut by interop.shard_lm_params), the
    step-1 gradient of every leaf gathered to compare, then MESH_STEPS
    train steps, each step's launches zeroed before it and read after it
    (train_launches_per_step of this rank's rows; no plain version), and
    the weights gathered to compare.  ``base`` (rank 0 only) holds the
    one-process run; the comparisons are made there."""
    import torch
    from repro_torch._tree import leaves
    from repro_torch.interop import shard_lm_params
    from repro_torch.models import transformer as tfm
    from repro_torch.runtime.train import (TrainConfig, init_opt_state,
                                           loss_and_grads, make_train_step)
    release_memory()
    torch.cuda.reset_peak_memory_stats()
    tcfg = TrainConfig(remat=True)
    params = shard_lm_params(cfg, tfm.init_lm(
        cfg, torch.Generator(device).manual_seed(0), device, env), env)
    specs = leaves(tfm.param_specs(cfg, env))
    opt = init_opt_state(cfg, params, env)
    batches = _mesh_batches(cfg, device)
    zero_counters(counters)
    _, _, grads = loss_and_grads(cfg, params, batches[0], tcfg=tcfg,
                                 env=env)
    torch.cuda.synchronize()
    grad_launches = _nonzero(counters)
    _add_launches(total, grad_launches)
    grad_rr = []
    for i, (g, sp) in enumerate(zip(grads, specs)):
        full = env.unshard(g, sp)
        if base is not None:
            grad_rr.append(rel_rms_held(full.float(),
                                        base["g1"][i].float()))
        del full
    del grads
    step = make_train_step(cfg, tcfg, env=env)
    want = train_launches_per_step(cfg, TRAIN_BATCH // env.dp, TRAIN_SEQ)
    steps, bad = [], []
    with plain_version_calls() as plain:
        for s, b in enumerate(batches):
            torch.cuda.synchronize()
            zero_counters(counters)
            t0 = time.perf_counter()
            params, opt, m = step(params, opt, b)
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
            launches = _nonzero(counters)
            _add_launches(total, launches)
            if launches != want:
                bad.append(f"step {s + 1} launches {launches}, want {want}")
            steps.append(dict(loss=float(m["loss"]),
                              grad_norm=float(m["grad_norm"]), s=dt))
    if any(plain.values()):
        bad.append(f"plain versions called: {plain}")
    peak = torch.cuda.max_memory_allocated() / 1e9
    upd_rr = []
    for i, (p, sp) in enumerate(zip(leaves(params), specs)):
        full = env.unshard(p.detach(), sp)
        if base is not None:
            p0 = base["p0"][i].float()
            upd_rr.append(rel_rms_held(full.float() - p0,
                                       base["p2"][i].float() - p0))
        del full
    rec = dict(coordinate=env.coordinate, tp=env.tp, dp=env.dp,
               rows_per_rank=TRAIN_BATCH // env.dp, steps=steps,
               peak_gb=peak, launches_per_step=want,
               launches_grads=grad_launches)
    if base is not None:
        loss_tol, grad_tol, upd_tol = _mesh_tolerances(cfg.dtype)
        rec.update(
            one_process_steps=base["steps"],
            one_process_peak_gb=base["peak_gb"],
            loss_rel_diff=[abs(a["loss"] - b["loss"]) / abs(b["loss"])
                           for a, b in zip(steps, base["steps"])],
            grad_norm_rel_diff=[
                abs(a["grad_norm"] - b["grad_norm"]) / b["grad_norm"]
                for a, b in zip(steps, base["steps"])],
            grad_rel_rms_max=max(grad_rr), update_rel_rms_max=max(upd_rr),
            tolerances=dict(loss=loss_tol, grad=grad_tol, update=upd_tol))
        if max(rec["loss_rel_diff"]) > loss_tol:
            bad.append(f"loss {rec['loss_rel_diff']} > {loss_tol}")
        if max(rec["grad_norm_rel_diff"]) > grad_tol:
            bad.append(f"grad_norm {rec['grad_norm_rel_diff']} > {grad_tol}")
        if rec["grad_rel_rms_max"] > grad_tol:
            bad.append(f"gradient rel RMS {rec['grad_rel_rms_max']:.3g}")
        if rec["update_rel_rms_max"] > upd_tol:
            bad.append(f"update rel RMS {rec['update_rel_rms_max']:.3g}")
    rec["bad"] = bad
    del params, opt, m
    release_memory()
    return rec


def mesh_train_rank(rank: int, device, counters, total: dict) -> list:
    """(b): for each dtype, rank 0's one-process run while the others
    wait, then its meshes (MESH_DTYPES) over the first ranks of the world
    (the others build each mesh and wait)."""
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.runtime.meshenv import make_env
    out = []
    for dtn, shapes in MESH_DTYPES:
        cfg = _mesh_cfg(dtn)
        base = mesh_baseline(cfg, device) if rank == 0 else None
        dist.barrier()
        for label, shape in shapes:
            env = make_env(make_mesh(shape, ("data", "model")))
            if env.member:
                rec = mesh_train_run(cfg, env, device, counters, base, total)
                out.append(dict(mesh=label, dtype=dtn, **rec))
            dist.barrier()
        del base
        release_memory()
    return out


def _family_cfg(arch: str, layers: int):
    import dataclasses
    from repro_torch.configs import get_config
    cfg = get_config(arch)
    kw = dict(num_layers=layers, dtype="float32")
    if cfg.enc_dec:
        kw["num_enc_layers"] = layers
    return dataclasses.replace(cfg, **kw)


def _family_batches(cfg, B: int, S: int, device) -> list:
    from repro_torch.runtime.data import DataConfig, batch_at
    dcfg = DataConfig(seed=0, seq_len=S, global_batch=B)
    return [batch_at(cfg, dcfg, s, device) for s in range(MESH_STEPS)]


@contextlib.contextmanager
def first_grads():
    """Keep the gradients of the first ``runtime.train.loss_and_grads``
    call in a ``with`` block (a train step's, so no extra backward).
    Yields a list that holds them after that call."""
    from repro_torch.runtime import train as train_mod
    inner, kept = train_mod.loss_and_grads, []

    def spy(*a, **kw):
        out = inner(*a, **kw)
        if not kept:
            kept.append(out[2])
        return out

    train_mod.loss_and_grads = spy
    try:
        yield kept
    finally:
        train_mod.loss_and_grads = inner


@contextlib.contextmanager
def moe_drops():
    """Count, for each call of ``models.moe._moe_local`` in a ``with``
    block, the token-expert assignments that its capacity rule drops
    (the router's top-k of the call's own inputs; on a data mesh each
    expert's earlier data ranks' assignments counted first, as the call
    does).  Yields the list of (assignments, dropped) per call."""
    import torch
    from repro_torch.models import moe as moe_mod
    inner, seen = moe_mod._moe_local, []

    def spy(x_flat, router, *a, num_experts, top_k, capacity, **kw):
        with torch.no_grad():
            idx = torch.topk(x_flat.float() @ router, top_k,
                             dim=-1).indices.reshape(-1)
            counts = torch.zeros((num_experts,), dtype=idx.dtype,
                                 device=idx.device).index_add_(
                0, idx, torch.ones_like(idx))
            before = torch.zeros_like(counts)
            axis, env = kw.get("data_axis"), kw.get("env")
            if axis is not None:
                parts = env.gather_parts(counts, axis)
                i = env.axis_index(axis)
                if i:
                    before = torch.stack(parts[:i]).sum(dim=0)
            kept = torch.minimum(torch.clamp(capacity - before, min=0),
                                 counts)
            seen.append((int(idx.numel()), int((counts - kept).sum())))
        return inner(x_flat, router, *a, num_experts=num_experts,
                     top_k=top_k, capacity=capacity, **kw)

    moe_mod._moe_local = spy
    try:
        yield seen
    finally:
        moe_mod._moe_local = inner


def _drops_per_step(seen: list, cfg, passes: int = 1) -> list:
    """Each step's (assignments, dropped) of its forward: remat routes
    every block twice a pass (the forward and its recompute, the same
    inputs), so the first num_layers calls of each 2·num_layers, summed
    over the step's ``passes`` (a one-process run of each data shard's
    rows: one pass a shard)."""
    n = cfg.num_layers if cfg.num_experts else 0
    if not n:
        return []
    per = [[sum(c) for c in zip(*seen[i:i + n])]
           for i in range(0, len(seen), 2 * n)]
    return [[sum(c) for c in zip(*per[i:i + passes])]
            for i in range(0, len(per), passes)]


def _host(tensors) -> list:
    """float32 copies on the host (never views of the live tensors)."""
    import torch
    return [t.detach().to("cpu", torch.float32, copy=True)
            for t in tensors]


def mesh_family_baseline(cfg, layout, shards: int, B: int, S: int,
                         device) -> dict:
    """(d)'s one-process run, on rank 0 alone: init_lm for the mesh's
    ``layout`` (the same logical weights the ranks cut), MESH_STEPS
    train steps, the first step's gradients kept; with ``shards`` > 1,
    each step takes each data shard's rows through the one-process path
    and averages their gradients, loss and aux before AdamW.  Returns
    the step-1 gradients and each leaf's change over the steps on the
    host, each step's metrics, the drops, the peak and the seconds."""
    import torch
    from repro_torch._tree import leaves, unflatten
    from repro_torch.models import transformer as tfm
    from repro_torch.optim import adamw
    from repro_torch.runtime.train import (TrainConfig, loss_and_grads,
                                           make_train_step)
    release_memory()
    torch.cuda.reset_peak_memory_stats()
    t_start = time.perf_counter()
    tcfg = TrainConfig(remat=True)
    params = tfm.init_lm(cfg, torch.Generator(device).manual_seed(0),
                         device, layout)
    p0 = _host(leaves(params))
    batches = _family_batches(cfg, B, S, device)
    step = make_train_step(cfg, tcfg)
    opt, steps = adamw.init(params), []
    with first_grads() as g1, moe_drops() as seen:
        for b in batches:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            if shards == 1:
                params, opt, m = step(params, opt, b)
                m = {k: float(v) for k, v in m.items()}
            else:
                rows = B // shards
                parts = [loss_and_grads(cfg, params, {
                    k: v[i * rows:(i + 1) * rows] for k, v in b.items()},
                    tcfg=tcfg) for i in range(shards)]
                grads = [sum(g) / shards for g in zip(*(r[2] for r in parts))]
                if not steps:
                    g1[:] = [grads]
                params, opt, om = adamw.update(
                    tcfg.adamw, unflatten(params, grads), opt, params)
                m = {k: sum(float(r[1][k]) for r in parts) / shards
                     for k in ("loss", "aux")}
                m["grad_norm"] = float(om["grad_norm"])
                del parts, grads
            torch.cuda.synchronize()
            steps.append(dict(loss=m["loss"], aux=m["aux"],
                              grad_norm=m["grad_norm"],
                              s=time.perf_counter() - t0))
            if len(steps) == 1:
                g1[:] = [_host(g1[0])]
    change = _host(leaves(params))
    for d, a in zip(change, p0):
        d.sub_(a)
    del p0
    out = {"g1": g1[0], "change": change,
           "steps": steps, "drops": _drops_per_step(seen, cfg, shards),
           "peak_gb": torch.cuda.max_memory_allocated() / 1e9}
    del params, opt
    release_memory()
    out["s"] = time.perf_counter() - t_start
    return out


#: elements of a host tensor moved to the card at a time to compare
COMPARE_CHUNK = 1 << 25


def _sq_sums(got, want, device) -> tuple:
    """(sum (got - want)², sum want²) of host tensors in float64, moved
    to the card COMPARE_CHUNK elements at a time."""
    import torch
    num = den = torch.zeros((), dtype=torch.float64, device=device)
    g, w = got.reshape(-1), want.reshape(-1)
    for i in range(0, g.numel(), COMPARE_CHUNK):
        a = g[i:i + COMPARE_CHUNK].to(device).double()
        b = w[i:i + COMPARE_CHUNK].to(device).double()
        num = num + (a - b).square().sum()
        den = den + b.square().sum()
    return num, den


def _compare_leaves(local, specs, env, want, device) -> float:
    """The largest rel_rms over the leaves of each rank's host pieces
    ``local`` against ``want``, the one-process leaves on rank 0's host
    (None elsewhere).  No leaf is gathered whole (recurrentgemma-9b's
    table is 4.2 GB in float32, and four ranks share one host's memory
    and one card's): the other
    members of rank 0's model group send it their pieces of each
    model-sharded leaf, one at a time, and rank 0 compares each piece
    with its slice of ``want``, which it empties as it goes."""
    import torch
    import torch.distributed as dist
    model = env.model_axis
    group = env.group(model).ranks if env.tp > 1 else (dist.get_rank(),)
    # rank 0's model group: the members of the first data row
    sends = env.axis_index(env.batch()) == 0 and group[0] != dist.get_rank()
    worst = 0.0
    for i, (t, sp) in enumerate(zip(local, specs)):
        dim = next((d for d, e in enumerate(sp) if e == model), None)
        if dim is None or env.tp == 1:
            pieces = [t] if want is not None else []
        elif want is not None:
            pieces = [t]
            for r in group[1:]:
                buf = torch.empty_like(t)
                dist.recv(buf, src=r)
                pieces.append(buf)
        else:
            if sends:
                dist.send(t.contiguous(), dst=group[0])
            continue
        num = den = 0.0
        for j, piece in enumerate(pieces):
            ref = (want[i] if len(pieces) == 1 else
                   want[i].narrow(dim, j * piece.shape[dim], piece.shape[dim]))
            a, b = _sq_sums(piece, ref, device)
            num, den = num + a, den + b
        if pieces:
            # a zero reference (a weight that did not move) holds nothing
            worst = max(worst, (num / den).sqrt().item() if den > 0
                        else math.inf)
            want[i] = None
    return worst


def mesh_family_run(cfg, env, B: int, S: int, device, counters, base,
                    total: dict) -> dict:
    """(d) on one mesh, on each member: this rank's slices of the
    weights, MESH_STEPS train steps (each step's launches zeroed before
    it and read after it, against train_launches_per_step of this
    rank's rows; no plain version), the step-1 gradients and the
    updated weights gathered to compare with ``base`` (rank 0 only)."""
    import torch
    from repro_torch._tree import leaves
    from repro_torch.interop import shard_lm_params
    from repro_torch.models import transformer as tfm
    from repro_torch.models.moe import capacity_for
    from repro_torch.runtime.train import (TrainConfig, init_opt_state,
                                           make_train_step)
    release_memory()
    torch.cuda.reset_peak_memory_stats()
    tcfg = TrainConfig(remat=True)
    params = shard_lm_params(cfg, tfm.init_lm(
        cfg, torch.Generator(device).manual_seed(0), device, env), env)
    specs = leaves(tfm.param_specs(cfg, env))
    p0 = _host(leaves(params))
    opt = init_opt_state(cfg, params, env)
    batches = _family_batches(cfg, B, S, device)
    step = make_train_step(cfg, tcfg, env=env)
    rows_local, rows = B // env.dp, 0
    if cfg.num_experts:
        rows = (capacity_for(rows_local * S, cfg, tcfg.capacity_factor)
                if env.tp > 1 else
                min(capacity_for(B * S, cfg, tcfg.capacity_factor),
                    rows_local * S))
    want = train_launches_per_step(cfg, rows_local, S, src_len=S,
                                   moe_rows=rows)
    steps, bad, grad_rr = [], [], None
    with first_grads() as g1, moe_drops() as seen, \
            plain_version_calls() as plain:
        for s, b in enumerate(batches):
            torch.cuda.synchronize()
            zero_counters(counters)
            t0 = time.perf_counter()
            params, opt, m = step(params, opt, b)
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
            launches = _nonzero(counters)
            _add_launches(total, launches)
            if launches != want:
                bad.append(f"step {s + 1} launches {launches}, want {want}")
            steps.append(dict(loss=float(m["loss"]), aux=float(m["aux"]),
                              grad_norm=float(m["grad_norm"]), s=dt))
            if s == 0:
                grad_rr = _compare_leaves(
                    _host(g1[0]), specs, env,
                    None if base is None else base["g1"], device)
                g1[0] = None
    if any(plain.values()):
        bad.append(f"plain versions called: {plain}")
    peak = torch.cuda.max_memory_allocated() / 1e9
    del opt, m
    release_memory()
    change = _host(leaves(params))
    for d, a in zip(change, p0):
        d.sub_(a)
    del p0
    upd_rr = _compare_leaves(change, specs, env,
                             None if base is None else base["change"], device)
    del change
    rec = dict(coordinate=env.coordinate, tp=env.tp, dp=env.dp,
               rows_per_rank=rows_local, moe_rows=rows, steps=steps,
               drops=_drops_per_step(seen, cfg), peak_gb=peak,
               launches_per_step=want)
    if base is not None:
        loss_tol, grad_tol, upd_tol = _mesh_tolerances("float32")
        one = base["steps"]
        rel = {k: [abs(a[k] - b[k]) / max(abs(b[k]), 1e-30)
                   for a, b in zip(steps, one)]
               for k in ("loss", "aux", "grad_norm")}
        rec.update(one_process_steps=one,
                   one_process_peak_gb=base["peak_gb"],
                   one_process_s=base["s"],
                   one_process_drops=base["drops"],
                   rel_diff=rel, grad_rel_rms_max=grad_rr,
                   update_rel_rms_max=upd_rr,
                   tolerances=dict(loss=loss_tol, grad=grad_tol,
                                   update=upd_tol))
        for k, tol in (("loss", loss_tol), ("aux", loss_tol),
                       ("grad_norm", grad_tol)):
            if max(rel[k]) > tol:
                bad.append(f"{k} {rel[k]} > {tol}")
        if grad_rr > grad_tol:
            bad.append(f"gradient rel RMS {grad_rr:.3g}")
        if upd_rr > upd_tol:
            bad.append(f"update rel RMS {upd_rr:.3g}")
    rec["bad"] = bad
    del params
    release_memory()
    return rec


def mesh_family_rank(rank: int, device, counters, total: dict) -> list:
    """(d): for each of MESH_FAMILY_CASES, rank 0's one-process run
    while the others wait, then the case's mesh over the first ranks of
    the world (the others build it and wait)."""
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.runtime.meshenv import make_env
    out = []
    for label, arch, layers, shape, B, S in MESH_FAMILY_CASES:
        cfg = _family_cfg(arch, layers)
        layout = make_env({"data": shape[0], "model": shape[1]})
        shards = shape[0] if cfg.num_experts and shape[1] > 1 else 1
        t0 = time.perf_counter()
        base = (mesh_family_baseline(cfg, layout, shards, B, S, device)
                if rank == 0 else None)
        dist.barrier()
        env = make_env(make_mesh(shape, ("data", "model")))
        if env.member:
            rec = mesh_family_run(cfg, env, B, S, device, counters, base,
                                  total)
            out.append(dict(case=label, batch=B, seq=S, layers=layers,
                            s=time.perf_counter() - t0, **rec))
        dist.barrier()
        del base
        release_memory()
    return out


def _serve_cfg(arch: str, layers: int, dtn: str):
    import dataclasses
    return dataclasses.replace(_family_cfg(arch, layers), dtype=dtn)


def _serve_batch(cfg, B: int, S: int, src: int, device) -> dict:
    """(e)'s prompts (and an encoder-decoder's source frames), from
    seeded generators on the card: the same on every rank."""
    import torch
    batch = {"tokens": torch.randint(
        0, cfg.vocab_size, (B, S), device=device,
        generator=torch.Generator(device).manual_seed(11))}
    if cfg.enc_dec:
        batch["src_embeds"] = torch.randn(
            (B, src, cfg.d_model), device=device,
            generator=torch.Generator(device).manual_seed(12))
    return batch


def _top2_gap(logits, V: int):
    import torch
    top = torch.topk(logits[:, :V].float(), 2, dim=-1).values
    return (top[:, 0] - top[:, 1]).cpu()


def mesh_serve_baseline(cfg, layout, case, shards: int, device) -> dict:
    """(e)'s one-process run, on rank 0 alone: init_lm for the mesh's
    ``layout``, a prefill and MESH_SERVE_STEPS greedy decode steps; each
    step's input tokens, logits (B, Vp), greedy picks and top-2 gaps and
    the final caches on the host, the peak and the seconds.  With
    ``shards`` > 1 (an MoE with tp > 1, whose capacity is per data
    shard) each data shard's rows are served on their own and their
    results concatenated.  With int8 caches, the caches right after the
    prefill are kept on the host too."""
    import torch
    from repro_torch._tree import leaves, unflatten
    from repro_torch.models import transformer as tfm
    _, _, _, _, B, S, CL, src, _, quant = case
    release_memory()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = tfm.init_lm(cfg, torch.Generator(device).manual_seed(0),
                         device, layout)
    batch = _serve_batch(cfg, B, S, src, device)
    rows = B // shards
    parts = []
    with torch.no_grad():
        for j in range(shards):
            part = {k: v[j * rows:(j + 1) * rows] for k, v in batch.items()}
            logits, caches = tfm.prefill(cfg, params, part, cache_len=CL,
                                         kv_quant=quant)
            tok = torch.argmax(logits[:, :cfg.vocab_size], dim=-1)
            rec = {"logits": [logits.float().cpu()], "picks": [],
                   "gaps": [], "inputs": [tok.cpu()],
                   "prefill_caches": ([t.to("cpu", copy=True)
                                       for t in leaves(caches)]
                                      if quant else [])}
            for i in range(MESH_SERVE_STEPS):
                logits, tok, caches = tfm.decode_step(
                    cfg, params, tok[:, None], S + i, caches)
                rec["logits"].append(logits.float().cpu())
                rec["picks"].append(tok.cpu())
                rec["gaps"].append(_top2_gap(logits, cfg.vocab_size))
                rec["inputs"].append(tok.cpu())
            rec["caches"] = [t.cpu() for t in leaves(caches)]
            parts.append(rec)
            del caches, logits
    out = {k: [torch.cat(xs) for xs in zip(*(r[k] for r in parts))]
           for k in ("logits", "picks", "gaps", "inputs")}
    out["inputs"] = out["inputs"][:MESH_SERVE_STEPS]
    shape = tfm.init_caches(cfg, 1, CL, "meta", quant, src)
    for key in ("caches", "prefill_caches"):
        out[key] = (unflatten(shape, [torch.cat(xs) for xs in
                                      zip(*(r[key] for r in parts))])
                    if parts[0][key] else None)
    out["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    del params, batch, parts
    release_memory()
    out["s"] = time.perf_counter() - t0
    return out


def _normwise(got, want) -> float:
    """max |got - want| over max |want| (float64 on the host)."""
    g, w = got.double(), want.double()
    return ((g - w).abs().max() / w.abs().max().clamp_min(1e-30)).item()


def _cache_errors(full: list, want: list, quant: bool) -> tuple:
    """(the worst normwise error over the float leaves, the share of
    int8 codes that differ and their largest difference)."""
    from repro_torch._tree import leaves
    worst, diff, n, big = 0.0, 0, 0, 0
    for g, w in zip(leaves(full), leaves(want)):
        g = g.cpu()
        if w.dtype.is_floating_point:
            worst = max(worst, _normwise(g.float(), w.float()))
        else:
            d = (g.int() - w.int()).abs()
            diff += int((d > 0).sum())
            n += d.numel()
            big = max(big, int(d.max()))
    return worst, (diff / n if n else 0.0), big


def _serve_rows(cfg) -> tuple:
    """The kernels (of rows 3-7) that a family's serving path runs."""
    from repro_torch.configs.base import ATTN_GLOBAL, ATTN_LOCAL, RGLRU, RWKV6
    types = set(cfg.layer_types())
    rows = ["rmsnorm"]
    if types & {ATTN_GLOBAL, ATTN_LOCAL} or cfg.enc_dec:
        rows.append("flash_attention")
    if cfg.num_experts:
        rows.append("moe_swiglu")
    if RGLRU in types:
        rows.append("rglru_scan")
    if RWKV6 in types:
        rows.append("wkv6")
    return tuple(rows)


def _code_flips(full, want) -> int:
    """How many int8 codes of ``full`` differ from ``want``'s."""
    from repro_torch._tree import leaves
    return sum(int((g.cpu().int() != w.int()).sum())
               for g, w in zip(leaves(full), leaves(want))
               if not w.dtype.is_floating_point)


def mesh_serve_chain(cfg, layout, case, caches, inputs, device) -> dict:
    """(e)'s int8 case on one process from the mesh's prefill, on rank 0:
    the one-process weights (``init_lm`` for the mesh's ``layout``, as
    :func:`mesh_serve_baseline` draws them) and MESH_SERVE_STEPS decode
    steps fed ``inputs`` (the tokens the mesh was fed) from a copy of
    ``caches``, the mesh prefill's caches gathered whole; each step's
    logits, greedy picks and top-2 gaps, the final caches, on the host."""
    import torch
    from repro_torch._tree import leaves, tree_map
    from repro_torch.models import transformer as tfm
    S = case[5]
    params = tfm.init_lm(cfg, torch.Generator(device).manual_seed(0),
                         device, layout)
    caches = tree_map(lambda t: t.clone(), caches)
    out = {"logits": [], "picks": [], "gaps": []}
    with torch.no_grad():
        for i in range(MESH_SERVE_STEPS):
            logits, tok, caches = tfm.decode_step(
                cfg, params, inputs[i].to(device)[:, None], S + i, caches)
            out["logits"].append(logits.float().cpu())
            out["picks"].append(tok.cpu())
            out["gaps"].append(_top2_gap(logits, cfg.vocab_size))
    out["caches"] = [t.cpu() for t in leaves(caches)]
    del params, caches
    release_memory()
    return out


def mesh_serve_run(rank: int, cfg, env, case, device, counters, base,
                   total: dict) -> dict:
    """(e) on one mesh: this rank's slices of the weights (the ranks draw
    them one at a time), the prefill and MESH_SERVE_STEPS decode steps
    through build_decode's fn, the counts zeroed just before the prefill
    and read after the last step (no plain version may run); the logits
    gathered over the vocab shards and rows, and the caches gathered
    whole, compared on rank 0 with ``base``.  With int8 caches the chain
    is held whole: the mesh decodes from its own prefill's codes, and so
    does one process (:func:`mesh_serve_chain`), so that the decode
    steps are held mesh against one process from the same codes
    (MESH_SERVE_RTOL); a code at a rounding tie may flip between the two
    prefills (held to MESH_SERVE_CODE_SHARE), and the one process's
    move from its own codes to the mesh's is held apart, to
    :func:`int8_flip_bound` of the flipped codes."""
    import torch
    import torch.distributed as dist
    from repro_torch._tree import leaves
    from repro_torch.configs.base import ShapeCell
    from repro_torch.interop import shard_lm_params
    from repro_torch.launch.steps import build_decode
    from repro_torch.models import transformer as tfm
    from repro_torch.runtime.meshenv import P, make_env, unshard_tree
    label, _, _, _, B, S, CL, src, dtn, quant = case
    release_memory()
    params = None
    for r in range(dist.get_world_size()):
        if r == rank and env.member:
            params = shard_lm_params(cfg, tfm.init_lm(
                cfg, torch.Generator(device).manual_seed(0), device, env),
                env)
            release_memory()
        dist.barrier()
    shared = [base["inputs"] if base is not None else None]
    dist.broadcast_object_list(shared, src=0)
    inputs = shared[0]
    if not env.member:
        return {}
    torch.cuda.reset_peak_memory_stats()
    batch = _serve_batch(cfg, B, S, src, device)
    specs = tfm.cache_specs(cfg, env, B, CL, src, quant)
    prog = build_decode(cfg, env, ShapeCell("mesh_serve", CL, B, "decode"),
                        kv_quant=quant)
    bad = []
    if leaves(prog.in_specs[3]) != leaves(specs):
        bad.append("build_decode's cache specs differ from cache_specs at "
                   f"source length {src}")
    b_ax = env.batch_if(B)
    logits_all, picks, steps_s = [], [], []
    with torch.no_grad(), plain_version_calls() as plain, \
            moe_drops() as seen:
        torch.cuda.synchronize()
        zero_counters(counters)
        t0 = time.perf_counter()
        logits, caches = tfm.prefill(cfg, params, batch, cache_len=CL,
                                     kv_quant=quant, env=env)
        torch.cuda.synchronize()
        prefill_s = time.perf_counter() - t0
        prefill_launches = _nonzero(counters)
        prefill_calls = len(seen)
        logits_all.append(env.unshard(logits, P(b_ax, "model")).float()
                          .cpu())
        prefill_full = (unshard_tree(caches, specs, env) if quant
                        else None)
        for i in range(MESH_SERVE_STEPS):
            tok = inputs[i].to(device)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            logits, nxt, caches = prog.fn(params, tok[:, None], S + i,
                                          caches)
            torch.cuda.synchronize()
            steps_s.append(time.perf_counter() - t0)
            logits_all.append(env.unshard(logits, P(b_ax, "model")).float()
                              .cpu())
            picks.append(env.unshard(nxt, P(b_ax)).cpu())
        launches = _nonzero(counters)
    _add_launches(total, launches)
    if any(plain.values()):
        bad.append(f"plain versions called: {plain}")
    missing = [k for k in _serve_rows(cfg) if not launches.get(k)]
    if missing:
        bad.append(f"kernels not launched: {missing}")
    decode_drops = [sum(c) for c in zip(*seen[prefill_calls:])]
    peak = torch.cuda.max_memory_allocated() / 1e9
    full = unshard_tree(caches, specs, env)
    del caches, params
    rec = dict(coordinate=env.coordinate, tp=env.tp, dp=env.dp,
               rows_per_rank=B // env.dp if b_ax else B, dtype=dtn,
               kv_quant=quant, peak_gb=peak, prefill_s=prefill_s,
               decode_s=steps_s, launches=launches,
               prefill_launches=prefill_launches,
               moe_prefill=[sum(c) for c in zip(*seen[:prefill_calls])],
               moe_decode=decode_drops)
    if base is not None:
        tol = MESH_SERVE_RTOL if dtn == "float32" else MESH_SERVE_BF16_RTOL
        V = cfg.vocab_size              # past it, -1e30 on both sides
        want = base
        if quant:
            chain = mesh_serve_chain(cfg, make_env(dict(env.axes)), case,
                                     prefill_full, inputs, device)
            flipped = _code_flips(prefill_full, base["prefill_caches"])
            flip_err = max(_normwise(a[:, :V], b[:, :V]) for a, b in
                           zip(chain["logits"], base["logits"][1:]))
            flip_tol = int8_flip_bound(flipped, S)
            rec.update(int8_flipped_codes=flipped, int8_flip_err=flip_err,
                       int8_flip_tol=flip_tol)
            if flip_err > flip_tol:
                bad.append(f"one process from the mesh's codes: logits "
                           f"{flip_err:.3g} off its own, past "
                           f"int8_flip_bound {flip_tol:.3g} of {flipped} "
                           "flipped codes")
            want = dict(base, logits=base["logits"][:1] + chain["logits"],
                        picks=chain["picks"], gaps=chain["gaps"],
                        caches=chain["caches"])
        errs = [_normwise(a[:, :V], b[:, :V])
                for a, b in zip(logits_all, want["logits"])]
        cache_err, code_share, code_max = _cache_errors(full, want["caches"],
                                                        quant)
        if prefill_full is not None:
            pre = _cache_errors(prefill_full, base["prefill_caches"], quant)
            rec["prefill_cache_err"] = pre
            cache_err = max(cache_err, pre[0])
            code_share = max(code_share, pre[1])
            code_max = max(code_max, pre[2])
        near, differ = [], []
        for i, (a, b) in enumerate(zip(picks, want["picks"])):
            for row in (a != b).nonzero().flatten().tolist():
                gap = float(want["gaps"][i][row])
                scale = want["logits"][i + 1][:, :V].abs().max().item()
                entry = dict(step=i, row=row, mesh=int(a[row]),
                             one_process=int(b[row]), gap=gap)
                (near if dtn != "float32" and gap < tol * scale
                 else differ).append(entry)
        rec.update(one_process_peak_gb=base["peak_gb"],
                   one_process_s=base["s"], logits_err=errs,
                   cache_err=cache_err, int8_codes_differing=code_share,
                   int8_code_max_diff=code_max, tokens_near_tie=near,
                   tokens=[p.tolist() for p in want["picks"]], tol=tol)
        if max(errs) > tol:
            bad.append(f"logits error {max(errs):.3g} > {tol}")
        if cache_err > tol:
            bad.append(f"cache error {cache_err:.3g} > {tol}")
        if code_max > 1 or code_share > MESH_SERVE_CODE_SHARE:
            bad.append(f"int8 codes: {code_share:.3g} differ, by up to "
                       f"{code_max}")
        if differ:
            bad.append(f"greedy tokens differ: {differ}")
    rec["bad"] = bad
    del full
    release_memory()
    return rec


def mesh_serve_rank(rank: int, device, counters, total: dict) -> list:
    """(e): for each of MESH_SERVE_CASES, rank 0's one-process run while
    the others wait, then the case's mesh over the first ranks of the
    world (the others build it, take their turn at the weights and
    wait)."""
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.runtime.meshenv import make_env
    out = []
    for case in MESH_SERVE_CASES:
        label, arch, layers, shape, _, _, _, _, dtn, _ = case
        cfg = _serve_cfg(arch, layers, dtn)
        layout = make_env({"data": shape[0], "model": shape[1]})
        t0 = time.perf_counter()
        shards = shape[0] if cfg.num_experts and shape[1] > 1 else 1
        base = (mesh_serve_baseline(cfg, layout, case, shards, device)
                if rank == 0 else None)
        dist.barrier()
        env = make_env(make_mesh(shape, ("data", "model")))
        rec = mesh_serve_run(rank, cfg, env, case, device, counters, base,
                             total)
        if env.member:
            out.append(dict(case=label, s=time.perf_counter() - t0, **rec))
        dist.barrier()
        del base
        release_memory()
    return out


def mesh_cp_rank(rank: int, device, counters, total: dict) -> dict:
    """(g): each of MESH_CP_TRAIN_CASES through (d)'s one-process run and
    mesh run, then each of MESH_CP_SERVE_CASES through (e)'s, on an env
    with context-parallel attention."""
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.runtime.meshenv import make_env
    out = {"train": [], "serve": []}
    for label, arch, layers, shape, B, S in MESH_CP_TRAIN_CASES:
        cfg = _family_cfg(arch, layers)
        layout = make_env({"data": shape[0], "model": shape[1]})
        t0 = time.perf_counter()
        base = (mesh_family_baseline(cfg, layout, 1, B, S, device)
                if rank == 0 else None)
        dist.barrier()
        env = make_env(make_mesh(shape, ("data", "model")),
                       context_parallel_attn=True)
        if env.member:
            rec = mesh_family_run(cfg, env, B, S, device, counters, base,
                                  total)
            out["train"].append(dict(case=label, batch=B, seq=S,
                                     layers=layers,
                                     s=time.perf_counter() - t0, **rec))
        dist.barrier()
        del base
        release_memory()
    for case in MESH_CP_SERVE_CASES:
        label, arch, layers, shape, _, _, _, _, dtn, _ = case
        cfg = _serve_cfg(arch, layers, dtn)
        layout = make_env({"data": shape[0], "model": shape[1]})
        t0 = time.perf_counter()
        base = (mesh_serve_baseline(cfg, layout, case, 1, device)
                if rank == 0 else None)
        dist.barrier()
        env = make_env(make_mesh(shape, ("data", "model")),
                       context_parallel_attn=True)
        rec = mesh_serve_run(rank, cfg, env, case, device, counters, base,
                             total)
        if env.member:
            out["serve"].append(dict(case=label,
                                     s=time.perf_counter() - t0, **rec))
        dist.barrier()
        del base
        release_memory()
    return out


def _engine_prompts(cfg) -> list:
    import numpy as np
    rng = np.random.default_rng(21)
    return [rng.integers(0, cfg.vocab_size, n).astype(np.int64)
            for n in MESH_ENGINE_PROMPTS]


def _engine_tokens(engine, prompts) -> dict:
    for p in prompts:
        engine.submit(p, MESH_ENGINE_NEW)
    return {int(k): [int(t) for t in v]
            for k, v in engine.run_to_completion().items()}


def mesh_engine_rank(rank: int, device, counters, total: dict) -> dict:
    """(h): the one-process engine and split server on rank 0 while the
    others wait, then the data 2 x model 2 engine without and with
    context-parallel attention (the counts zeroed just before each run
    and read just after; no plain version) and the mesh split server;
    each rank's tokens against the one-process ones."""
    import torch
    import torch.distributed as dist
    from repro_torch.interop import shard_lm_params
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import transformer as tfm
    from repro_torch.runtime.meshenv import make_env
    from repro_torch.serving.engine import InferenceEngine
    from repro_torch.serving.split import SplitServer
    cfg = _serve_cfg(MESH_ENGINE_ARCH, MESH_ENGINE_LAYERS, "float32")
    shape = (2, 2)
    layout = make_env({"data": shape[0], "model": shape[1]})
    prompts = _engine_prompts(cfg)
    split_tokens = torch.randint(
        0, cfg.vocab_size, (2, MESH_ENGINE_SPLIT_PROMPT), device=device,
        generator=torch.Generator(device).manual_seed(22))
    base = [None]
    if rank == 0:
        release_memory()
        t0 = time.perf_counter()
        params = tfm.init_lm(cfg, torch.Generator(device).manual_seed(0),
                             device, layout)
        with torch.no_grad():
            tokens = _engine_tokens(InferenceEngine(
                cfg, params, device=device, slots=MESH_ENGINE_SLOTS,
                cache_len=MESH_ENGINE_CACHE), prompts)
            split = SplitServer(cfg, params, device=device).generate(
                split_tokens, 1, MESH_ENGINE_NEW).cpu().tolist()
        base = [dict(tokens=tokens, split=split,
                     s=time.perf_counter() - t0)]
        del params
        release_memory()
    dist.broadcast_object_list(base, src=0)
    base = base[0]
    out = {"one_process": base, "runs": []}
    bad = []
    for cp in (False, True):
        env = make_env(make_mesh(shape, ("data", "model")),
                       context_parallel_attn=cp)
        params = None
        for r in range(dist.get_world_size()):
            if r == rank:
                params = shard_lm_params(cfg, tfm.init_lm(
                    cfg, torch.Generator(device).manual_seed(0), device,
                    env), env)
                release_memory()
            dist.barrier()
        torch.cuda.reset_peak_memory_stats()
        with torch.no_grad(), plain_version_calls() as plain:
            torch.cuda.synchronize()
            zero_counters(counters)
            t0 = time.perf_counter()
            tokens = _engine_tokens(InferenceEngine(
                cfg, params, device=device, slots=MESH_ENGINE_SLOTS,
                cache_len=MESH_ENGINE_CACHE, env=env), prompts)
            torch.cuda.synchronize()
            engine_s = time.perf_counter() - t0
            launches = _nonzero(counters)
            _add_launches(total, launches)
            split = None
            if cp:
                zero_counters(counters)
                split = SplitServer(cfg, params, device=device,
                                    env=env).generate(
                    split_tokens, 1, MESH_ENGINE_NEW).cpu().tolist()
                split_launches = _nonzero(counters)
                _add_launches(total, split_launches)
        tag = f"engine cp={cp}"
        if any(plain.values()):
            bad.append(f"{tag}: plain versions called: {plain}")
        for name in ("flash_attention", "rmsnorm"):
            if not launches.get(name):
                bad.append(f"{tag}: {name} not launched")
        differ = {k: (v, base["tokens"].get(k)) for k, v in tokens.items()
                  if v != base["tokens"].get(k)}
        if differ or sorted(tokens) != sorted(base["tokens"]):
            bad.append(f"{tag}: tokens differ from one process's: {differ}")
        rec = dict(cp=cp, coordinate=env.coordinate, engine_s=engine_s,
                   launches=launches,
                   peak_gb=torch.cuda.max_memory_allocated() / 1e9,
                   tokens_equal=not differ)
        if split is not None:
            rec.update(split_equal=split == base["split"],
                       split_launches=split_launches)
            if split != base["split"]:
                bad.append(f"split server {split} != {base['split']}")
        out["runs"].append(rec)
        del params
        release_memory()
        dist.barrier()
    out["bad"] = bad
    return out


def mesh_cross_lse(device) -> dict:
    """Row 3's float32 log-sum-exp (``stats=True``), which the merge over
    a length-sharded cross cache takes, against the plain version's at
    a decode step's shape over seamless-m4t's 1024 source frames cut
    four ways (B 4, 1 x 256, 16/16 heads of 64; no case of (e) shards a
    cross cache's length at published widths)."""
    import torch
    from repro_torch.kernels.flash_attention import kernel as fk
    from repro_torch.kernels.flash_attention.ref import attention_ref
    g = torch.Generator(device).manual_seed(13)
    q, k, v = (torch.randn(shape, device=device, generator=g)
               for shape in ((4, 1, 16, 64), (4, 256, 16, 64),
                             (4, 256, 16, 64)))
    out, lse, lo = fk.flash_attention_cuda(q, k, v, causal=False, stats=True)
    ref_out, ref_lse, _ = attention_ref(q, k, v, causal=False, stats=True)
    rec = dict(lse_max_abs_err=(lse - ref_lse).abs().max().item(),
               out_max_abs_err=(out - ref_out).abs().max().item(),
               residual=lo is None, tol=ATTN_TOL["float32"])
    rec["bad"] = ([] if lo is None and max(
        rec["lse_max_abs_err"], rec["out_max_abs_err"]) <= rec["tol"]
        else [f"row 3's float32 LSE: {rec}"])
    return rec


def mesh_cell_programs() -> dict:
    """(f): every architecture x cell program at full size on each of
    MESH_CELL_LAYOUTS (layout-only envs); the full-attention
    architectures' long_500k must raise ValueError.  Nothing may be
    allocated on the card, and the host's RSS may grow by less than
    MESH_CELL_RSS_GB."""
    import resource
    import torch
    from repro_torch.configs import ALL_CELLS, ARCH_IDS, get_config
    from repro_torch.launch.steps import build_cell
    from repro_torch.runtime.meshenv import make_env
    from repro_torch.runtime.train import TrainConfig
    before = torch.cuda.memory_allocated()
    rss0 = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
    t0 = time.perf_counter()
    built, refused, kinds = 0, 0, {}
    for layout in MESH_CELL_LAYOUTS:
        env = make_env(layout)
        for arch in ARCH_IDS:
            for cell in ALL_CELLS:
                try:
                    prog = build_cell(get_config(arch), env, cell,
                                      TrainConfig())
                except ValueError:
                    refused += 1
                    continue
                built += 1
                kinds[prog.kind] = kinds.get(prog.kind, 0) + 1
    rec = dict(built=built, refused=refused, kinds=kinds,
               s=time.perf_counter() - t0,
               card_bytes_delta=torch.cuda.memory_allocated() - before,
               rss_growth_gb=(resource.getrusage(resource.RUSAGE_SELF)
                              .ru_maxrss - rss0) / 1e6)
    bad = []
    if (built, refused) != (66, 14):
        bad.append(f"built {built}, refused {refused}; want 66 and 14")
    if rec["card_bytes_delta"]:
        bad.append(f"the card's allocated bytes moved by "
                   f"{rec['card_bytes_delta']}")
    if rec["rss_growth_gb"] >= MESH_CELL_RSS_GB:
        bad.append(f"host RSS grew {rec['rss_growth_gb']:.2f} GB")
    rec["bad"] = bad
    return rec


def gloo_cuda_probe(device) -> dict:
    """Which collectives the world's gloo groups run on CUDA tensors:
    the three the port uses (all_reduce, all_gather; broadcast, which
    ``dist.barrier`` rests on) and two it does not (recorded, not
    required; gloo refuses an op before it communicates)."""
    import torch
    import torch.distributed as dist
    n = dist.get_world_size()
    x = torch.ones(4, device=device)
    ops = (("all_reduce", lambda: dist.all_reduce(x.clone())),
           ("broadcast", lambda: dist.broadcast(x.clone(), src=0)),
           ("all_gather", lambda: dist.all_gather(
               [torch.empty_like(x) for _ in range(n)], x)),
           ("reduce_scatter", lambda: dist.reduce_scatter(
               torch.empty_like(x), [x.clone() for _ in range(n)])),
           ("all_to_all_single", lambda: dist.all_to_all_single(
               torch.empty(4 * n, device=device), x.repeat(n))))
    out = {}
    for name, fn in ops:
        try:
            fn()
            torch.cuda.synchronize()
            out[name] = "ran"
        except RuntimeError as e:
            out[name] = "refused: " + str(e).splitlines()[0][:160]
    return out


def mesh_rank(rank: int, world: int, tmp: str) -> None:
    """One rank of [mesh]'s world: gloo on card 0 through a FileStore in
    ``tmp``; (a), (b), (d), (e), (g), (h) and the gloo probe; its record written to
    ``tmp/rank<r>.json``, or its traceback to ``tmp/rank<r>.err``."""
    import os
    import traceback
    import torch
    import torch.distributed as dist
    sys.path.insert(0, str(SRC))
    from repro_torch.launch.mesh import init_world
    try:
        store = dist.FileStore(os.path.join(tmp, "store"), world)
        device, backend = init_world(
            "cuda:0", store=store, rank=rank, world_size=world,
            timeout_s=MESH_COLLECTIVE_TIMEOUT_S)
        counters, total = kernel_counters(), {}
        rec = {"rank": rank, "backend": backend, "device": str(device),
               "card": torch.cuda.get_device_name(device),
               "card_uuid": str(torch.cuda.get_device_properties(
                   device).uuid)}
        t0 = time.perf_counter()
        rec["plan"] = mesh_plan_rank(device, counters, total)
        rec["plan_s"] = time.perf_counter() - t0
        dist.barrier()
        t0 = time.perf_counter()
        rec["train"] = mesh_train_rank(rank, device, counters, total)
        rec["train_s"] = time.perf_counter() - t0
        dist.barrier()
        t0 = time.perf_counter()
        rec["families"] = mesh_family_rank(rank, device, counters, total)
        rec["families_s"] = time.perf_counter() - t0
        dist.barrier()
        t0 = time.perf_counter()
        rec["serve"] = mesh_serve_rank(rank, device, counters, total)
        rec["serve_s"] = time.perf_counter() - t0
        dist.barrier()
        t0 = time.perf_counter()
        rec["cp"] = mesh_cp_rank(rank, device, counters, total)
        rec["cp_s"] = time.perf_counter() - t0
        dist.barrier()
        t0 = time.perf_counter()
        rec["engine"] = mesh_engine_rank(rank, device, counters, total)
        rec["engine_s"] = time.perf_counter() - t0
        dist.barrier()
        rec["gloo_cuda"] = gloo_cuda_probe(device)
        rec["launches"] = total
        with open(os.path.join(tmp, f"rank{rank}.json"), "w") as f:
            json.dump(rec, f)
        dist.barrier()
        dist.destroy_process_group()
    except BaseException:
        with open(os.path.join(tmp, f"rank{rank}.err"), "w") as f:
            f.write(traceback.format_exc())
        raise


def mesh_world() -> list:
    """Spawn MESH_WORLD ranks of ``mesh_rank`` on the card; every rank
    must exit 0 within MESH_WORLD_TIMEOUT_S.  Returns their records."""
    import tempfile
    import torch.multiprocessing as mp
    build = ROOT / "build"
    build.mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=build) as tmp:
        ctx = mp.get_context("spawn")
        procs = [ctx.Process(target=mesh_rank, args=(r, MESH_WORLD, tmp))
                 for r in range(MESH_WORLD)]
        for p in procs:
            p.start()
        deadline = time.perf_counter() + MESH_WORLD_TIMEOUT_S
        for p in procs:
            p.join(max(1.0, deadline - time.perf_counter()))
        hung = [r for r, p in enumerate(procs) if p.is_alive()]
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
        errs = []
        for r in range(MESH_WORLD):
            err = Path(tmp) / f"rank{r}.err"
            if err.exists():
                errs.append(f"rank {r}:\n{err.read_text()}")
        codes = [p.exitcode for p in procs]
        if hung or errs or any(codes):
            raise AssertionError(f"[mesh] ranks hung {hung}, exit codes "
                                 f"{codes}\n" + "\n".join(errs))
        return [json.loads((Path(tmp) / f"rank{r}.json").read_text())
                for r in range(MESH_WORLD)]


def mesh_launcher(counters) -> list:
    """(c): for each of MESH_LAUNCH_ARCHS, ``launch.train --mesh host
    --arch arch`` under torch.distributed.run on 2 ranks (ZeRO-1 over
    a data mesh; the runs started together), preempted after 2 steps
    with a logical checkpoint, resumed by one process, against an
    unbroken one-process run (both in this process).  Returns a record
    an arch."""
    import os
    import tempfile
    from repro_torch.launch import train as launch_train
    build = ROOT / "build"
    env = dict(os.environ, PYTHONPATH=str(SRC))
    recs = []
    with tempfile.TemporaryDirectory(dir=build) as tmp:
        args = {a: [*MESH_LAUNCH_ARGS, "--arch", a] for a in MESH_LAUNCH_ARCHS}
        ck = {a: ["--ckpt-dir", os.path.join(tmp, a), "--resume"]
              for a in MESH_LAUNCH_ARCHS}
        t0 = time.perf_counter()
        procs = {a: subprocess.Popen(
            [sys.executable, "-m", "torch.distributed.run", "--standalone",
             "--nproc-per-node", "2", "-m", "repro_torch.launch.train",
             "--mesh", "host", *args[a], *ck[a], "--stop-after", "2"],
            cwd=ROOT, env=env, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True) for a in MESH_LAUNCH_ARCHS}
        try:
            outs = {a: p.communicate(timeout=max(
                1.0, MESH_WORLD_TIMEOUT_S - (time.perf_counter() - t0)))
                for a, p in procs.items()}
        finally:
            for p in procs.values():
                if p.poll() is None:
                    p.kill()
                    p.wait()
        torchrun_s = time.perf_counter() - t0
        for arch, (stdout, stderr) in outs.items():
            if procs[arch].returncode != 0:
                raise AssertionError(
                    f"[mesh] torchrun {arch} exited "
                    f"{procs[arch].returncode}\n{stdout[-2000:]}"
                    f"\n{stderr[-4000:]}")
            first = {int(s): float(v) for s, v in re.findall(
                r"step\s+(\d+) loss ([0-9.]+)", stdout)}
            zero_counters(counters)
            second = launch_train.run(launch_train.parse_args(
                [*args[arch], *ck[arch]]))
            launches = _nonzero(counters)
            zero_counters(counters)
            straight = launch_train.run(launch_train.parse_args(args[arch]))
            _add_launches(launches, _nonzero(counters))
            resumed = {**first, **{s: float(f"{v:.4f}")
                                   for s, v in second["losses"].items()}}
            want = {s: float(f"{v:.4f}")
                    for s, v in straight["losses"].items()}
            rel = {s: abs(resumed.get(s, float("nan")) - v) / abs(v)
                   for s, v in want.items()}
            rec = dict(arch=arch, torchrun_s=torchrun_s,
                       preempted=stdout.count("[preempt] stopping after 2 "
                                              "steps"),
                       losses_2_ranks=first,
                       losses_resumed=second["losses"],
                       resume_start=second["start"],
                       losses_one_process=straight["losses"], rel_diff=rel,
                       launches=launches)
            bad = []
            if rec["preempted"] != 1 or sorted(first) != [0, 1]:
                bad.append(f"torchrun run: {stdout[-1500:]}")
            if second["start"] != 2 or sorted(resumed) != [0, 1, 2, 3]:
                bad.append(f"resume: {second}")
            if not all(r <= TRAIN_RESUME_RTOL for r in rel.values()):
                bad.append(f"losses {resumed} vs unbroken {want}")
            rec["bad"] = bad
            recs.append(rec)
    return recs


def mesh_phase(device, counters) -> tuple:
    """[mesh]: (a), (b), (d), (e), (g) and (h) in a world of MESH_WORLD
    ranks sharing the card, then (f) the cell programs in this process and (c)
    for each of MESH_LAUNCH_ARCHS.  Prints each
    record; raises on any breach.  Returns
    (records, launches of every rank and of (c)'s one-process runs)."""
    from repro_torch.launch.mesh import choose_backend
    phase("mesh", f"{release_memory():.2f} GB still allocated before the "
          "ranks start")
    t0 = time.perf_counter()
    ranks = mesh_world()
    world_s = time.perf_counter() - t0
    launches, bad = {}, []
    for r in ranks:
        _add_launches(launches, r["launches"])
        phase("mesh", f"rank {r['rank']} backend {r['backend']} on "
              f"{r['device']} ({r['card']}); plan {r['plan_s']:.1f} s, "
              f"train {r['train_s']:.1f} s; launches "
              + json.dumps(r["launches"]) + "; gloo on CUDA tensors: "
              + json.dumps(r["gloo_cuda"]))
        for name, p in r["plan"].items():
            phase("mesh", f"plan {name} rank {r['rank']} " + json.dumps(p))
            if not (p["splits_equal"] and p["servers_equal"]
                    and max(p["max_rel"].values()) <= U_RTOL):
                bad.append(f"plan {name} rank {r['rank']}: {p}")
            if not p["launches_mesh"].get("ligd_sweep"):
                bad.append(f"plan {name} rank {r['rank']}: no sweep launch")
        for t in r["train"]:
            phase("mesh", f"train {t['dtype']} {t['mesh']} rank "
                  f"{r['rank']} " + json.dumps(t))
            bad.extend(f"train {t['dtype']} {t['mesh']} rank {r['rank']}: "
                       f"{b}" for b in t["bad"])
        phase("mesh", f"families rank {r['rank']}: "
              f"{r['families_s']:.1f} s")
        for t in r["families"]:
            phase("mesh", f"family {t['case']} rank {r['rank']} "
                  + json.dumps(t))
            bad.extend(f"family {t['case']} rank {r['rank']}: {b}"
                       for b in t["bad"])
        cases = {t["case"] for t in r["families"]}
        wanted = {label for label, _, _, shape, _, _ in MESH_FAMILY_CASES
                  if r["rank"] < shape[0] * shape[1]}
        if cases != wanted:
            bad.append(f"rank {r['rank']} ran {sorted(cases)}, want "
                       f"{sorted(wanted)}")
        phase("mesh", f"serve rank {r['rank']}: {r['serve_s']:.1f} s")
        for t in r["serve"]:
            phase("mesh", f"serve {t['case']} rank {r['rank']} "
                  + json.dumps(t))
            bad.extend(f"serve {t['case']} rank {r['rank']}: {b}"
                       for b in t["bad"])
        cases = {t["case"] for t in r["serve"]}
        wanted = {c[0] for c in MESH_SERVE_CASES
                  if r["rank"] < c[3][0] * c[3][1]}
        if cases != wanted:
            bad.append(f"rank {r['rank']} served {sorted(cases)}, want "
                       f"{sorted(wanted)}")
        phase("mesh", f"cp rank {r['rank']}: {r['cp_s']:.1f} s")
        for kind in ("train", "serve"):
            for t in r["cp"][kind]:
                phase("mesh", f"cp {kind} {t['case']} rank {r['rank']} "
                      + json.dumps(t))
                bad.extend(f"cp {kind} {t['case']} rank {r['rank']}: {b}"
                           for b in t["bad"])
        cases = {(k, t["case"]) for k in ("train", "serve")
                 for t in r["cp"][k]}
        wanted = {(k, c[0]) for k, cs in (("train", MESH_CP_TRAIN_CASES),
                                          ("serve", MESH_CP_SERVE_CASES))
                  for c in cs if r["rank"] < c[3][0] * c[3][1]}
        if cases != wanted:
            bad.append(f"rank {r['rank']} ran cp {sorted(cases)}, want "
                       f"{sorted(wanted)}")
        phase("mesh", f"engine rank {r['rank']}: {r['engine_s']:.1f} s "
              + json.dumps(r["engine"]))
        bad.extend(f"engine rank {r['rank']}: {b}"
                   for b in r["engine"]["bad"])
        if len(r["engine"]["runs"]) != 2:
            bad.append(f"engine rank {r['rank']}: runs "
                       f"{r['engine']['runs']}")
    want = choose_backend([r["card_uuid"] for r in ranks])
    if any(r["backend"] != want for r in ranks):
        bad.append(f"backends {[r['backend'] for r in ranks]}, the cards "
                   f"the ranks hold call for {want}")
    for name in ("flash_attention", "flash_attention_bwd", "rmsnorm",
                 "rmsnorm_bwd", "moe_swiglu", "moe_swiglu_bwd", "wkv6",
                 "wkv6_bwd", "rglru_scan", "rglru_scan_bwd", "ligd_sweep"):
        on = ranks[:2] if name == "ligd_sweep" else ranks
        if not all(r["launches"].get(name) for r in on):
            bad.append(f"{name} not launched on every rank that runs it")
    phase("mesh", f"world of {MESH_WORLD} ranks: {world_s:.1f} s")
    cells = mesh_cell_programs()
    phase("mesh", "cell programs " + json.dumps(cells))
    bad.extend(f"cell programs: {b}" for b in cells["bad"])
    lse = mesh_cross_lse(device)
    phase("mesh", "row 3 float32 LSE " + json.dumps(lse))
    bad.extend(lse["bad"])
    t0 = time.perf_counter()
    for launcher in mesh_launcher(counters):
        phase("mesh", f"launcher {launcher['arch']} " + json.dumps(launcher))
        bad.extend(f"launcher {launcher['arch']}: {b}"
                   for b in launcher["bad"])
        _add_launches(launches, launcher["launches"])
    phase("mesh", f"launchers {time.perf_counter() - t0:.1f} s")
    if bad:
        raise AssertionError("[mesh]: " + "; ".join(bad))
    return ranks, launches


_DRYRUN_WORKER = r"""
import json, sys, threading
import torch
from repro_torch.launch import dryrun


def vm_kb(key):
    with open("/proc/self/status") as f:
        for line in f:
            if line.startswith(key + ":"):
                return int(line.split()[1])
    return None


# this process's peak RSS: the kernel's high-water mark (VmHWM) where it
# reports one, else the largest VmRSS sampled every 20 ms
hwm = vm_kb("VmHWM") is not None
rss0 = vm_kb("VmHWM" if hwm else "VmRSS")
peak, stop = [rss0], threading.Event()


def sample():
    while not stop.wait(0.02):
        peak[0] = max(peak[0], vm_kb("VmRSS"))


if not hwm:
    threading.Thread(target=sample, daemon=True).start()
rc = dryrun.main(["--arch", sys.argv[2], "--cell", "all", "--mesh", "both",
                  "--out", sys.argv[1]])
stop.set()
end = vm_kb("VmHWM") if hwm else max(peak[0], vm_kb("VmRSS"))
print(json.dumps({"rc": rc, "cuda_initialized": torch.cuda.is_initialized(),
                  "rss_growth_gb": (end - rss0) / 1e6,
                  "rss_source": ("VmHWM" if hwm
                                 else "VmRSS sampled every 20 ms")}))
"""


def dryrun_all() -> dict:
    """[dryrun] (a): ``launch.dryrun.main`` for every architecture x cell
    x production mesh into a temporary directory, one worker process a
    group of DRYRUN_GROUPS, all started together (each stopped if it
    outlives DRYRUN_TIMEOUT_S); 66 records ok, 14 skipped, none in
    error; no worker may initialise CUDA (a process that never does
    allocates nothing on the card), and a worker's peak RSS may grow by
    less than DRYRUN_RSS_GB.  Returns the record (each ok row:
    bottleneck, roofline step, MFU)."""
    import os
    import tempfile
    t0 = time.perf_counter()
    bad, workers = [], []
    with tempfile.TemporaryDirectory() as out:
        env = dict(os.environ, PYTHONPATH=str(SRC))
        procs = [subprocess.Popen(
            [sys.executable, "-c", _DRYRUN_WORKER, out, ",".join(group)],
            env=env, cwd=str(ROOT), stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True) for group in DRYRUN_GROUPS]
        try:
            for group, proc in zip(DRYRUN_GROUPS, procs):
                so, se = proc.communicate(
                    timeout=max(1.0, DRYRUN_TIMEOUT_S
                                - (time.perf_counter() - t0)))
                last = so.strip().splitlines()[-1] if so.strip() else "{}"
                w = json.loads(last) if last.startswith("{") else {}
                w.update(archs=list(group), exit=proc.returncode)
                workers.append(w)
                if proc.returncode != 0 or w.get("rc") != 0:
                    bad.append(f"worker {group}: exit {proc.returncode}: "
                               + (so + se)[-1500:])
                if w.get("cuda_initialized", True):
                    bad.append(f"worker {group} initialised CUDA")
                if w.get("rss_growth_gb", DRYRUN_RSS_GB) >= DRYRUN_RSS_GB:
                    bad.append(f"worker {group}: RSS grew "
                               f"{w.get('rss_growth_gb')} GB")
        finally:
            for proc in procs:
                if proc.poll() is None:
                    proc.kill()
                    proc.communicate()
        recs = []
        for name in sorted(os.listdir(out)):
            with open(os.path.join(out, name)) as f:
                recs.append(json.load(f))
    status = {}
    for r in recs:
        status[r["status"]] = status.get(r["status"], 0) + 1
    rows = [dict(tag=f"{r['arch']}:{r['cell']}:{r['mesh']}",
                 bottleneck=r["roofline"]["bottleneck"],
                 roofline_step_s=r["roofline_step_s"], mfu=r["mfu"],
                 flops=r["cost_analysis"]["flops"],
                 bytes=r["cost_analysis"]["bytes accessed"],
                 link_bytes=r["collectives"]["link_bytes"],
                 temp_gb=r["memory_analysis"]["temp_size_in_bytes"] / 1e9,
                 argument_gb=(r["memory_analysis"]["argument_size_in_bytes"]
                              / 1e9), trace_s=r["trace_s"])
            for r in recs if r["status"] == "ok"]
    rec = dict(status=status, s=time.perf_counter() - t0, workers=workers,
               rows=rows)
    if status != {"ok": 66, "skipped": 14}:
        bad.append(f"records {status}; want 66 ok and 14 skipped")
    rec["bad"] = bad
    return rec


def _calibration_args(cfg, prog, env, device) -> list:
    """(b): the program's arguments drawn on the card: ``init_lm``'s
    weights from seed 0, AdamW's zero state, tokens from seed 1; for a
    decode cell zero caches, tokens and a position past the cache's
    middle.  Their shapes and dtypes are the ``meta`` stand-ins'."""
    import torch
    from repro_torch._tree import leaves, unflatten
    from repro_torch.models import transformer as tfm
    from repro_torch.optim import adamw
    params = tfm.init_lm(cfg, torch.Generator(device).manual_seed(0), device,
                         env)
    g = torch.Generator(device).manual_seed(1)

    def tokens(x):
        return torch.randint(0, cfg.vocab_size, tuple(x.shape), generator=g,
                             device=device, dtype=x.dtype)

    if prog.kind == "train":
        args = [params, adamw.init(params),
                {k: tokens(v) for k, v in prog.args[2].items()}]
    else:
        _, _, _, stand_in = prog.args
        caches = [torch.zeros(t.shape, dtype=t.dtype, device=device)
                  for t in leaves(stand_in)]
        args = [params, tokens(prog.args[1]),
                torch.tensor(DRYRUN_CACHE // 2, dtype=torch.int32,
                             device=device), unflatten(stand_in, caches)]
    shapes = [(tuple(t.shape), t.dtype) for t in leaves(args)]
    want = [(tuple(t.shape), t.dtype) for t in leaves(list(prog.args))]
    if shapes != want:
        raise AssertionError("[dryrun] (b): the card's arguments differ "
                             "from the program's stand-ins")
    return args


def dryrun_calibration(device, counters) -> tuple:
    """[dryrun] (b): full-width starcoder2-3b, a train cell at [train]'s
    shape and a decode cell, each one ``CellProgram`` on a data 1 x
    model 1 layout: counted on ``meta``, then run on the card under the
    count with weights drawn there (counts zeroed just before, read just
    after).  Flops and bytes must be equal on the two devices, each
    kernel launched as often as the count called it (rows 3 and 4, and
    their backward kernels in training) and no plain version run, and
    the tracked peak within DRYRUN_PEAK_RTOL / DRYRUN_PEAK_ATOL_BYTES of
    the card's.  Then DRYRUN_STEPS steps timed apart (CUDA events,
    median) beside the roofline.  Returns (records, launches)."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeCell
    from repro_torch.launch import collective_stats, roofline
    from repro_torch.launch.costs import count
    from repro_torch.launch.dryrun import rank_args
    from repro_torch.launch.mesh import HBM_BW
    from repro_torch.launch.steps import build_cell
    from repro_torch.runtime.meshenv import recording_env
    from repro_torch.runtime.train import TrainConfig
    cfg = get_config("starcoder2-3b")
    out, launches, bad = [], {}, []
    for cell, rows in (
            (ShapeCell("calib_train", TRAIN_SEQ, TRAIN_BATCH, "train"),
             ("flash_attention", "rmsnorm", "flash_attention_bwd",
              "rmsnorm_bwd")),
            (ShapeCell("calib_decode", DRYRUN_CACHE, TRAIN_BATCH, "decode"),
             ("rmsnorm",))):
        release_memory()
        env = recording_env({"data": 1, "model": 1})
        prog = build_cell(cfg, env, cell, TrainConfig())
        stand_ins = rank_args(prog, env)[0]
        t0 = time.perf_counter()
        with count() as meta:
            prog.fn(*stand_ins)
        meta_s = time.perf_counter() - t0
        del stand_ins
        args = _calibration_args(cfg, prog, env, device)
        prog.fn(*args)                                  # warm-up
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        zero_counters(counters)
        t0 = time.perf_counter()
        with plain_version_calls() as plain, count() as card:
            prog.fn(*args)
            torch.cuda.synchronize()
        card_s = time.perf_counter() - t0
        got = _nonzero(counters)
        card_peak = torch.cuda.max_memory_allocated() - base
        times = []
        for _ in range(DRYRUN_STEPS):
            e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in "01")
            e0.record()
            prog.fn(*args)
            e1.record()
            torch.cuda.synchronize()
            times.append(e0.elapsed_time(e1) / 1e3)
        step_s = sorted(times)[len(times) // 2]
        rl = roofline.derive(cfg, cell, {"flops": meta.flops,
                                         "bytes accessed": meta.bytes},
                             collective_stats.collect_stats([]), 1)
        calls = {k: v["calls"] for k, v in meta.kernels.items()}
        kernel_launches = {k: got.get(k, 0) for k in calls}
        rec = dict(
            cell=cell.name, kind=prog.kind, flops_meta=meta.flops,
            flops_card=card.flops, bytes_meta=meta.bytes,
            bytes_card=card.bytes, tracked_peak_gb=meta.peak / 1e9,
            card_tracked_peak_gb=card.peak / 1e9,
            card_peak_gb=card_peak / 1e9,
            peak_tol_gb=(DRYRUN_PEAK_RTOL * card_peak
                         + DRYRUN_PEAK_ATOL_BYTES) / 1e9,
            kernel_calls=calls, launches=got, meta_s=meta_s,
            counted_card_s=card_s, step_s=step_s, steps_s=times,
            roofline_step_s=rl.step_time_s,
            step_over_roofline=step_s / rl.step_time_s,
            counted_bytes_s=meta.bytes / HBM_BW,
            counted_bytes_over_step=meta.bytes / HBM_BW / step_s,
            roofline=rl.row(), mfu_at_step=rl.model_flops / (
                step_s * roofline.H100.peak_flops))
        if (meta.flops, meta.bytes) != (card.flops, card.bytes):
            bad.append(f"{cell.name}: meta counts flops {meta.flops}, bytes "
                       f"{meta.bytes}; the card {card.flops}, {card.bytes}")
        if kernel_launches != calls or any(not got.get(k) for k in rows):
            bad.append(f"{cell.name}: launches {got}, the count's calls "
                       f"{calls}, rows {rows} required")
        if any(plain.values()):
            bad.append(f"{cell.name}: plain versions called: {plain}")
        if abs(card_peak - meta.peak) > (DRYRUN_PEAK_RTOL * card_peak
                                         + DRYRUN_PEAK_ATOL_BYTES):
            bad.append(f"{cell.name}: tracked peak {meta.peak} B, the "
                       f"card's {card_peak} B")
        rec["bad"] = bad[:]
        out.append(rec)
        _add_launches(launches, got)
        del args
    release_memory()
    return out, launches, bad


def dryrun_phase(device, counters, card: str) -> dict:
    """[dryrun]: (a) the dry run of every cell, (b) its calibration on the
    card; prints each record beside the card's name and power limit;
    raises on any breach.  Returns (b)'s launches."""
    a = dryrun_all()
    for row in a["rows"]:
        phase("dryrun", "row " + json.dumps(row))
    phase("dryrun", f"(a) {card}: " + json.dumps(
        {k: v for k, v in a.items() if k != "rows"}))
    bad = [f"(a) {b}" for b in a["bad"]]
    recs, launches, b_bad = dryrun_calibration(device, counters)
    for r in recs:
        phase("dryrun", f"(b) {card}: " + json.dumps(r))
    bad.extend(f"(b) {b}" for b in b_bad)
    if bad:
        raise AssertionError("[dryrun]: " + "; ".join(bad))
    return launches


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
    from repro_torch.kernels.ligd_step import steps as steps_kernel
    from repro_torch.kernels.moe_gemm import kernel as moe_kernel
    from repro_torch.kernels.rglru import kernel as rglru_kernel
    from repro_torch.kernels.wkv6 import kernel as wkv_kernel
    from repro_torch.kernels.flash_attention import backward as flash_bwd
    from repro_torch.kernels.rmsnorm import backward as rms_bwd
    from repro_torch.kernels.moe_gemm import backward as moe_bwd
    from repro_torch.kernels.rglru import backward as rglru_bwd
    from repro_torch.kernels.wkv6 import backward as wkv_bwd
    build_all((sweep_kernel, steps_kernel, rms_kernel, flash_kernel,
               moe_kernel, rglru_kernel, wkv_kernel, flash_bwd, rms_bwd,
               moe_bwd, rglru_bwd, wkv_bwd),
              no_spill={sweep_kernel.LIB_NAME: ("sweep_kernel",),
                        steps_kernel.LIB_NAME: None,
                        rms_kernel.LIB_NAME: None,
                        flash_kernel.LIB_NAME: None,
                        flash_bwd.LIB_NAME: None,
                        rms_bwd.LIB_NAME: None,
                        moe_bwd.LIB_NAME: None,
                        rglru_bwd.LIB_NAME: None,
                        wkv_bwd.LIB_NAME: None,
                        # and every instance of the mma.sync body,
                        # d 128-2048 (moonshot's 2048: NTW 32)
                        moe_kernel.LIB_NAME: ("gate_up_kernel",
                                              "down_kernel",
                                              "moe_swiglu_mma_kernel"),
                        wkv_kernel.LIB_NAME: ("chunk_",)})

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
    zero_sweep_launches(sweep_kernel)
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

    # 4c. the serving plan's launch: one lane, 31 splits, max_iters 200
    from repro_torch.configs import get_config
    from repro_torch.launch import serve_split
    plan, unspy = record_first_launches(sweep_ops)
    try:
        serve_split.plan_split(get_config(serve_split.ARCH), seq=1024,
                               batch=4, c_dev=serve_split.C_DEV,
                               device=device)
    finally:
        unspy()
    rec = compare_sweep("ligd_sweep", "starcoder2-3b serving plan",
                        *plan["ligd_sweep"])
    errs["ligd_sweep"].append(rec["max_abs_err"])

    # 4d. kernel row 2 on the session's users at their planned splits
    steps = steps_case(sess, device)
    del sess

    # 5. card against the CPU path ---------------------------------------
    small = sc.replace(num_users=4096, steps=3)
    fleets = {}
    for dev in ("cuda", "cpu"):
        s = Session(small, device=dev)
        s.run()
        check_fleet(s.fleet, s.profile.num_layers, s.topo.num_servers)
        fleets[dev] = s.fleet
    phase("cross", json.dumps(compare_fleets(fleets["cuda"], fleets["cpu"])))

    # 5b. admission control and the fault path: chaos_singlefail_k3 at
    # 100,000 users x K 3, the sweep held bit for bit on its launches;
    # the capacitated and chaos presets card against CPU; the baselines
    adm_launches, adm_recs = admission_path(sweep_kernel, sweep_ops)
    for label, r in adm_recs.items():
        errs["mligd_sweep" if "MLi-GD" in label else "ligd_sweep"].append(
            r["max_abs_err"])
    admission_cross()
    base_launches = baselines_phase(sweep_kernel)

    # 6. language-model kernels against plain on the card ---------------
    lm = lm_kernel_cases(device)
    lm.update(moe_wkv_kernel_cases(device))
    lm.update(hybrid_kernel_cases(device))
    lm["flash_attention"]["max_abs_err"] = max(
        lm["flash_attention"]["max_abs_err"],
        lm["flash_attention_hd256"]["max_abs_err"])

    # 7. serving main paths: full-width starcoder2-3b, granite-moe,
    # rwkv6-3b and recurrentgemma-9b split generation and the
    # continuous-batching engine; recurrentgemma's prompts (2560) are
    # longer than its window (2048), so its rings wrap ------------------
    # (the engine's one-request references stop at the first token, the
    # one that must match, as the served-last phases' do)
    serve = serve_full_width(device, "starcoder2-3b", "serve", ref_tokens=1)
    serve_moe = serve_full_width(device, "granite-moe-1b-a400m", "serve-moe",
                                 ref_tokens=1)
    serve_rwkv = serve_full_width(device, "rwkv6-3b", "serve-rwkv",
                                  ref_tokens=1)
    serve_hybrid = serve_full_width(device, "recurrentgemma-9b",
                                    "serve-hybrid", prompt_len=2560,
                                    cache_len=4096, ref_tokens=1)

    # 7b. the configurations served last: qwen3-8b (qk-norm), gemma3-27b
    # (5 local : 1 global, prompts of 2048 past its 1024 window), moonshot
    # (row 5's mma.sync decode body at d 2048), internvl2-1b (and its
    # patch prefill), then yi-34b (68.8 GB of weights); each once the
    # earlier phases' memory is returned ------------------------------
    served_last = []
    for arch, tag, kw in SERVED_LAST:
        t0 = time.perf_counter()
        phase(tag, f"{release_memory():.2f} GB still allocated before its "
              "weights are drawn")
        served_last.append(serve_full_width(device, arch, tag, **kw))
        phase(tag, f"{time.perf_counter() - t0:.1f} s")

    # 8. serving, card against the CPU path -------------------------------
    for arch in ("starcoder2-3b", "granite-moe-1b-a400m", "rwkv6-3b",
                 "qwen3-8b", "moonshot-v1-16b-a3b", "yi-34b"):
        serve_cross(device, arch)
    # one block of each kind, (R, R, A), with a 32-token window that the
    # 64-token prompt and the engine's prompts wrap
    serve_cross(device, "recurrentgemma-9b", layers=3, window=32)
    # gemma3-27b's two kinds, (local, global), the same way
    from repro_torch.configs.base import ATTN_GLOBAL, ATTN_LOCAL
    serve_cross(device, "gemma3-27b", window=32,
                pattern=(ATTN_LOCAL, ATTN_GLOBAL))

    # 8a. the tools and examples on the port, on the card -----------------
    counters = kernel_counters()
    tools_launches = tools_phase(counters)

    # 8b. the closed loop: planner -> data plane -> telemetry -> planner.
    # serve_chaos_k3 at its own size with full-width starcoder2-3b pools,
    # token identity across forced failover modes, the feedback loop
    # against the open loop, card against CPU --------------------------
    loop_rec, loop_launches = serve_loop(device)
    serve_identity(device)
    hotspot_on, adaptive_launches, adaptive_held = serve_adaptive(counters)
    cross_launches, cross_held = serve_loop_cross(counters, hotspot_on)
    later_paths = (tools_launches, loop_launches, adaptive_launches,
                   cross_launches, *(r["patch_prefill"]["launches"]
                                     for r in served_last
                                     if "patch_prefill" in r))
    # every closed-loop launch held against its plain version joins the
    # kernels line's max_abs_err
    for held in (loop_rec["held_launches"], *adaptive_held.values(),
                 cross_held):
        for name, r in held.items():
            if name in errs:
                errs[name].append(r["max_abs_err"])
            else:
                lm[name]["max_abs_err"] = max(lm[name]["max_abs_err"],
                                              r["max_abs_err"])

    # 8c. the paths ported last: the encoder-decoder stack at full width
    # and depth, the int8 KV cache, the chain-CNN split executor and the
    # autodiff oracle; each phase zeroes every count before its run and
    # reads them after it, and what it held joins max_abs_err ----------
    enc_rec, enc_launches, enc_held, enc_cases = enc_dec(device, counters)
    kv_rec, kv_launches = kv_int8(device, counters)
    cnn_rec, cnn_launches, cnn_held = cnn_split(device, counters)
    oracle_rec, oracle_launches, oracle_held = ligd_oracle(device, counters)
    later_paths += (enc_launches, kv_launches, cnn_launches,
                    oracle_launches)
    for held in (enc_held, cnn_held, oracle_held):
        for name, r in held.items():
            if name in errs:
                errs[name].append(r["max_abs_err"])
            else:
                lm[name]["max_abs_err"] = max(lm[name]["max_abs_err"],
                                              r["max_abs_err"])

    # 8d. training: every backward kernel against its plain version,
    # full-width train steps of starcoder2-3b and of the MoE, RWKV-6,
    # hybrid and encoder-decoder families (each step's counts zeroed just
    # before it and read just after), the card against the CPU on a
    # reduced model of each family and the launcher's preempt/resume ----
    t0 = time.perf_counter()
    train_k = train_kernel_cases(device)
    phase("train-kernels", f"{time.perf_counter() - t0:.1f} s")
    lm["flash_attention"]["max_abs_err"] = max(
        lm["flash_attention"]["max_abs_err"],
        train_k["flash_attention_offset_fwd_err"])
    t0 = time.perf_counter()
    _, train_launches = train_full_width(device, counters)
    phase("train", f"{time.perf_counter() - t0:.1f} s")
    later_paths += (train_launches,)
    for tag, arch, layers, batch, seq, n_steps, gb in TRAIN_FAMILIES:
        t0 = time.perf_counter()
        _, fam_launches = train_full_width(
            device, counters, tag=tag, arch=arch, layers=layers,
            batch_size=batch, seq=seq, n_steps=n_steps, predicted_gb=gb)
        phase(tag, f"{time.perf_counter() - t0:.1f} s")
        later_paths += (fam_launches,)
    t0 = time.perf_counter()
    _, train_cross_launches = train_cross(device, counters)
    phase("train-cross", f"{time.perf_counter() - t0:.1f} s")
    later_paths += (train_cross_launches,)

    # 8e. the mesh: the sharded static plan and tensor-, data- and
    # expert-parallel training of every family in a world of ranks that
    # share the card (each rank's counts zeroed before each of its runs
    # and read after it), then the launcher's --mesh host under
    # torch.distributed.run, resumed by one process ------------------
    t0 = time.perf_counter()
    _, mesh_launches = mesh_phase(device, counters)
    phase("mesh", f"{time.perf_counter() - t0:.1f} s")
    later_paths += (mesh_launches,)

    # 8f. the dry run: every architecture x cell x production mesh
    # counted on meta (worker processes, nothing on the card), then its
    # calibration: starcoder2-3b's train and decode cells counted on
    # meta and run on the card under the count (counts zeroed just
    # before, read just after) ------------------------------------------
    t0 = time.perf_counter()
    dryrun_launches = dryrun_phase(device, counters, card)
    phase("dryrun", f"{time.perf_counter() - t0:.1f} s")
    later_paths += (dryrun_launches,)

    # 9. kernels line, 10. result ---------------------------------------
    src = "src/repro_torch/kernels/ligd_step/csrc/sweep.cu"
    kernels = [{
        "name": name, "route": "cuda", "source": src,
        "replaces": "src/repro/kernels/ligd_step/kernel.py:189",
        "launches": (launches[name] + adm_launches[name]
                     + base_launches[name]
                     + sum(c.get(name, 0) for c in later_paths)),
        "max_abs_err": max(errs[name]),
        "ms": r["ms"], "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
        "bound_by": r["bound_by"], "library_ms": None,
        "device_ms": r["device_ms"],
    } for name, r in recs.items()]
    kernels.append({
        "name": "ligd_steps", "route": "cuda",
        "source": "src/repro_torch/kernels/ligd_step/csrc/steps.cu",
        "replaces": "src/repro/kernels/ligd_step/kernel.py:113",
        **{k: steps[k] for k in ("launches", "max_abs_err", "ms",
                                 "plain_ms", "bound_ms", "bound_by",
                                 "library_ms", "device_ms")}})
    paths = (serve, serve_moe, serve_rwkv, serve_hybrid, *served_last)
    for name, src, replaces in (
            ("flash_attention",
             "src/repro_torch/kernels/flash_attention/csrc/flash_attention.cu",
             "src/repro/kernels/flash_attention/kernel.py:98"),
            ("rmsnorm", "src/repro_torch/kernels/rmsnorm/csrc/rmsnorm.cu",
             "src/repro/kernels/rmsnorm/kernel.py:27"),
            ("moe_swiglu",
             "src/repro_torch/kernels/moe_gemm/csrc/moe_swiglu.cu",
             "src/repro/kernels/moe_gemm/kernel.py:59"),
            ("rglru_scan",
             "src/repro_torch/kernels/rglru/csrc/rglru_scan.cu",
             "src/repro/kernels/rglru/kernel.py:59"),
            ("wkv6", "src/repro_torch/kernels/wkv6/csrc/wkv6.cu",
             "src/repro/kernels/wkv6/kernel.py:66")):
        r = lm[name]
        kernels.append({
            "name": name, "route": "cuda", "source": src,
            "replaces": replaces,
            "launches": (sum(pth["launches"].get(name, 0)
                             for pth in paths)
                         + sum(c.get(name, 0) for c in later_paths)),
            "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": r["library_ms"],
            "device_ms": r["device_ms"], **{k: r[k] for k in (
                "body", "decode_d2048") if k in r}})
    for name, src, replaces in (
            ("flash_attention_bwd",
             "src/repro_torch/kernels/flash_attention/csrc/"
             "flash_attention_bwd.cu",
             "src/repro/kernels/flash_attention/kernel.py:98"),
            ("rmsnorm_bwd",
             "src/repro_torch/kernels/rmsnorm/csrc/rmsnorm_bwd.cu",
             "src/repro/kernels/rmsnorm/kernel.py:27"),
            ("moe_swiglu_bwd",
             "src/repro_torch/kernels/moe_gemm/csrc/moe_swiglu_bwd.cu",
             "src/repro/kernels/moe_gemm/kernel.py:59"),
            ("rglru_scan_bwd",
             "src/repro_torch/kernels/rglru/csrc/rglru_scan_bwd.cu",
             "src/repro/kernels/rglru/kernel.py:59"),
            ("wkv6_bwd", "src/repro_torch/kernels/wkv6/csrc/wkv6_bwd.cu",
             "src/repro/kernels/wkv6/kernel.py:66")):
        r = train_k[name]
        kernels.append({
            "name": name, "route": "cuda", "source": src,
            "replaces": replaces,
            "launches": sum(c.get(name, 0) for c in later_paths),
            "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": r["library_ms"],
            "device_ms": r["device_ms"], **{k: r[k] for k in (
                "body", "serial") if k in r}})
    phase("done", f"{time.perf_counter() - t_start:.1f} s in all")
    print(card, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
