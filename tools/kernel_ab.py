#!/usr/bin/env python3
"""Kernel rows 1a/1b (the fused Li-GD / MLi-GD sweep), 2 (the
single-split Li-GD steps), 5 (fused expert SwiGLU), 7 (WKV6) and the
backward kernels of rows 3 (attention), 4 (RMSNorm), 5, 6 (RG-LRU) and 7
of this checkout against the same rows of other checkouts, in one
process on one CUDA card.

Each ``--other DIR`` is the root of another checkout of this repository
(for example the parent commit, unpacked with ``git archive``): its
``src/repro_torch/kernels/ligd_step``, ``moe_gemm``, ``wkv6``,
``rglru``, ``flash_attention`` and ``rmsnorm`` packages are loaded under
names of their own, and their CUDA sources are built beside this checkout's
libraries (a library's name hashes its source, so the versions never
mix).

At each shape every version is first held against this checkout's plain
version (the sweep with ``chip_smoke.compare_sweep``'s checks, its
outputs also compared with this checkout's kernel bit for bit; the steps
with ``chip_smoke.steps_errors``, at the reference test's tolerances;
``MOE_TOL``/``MOE_RMS_TOL`` and ``WKV_TOL``/``WKV_RMS_TOL`` of
``chip_smoke.py``), then timed in rounds ordered this, others, others
reversed, this (ABBA), each round giving

* ``device_ms``: ``chip_smoke.device_ms``, the calls queued behind a
  sleep kernel, so only the device's work is inside;
* ``ms``: ``chip_smoke.timed_ms``, the host's enqueue inside the events;

and, for this checkout's version, ``by_kernel``: device microseconds a
call of each CUDA kernel it launches (``torch.profiler`` over 5 calls).
``bound_ms`` is the larger of the operations over the card's peak rate
and the bytes (each input read once, each output written once) over its
memory rate, as in ``chip_smoke.py``.

Shapes: the sweep at megafleet_100k's two main-path launches (the
static Li-GD plan, X 100,000, and the first step's MLi-GD solve, X
39,595; inputs recorded from a ``Session`` run on the card), at
``chip_smoke.py``'s synthetic MLi-GD case (NiN, X 100,000, random
original strategies) and at the serving plan (X 1, starcoder2-3b's 31
splits, ``max_iters`` 200), with the plain version timed once beside
them; the steps on megafleet_100k's 100,000 users at their planned
splits (``chip_smoke.steps_groups``, 64 steps): the pass over the four
servers' groups (one launch where the version has
``ligd_steps_grouped_cuda``, else one a group), the largest group alone
and the smallest alone; MoE at granite-moe-1b-a400m's prefill (E 32, C
1280, d 1024, ff 512), an engine prefill (C 320) and engine decode (C 4),
and at moonshot-v1-16b-a3b's decode (E 64, C 1, 4, 16, d 2048, ff
1408), bf16, with the composition of 3 ``torch.bmm`` + silu timed beside
them, and at the shapes that run the mma.sync body also this checkout's
CUDA-core body (``chip_smoke.moe_cuda_cores``);
WKV6 at
rwkv6-3b's prefill (B 4, S 1024, H 40, n 64, bf16 r/k/v, from a state),
a ragged S 777 with the model's decays, and decode (B 8, S 1); the
attention backward (``attn-bwd``) at every bf16 case of
``chip_smoke.TRAIN_ATTN_CASES`` (keys randn + c where the case has an
offset), each version on its own forward's output (a version whose
backward takes the forward's LSE and residual gets them from its
forward, which is also timed with and without them), held at
``GRAD_TOL``/``GRAD_RMS_TOL`` (a breach of another version is reported,
one of this checkout's raises), with SDPA's backward timed beside them;
the RMSNorm backward (``rms-bwd``) at ``chip_smoke.TRAIN_RMS_CASES``,
with ``F.rms_norm``'s backward beside it; the expert SwiGLU backward
(``moe-bwd``) at the bf16 cases of ``chip_smoke.TRAIN_MOE_CASES``
(granite-moe-1b-a400m's training shape and a decode-sized capacity),
held at ``GRAD_TOL``/``GRAD_RMS_TOL`` against float32 autograd through
this checkout's plain forward, with autograd of the 3-``torch.bmm`` + silu
composition beside it; the WKV6 backward (``wkv-bwd``) at
``chip_smoke.TRAIN_WKV_CASES`` (rwkv6-3b's heads, bf16, with and without
a state, at S 1024 and at the serial body's S 64) and the RG-LRU scan
backward (``rglru-bwd``) at ``chip_smoke.TRAIN_RGLRU_CASES``, held at
``GRAD_TOL``/``GRAD_RMS_TOL`` against float32 autograd through this
checkout's plain versions, ``by_kernel`` for every version.  The
forward's rows (``moe``, ``wkv``) and ``rglru-bwd`` also report whether
each version's output equals this checkout's bit for bit.

    python3 tools/kernel_ab.py --other DIR [--other DIR ...] [--rounds 2]
        [--rows sweep,steps,moe,wkv,attn-bwd,rms-bwd,moe-bwd,wkv-bwd,
                rglru-bwd]
        [--out report.json]

Needs a CUDA card; prints one JSON line per measurement and the whole
report as the last line (also written to ``--out`` when given).
"""
from __future__ import annotations

import argparse
import importlib.util
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
KERNELS = Path("src/repro_torch/kernels")

MOE_SHAPES = (("prefill", 32, 1280, 1024, 512),
              ("engine prefill", 32, 320, 1024, 512),
              ("decode", 32, 4, 1024, 512),
              ("moonshot decode", 64, 1, 2048, 1408),
              ("moonshot decode", 64, 4, 2048, 1408),
              ("moonshot decode", 64, 16, 2048, 1408))
WKV_SHAPES = (("prefill", 4, 1024, 40, 64, "uniform"),
              ("ragged, model decays", 1, 777, 40, 64, "model"),
              ("decode", 8, 1, 40, 64, "uniform"))


def load_package(root: Path, sub: str, tag: str):
    """The kernel package ``sub`` (``moe_gemm``, ``wkv6``, ...) of the
    checkout at ``root``, imported as a package named ``tag`` so that its
    relative imports resolve inside that checkout."""
    pkg = (root / KERNELS / sub).resolve()
    spec = importlib.util.spec_from_file_location(
        tag, pkg / "__init__.py", submodule_search_locations=[str(pkg)])
    mod = importlib.util.module_from_spec(spec)
    sys.modules[tag] = mod
    spec.loader.exec_module(mod)
    return mod


def by_kernel(fn, calls: int = 5) -> dict:
    """Device microseconds a call, by kernel name, over ``calls`` calls
    of ``fn`` (``chip_smoke.by_kernel``)."""
    import chip_smoke as cs
    return cs.by_kernel(fn, calls)


def sweep_cases(device) -> list:
    """(label, (feat, x0, tables, wrapper keyword arguments)) of the four
    sweep shapes."""
    import chip_smoke as cs
    from repro_torch.api import Session, get_scenario
    from repro_torch.configs import get_config, nin
    from repro_torch.core.profile import profile_of
    from repro_torch.kernels.ligd_step import ops as sweep_ops
    from repro_torch.launch import serve_split
    seen, unspy = cs.record_first_launches(sweep_ops)
    try:
        Session(get_scenario("megafleet_100k")).run()
    finally:
        unspy()
    plan, unspy = cs.record_first_launches(sweep_ops)
    try:
        serve_split.plan_split(get_config(serve_split.ARCH), seq=1024,
                               batch=4, c_dev=serve_split.C_DEV,
                               device=device)
    finally:
        unspy()
    return [("1a main path, megafleet_100k Li-GD", seen["ligd_sweep"]),
            ("1b main path, megafleet_100k first MLi-GD",
             seen["mligd_sweep"]),
            ("1b synthetic, NiN random strategies",
             cs.synthetic_case(profile_of(nin()), 100_000, True, 60,
                               device)),
            ("1a serving plan, starcoder2-3b", plan["ligd_sweep"])]


def sweep_rows(versions: dict, rounds: int, device) -> list:
    """Rows 1a/1b: every version against this checkout's plain version
    (``chip_smoke.sweep_errors``) and kernel, then ABBA rounds of device
    and host-inclusive ms."""
    import torch
    import chip_smoke as cs
    from repro_torch.kernels import ligd_step
    out = []
    for label, (feat, x0, tab, kw) in sweep_cases(device):
        kw = dict(kw)
        joint = kw.pop("joint")
        name = "mligd_sweep" if joint else "ligd_sweep"
        ref = ligd_step.mligd_sweep_ref if joint else ligd_step.ligd_sweep_ref
        plain = ref(feat, x0, tab, chunk=1, **kw)
        fns = {v: (lambda f=f: f(feat, x0, tab, joint=joint, **kw))
               for v, f in versions.items()}
        want = fns["this"]()
        for v, fn in fns.items():
            got = fn()
            err, breaches = cs.sweep_errors(got, plain)
            same = all(torch.equal(a, b) for a, b in zip(got, want))
            print(json.dumps({"kernel": name, "case": label, "version": v,
                              "equal_to_this": same, **err}), flush=True)
            if breaches:
                raise AssertionError(f"{name} {v} {label}: "
                                     + "; ".join(breaches))
        rec = {"case": label, "X": feat.shape[1], "M1": tab.shape[0],
               "max_iters": kw["max_iters"],
               "plain_ms": cs.timed_ms(lambda: ref(feat, x0, tab, chunk=1,
                                                   **kw), 3, 1),
               "runs": []}
        for v in abba(list(versions), rounds):
            run = {"version": v, "device_ms": cs.device_ms(fns[v], 30, 3),
                   "ms": cs.timed_ms(fns[v], 30, 3)}
            rec["runs"].append(run)
            print(json.dumps({"kernel": name, "case": label, **run}),
                  flush=True)
        out.append(rec)
    return out


def steps_pass(mod, feat, x0, offsets, ets, iters, lr):
    """A call of a version's steps over the groups at ``offsets``: one
    launch through ``ligd_steps_grouped_cuda`` where the version has it,
    else one ``ligd_steps_cuda`` launch a group.  The call returns the
    list of (x, U) it got."""
    if hasattr(mod, "ligd_steps_grouped_cuda"):
        return lambda: [mod.ligd_steps_grouped_cuda(
            feat, x0, offsets, ets, iters=iters, lr=lr)]
    return lambda: [mod.ligd_steps_cuda(feat[a:b], x0[a:b], et, iters=iters,
                                        lr=lr)
                    for a, b, et in zip(offsets, offsets[1:], ets)]


def steps_rows(versions: dict, rounds: int, device) -> list:
    """Row 2: every version against this checkout's plain version and
    kernel, then ABBA rounds of device and host-inclusive ms, at the
    pass, the largest group and the smallest group."""
    import torch
    import chip_smoke as cs
    from repro_torch.api import Session, get_scenario
    from repro_torch.kernels.ligd_step import (edge_tuple_of,
                                               ligd_steps_grouped_ref)
    sess = Session(get_scenario("megafleet_100k"))
    sess.run()
    feat, x0, offsets, edges = cs.steps_groups(sess, device)
    del sess
    iters, lr = 64, 0.15
    sizes = [b - a for a, b in zip(offsets, offsets[1:])]
    cases = [(f"pass, {len(sizes)} groups", list(range(len(sizes))))]
    for label, pick in (("largest group alone", max),
                     ("smallest group alone", min)):
        cases.append((label, [pick(range(len(sizes)),
                                   key=sizes.__getitem__)]))
    out = []
    for label, groups in cases:
        a, b = offsets[groups[0]], offsets[groups[-1] + 1]
        f, x, es = feat[a:b], x0[a:b], [edges[j] for j in groups]
        offs = [offsets[j] - a for j in groups] + [b - a]
        ets = [edge_tuple_of(e) for e in es]
        xr, ur = ligd_steps_grouped_ref(f, x, offs, es, iters=iters, lr=lr)
        fns = {v: steps_pass(m, f, x, offs, ets, iters, lr)
               for v, m in versions.items()}
        want = fns["this"]()[0]
        for v, fn in fns.items():
            got = fn()
            gx = torch.cat([g[0] for g in got])
            gu = torch.cat([g[1] for g in got])
            err = cs.steps_errors(gx, gu, xr, ur, f, x)
            same = bool(torch.equal(gx, want[0]) and torch.equal(gu, want[1]))
            print(json.dumps({"kernel": "ligd_steps", "case": label,
                              "version": v, "equal_to_this": same, **err}),
                  flush=True)
            if not err["within_tolerance"]:
                raise AssertionError(f"ligd_steps {v} {label}: {err}")
        bound, by = cs.steps_bound_ms(b - a, iters)
        rec = {"case": label, "X": b - a, "groups": [sizes[j] for j in groups],
               "bound_ms": bound, "bound_by": by, "runs": []}
        for v in abba(list(versions), rounds):
            run = {"version": v, "device_ms": cs.device_ms(fns[v], 30, 3),
                   "ms": cs.timed_ms(fns[v], 30, 3)}
            rec["runs"].append(run)
            print(json.dumps({"kernel": "ligd_steps", "case": label, **run}),
                  flush=True)
        out.append(rec)
    return out


def attn_bwd_rows(versions: dict, rounds: int, device) -> list:
    """Row 3's backward: every version against float32 autograd through
    this checkout's plain version, then ABBA rounds with SDPA's backward
    (``enable_gqa``, the window mask) as the library."""
    import inspect
    import torch
    import torch.nn.functional as F
    import chip_smoke as cs
    from repro_torch.kernels import flash_attention as fa
    g = torch.Generator(device=device).manual_seed(12)
    out = []
    for B, S, (Hq, Hkv, hd), window, dtn, c in cs.TRAIN_ATTN_CASES:
        if dtn != "bfloat16":
            continue
        dt = torch.bfloat16
        q = torch.randn((B, S, Hq, hd), generator=g, device=device).to(dt)
        k = (torch.randn((B, S, Hkv, hd), generator=g, device=device)
             + c).to(dt)
        v = torch.randn((B, S, Hkv, hd), generator=g, device=device).to(dt)
        dout = torch.randn((B, S, Hq, hd), generator=g,
                           device=device).to(dt)
        kw = dict(causal=True, window=window)
        leaves = [t.float().requires_grad_() for t in (q, k, v)]
        want = torch.autograd.grad(fa.attention_ref(*leaves, **kw), leaves,
                                   dout.float())
        del leaves
        label = f"B {B}, S {S}, {Hq}/{Hkv} x {hd}, window {window}, c {c:g}"
        fns, held, fwd = {}, {}, {}
        for name, mod in versions.items():
            takes_stats = "lse" in inspect.signature(
                mod.flash_attention_bwd_cuda).parameters
            if takes_stats:
                o, lse, lo = mod.flash_attention_cuda(q, k, v, stats=True,
                                                      **kw)
                extra = dict(lse=lse, out_lo=lo)
                fwd[name] = {
                    "fwd_ms": cs.timed_ms(
                        lambda m=mod: m.flash_attention_cuda(q, k, v, **kw),
                        30, 3),
                    "fwd_stats_ms": cs.timed_ms(
                        lambda m=mod: m.flash_attention_cuda(
                            q, k, v, stats=True, **kw), 30, 3)}
            else:
                o, extra = mod.flash_attention_cuda(q, k, v, **kw), {}
            fns[name] = (lambda m=mod, o=o, e=extra:
                         m.flash_attention_bwd_cuda(q, k, v, o, dout, **kw,
                                                    **e))
            got = fns[name]()
            again = fns[name]()
            torch.cuda.synchronize()
            errs = [cs.grad_errors(a, b, dtn) for a, b in zip(got, want)]
            held[name] = {
                "same_bits": all(torch.equal(a, b)
                                 for a, b in zip(got, again)),
                "rel_rms": {f"d{n}": e[1] for n, e in zip("qkv", errs)},
                "within_tolerance": all(e[2] for e in errs)}
            print(json.dumps({"kernel": "flash_attention_bwd",
                              "case": label, "version": name,
                              **held[name]}), flush=True)
            if name == "this" and not (held[name]["within_tolerance"]
                                       and held[name]["same_bits"]):
                raise AssertionError(f"flash_attention_bwd {label}: "
                                     f"{held[name]}")
            del got, again
        qh, kh, vh = (t.transpose(1, 2).detach().requires_grad_()
                      for t in (q, k, v))
        mask = None
        if window:
            i = torch.arange(S, device=device)
            mask = (i[:, None] >= i[None, :]) & (i[:, None] - i[None, :]
                                                  < window)
        lib = F.scaled_dot_product_attention(
            qh, kh, vh, attn_mask=mask, is_causal=mask is None,
            enable_gqa=True)
        dh = dout.transpose(1, 2)
        fns["library"] = lambda: torch.autograd.grad(
            lib, (qh, kh, vh), dh, retain_graph=True)
        pairs = cs.attention_pairs(S, True, window)
        flops = 2.5 * 4.0 * B * Hq * hd * pairs
        rec = {"case": label, "held": held, "forward": fwd,
               "flops": flops,
               "bound_ms": max(flops / cs.PEAK_BF16_S, 4 * (q.numel()
                               + k.numel()) * 2 / cs.PEAK_BYTES_S) * 1e3,
               "by_kernel": by_kernel(fns["this"]), "runs": []}
        for name in abba(list(versions) + ["library"], rounds):
            run = {"version": name,
                   "device_ms": cs.device_ms(fns[name], 30, 3),
                   "ms": cs.timed_ms(fns[name], 30, 3)}
            rec["runs"].append(run)
            print(json.dumps({"kernel": "flash_attention_bwd",
                              "case": label, **run}), flush=True)
        out.append(rec)
        del q, k, v, dout, want, fns, lib
    return out


def rms_bwd_rows(versions: dict, rounds: int, device) -> list:
    """Row 4's backward: every version against float32 autograd through
    this checkout's plain version, then ABBA rounds with ``F.rms_norm``'s
    backward as the library."""
    import torch
    import torch.nn.functional as F
    import chip_smoke as cs
    from repro_torch.kernels import rmsnorm as rn
    g = torch.Generator(device=device).manual_seed(13)
    out = []
    for rows, d, dtn in cs.TRAIN_RMS_CASES:
        dt = getattr(torch, dtn)
        x, w, gy = (torch.randn(shape, generator=g, device=device).to(dt)
                    for shape in ((rows, d), (d,), (rows, d)))
        xf, wf = x.float().requires_grad_(), w.float().requires_grad_()
        want = torch.autograd.grad(rn.rmsnorm_ref(xf, wf, 1e-6), (xf, wf),
                                   gy.float())
        label = f"{rows} x {d} {dtn}"
        fns = {name: (lambda f=f: f(x, w, gy, 1e-6))
               for name, f in versions.items()}
        for name, fn in fns.items():
            got, again = fn(), fn()
            torch.cuda.synchronize()
            errs = [cs.grad_errors(a, b, dtn) for a, b in zip(got, want)]
            ok = all(e[2] for e in errs) and all(
                torch.equal(a, b) for a, b in zip(got, again))
            print(json.dumps({"kernel": "rmsnorm_bwd", "case": label,
                              "version": name, "held": ok}), flush=True)
            if not ok:
                raise AssertionError(f"rmsnorm_bwd {name} {label}")
        xl = x.detach().requires_grad_()
        wl = (1.0 + w.float()).to(dt).requires_grad_()
        yl = F.rms_norm(xl, (d,), wl, 1e-6)
        fns["library"] = lambda: torch.autograd.grad(yl, (xl, wl), gy,
                                                     retain_graph=True)
        rec = {"case": label,
               "bound_ms": (3 * rows * d + 2 * d) * x.element_size()
               / cs.PEAK_BYTES_S * 1e3,
               "by_kernel": by_kernel(fns["this"]), "runs": []}
        for name in abba(list(versions) + ["library"], rounds):
            run = {"version": name,
                   "device_ms": cs.device_ms(fns[name], 30, 3),
                   "ms": cs.timed_ms(fns[name], 30, 3)}
            rec["runs"].append(run)
            print(json.dumps({"kernel": "rmsnorm_bwd", "case": label,
                              **run}), flush=True)
        out.append(rec)
    return out


def moe_bwd_rows(versions: dict, rounds: int, device) -> list:
    """Row 5's backward: every version against float32 autograd through
    this checkout's plain forward, twice for the same bits, then ABBA
    rounds with autograd of the 3-``torch.bmm`` + silu composition as the
    library."""
    import torch
    import torch.nn.functional as F
    import chip_smoke as cs
    from repro_torch.kernels import moe_gemm as mg
    g = torch.Generator(device=device).manual_seed(14)
    out = []
    for E, C, d, ff, dtn in cs.TRAIN_MOE_CASES:
        if dtn != "bfloat16":
            continue
        dt = torch.bfloat16

        def randn(shape, scale=1.0):
            return (torch.randn(shape, generator=g, device=device)
                    * scale).to(dt)

        x, dy = randn((E, C, d)), randn((E, C, d))
        wg, wu = randn((E, d, ff), d ** -0.5), randn((E, d, ff), d ** -0.5)
        wd = randn((E, ff, d), ff ** -0.5)
        leaves = [t.float().requires_grad_() for t in (x, wg, wu, wd)]
        want = torch.autograd.grad(mg.moe_swiglu_ref(*leaves), leaves,
                                   dy.float())
        del leaves
        label = f"E {E}, C {C}, d {d}, ff {ff}"
        fns = {name: (lambda f=f: f(x, wg, wu, wd, dy))
               for name, f in versions.items()}
        held = {}
        for name, fn in fns.items():
            got, again = fn(), fn()
            torch.cuda.synchronize()
            errs = [cs.grad_errors(a, b, dtn) for a, b in zip(got, want)]
            held[name] = {
                "same_bits": all(torch.equal(a, b)
                                 for a, b in zip(got, again)),
                "rel_rms": {n: e[1] for n, e in
                            zip(("dx", "dwg", "dwu", "dwd"), errs)},
                "within_tolerance": all(e[2] for e in errs)}
            print(json.dumps({"kernel": "moe_swiglu_bwd", "case": label,
                              "version": name, **held[name]}), flush=True)
            if name == "this" and not (held[name]["within_tolerance"]
                                       and held[name]["same_bits"]):
                raise AssertionError(f"moe_swiglu_bwd {label}: "
                                     f"{held[name]}")
            del got, again
        xl, gl, ul, dl = (t.detach().requires_grad_()
                          for t in (x, wg, wu, wd))

        def library():
            yl = torch.bmm(F.silu(torch.bmm(xl, gl)) * torch.bmm(xl, ul), dl)
            return torch.autograd.grad(yl, (xl, gl, ul, dl), dy)

        fns["composition"] = library
        flops = 12.0 * E * C * d * ff
        rec = {"case": label, "held": held, "flops": flops,
               "bound_ms": max(flops / cs.PEAK_BF16_S,
                               2 * (2 * x.numel() + 3 * wg.numel()) * 2
                               / cs.PEAK_BYTES_S) * 1e3,
               "by_kernel": by_kernel(fns["this"]), "runs": []}
        print(json.dumps({"kernel": "moe_swiglu_bwd", "case": label,
                          "by_kernel": rec["by_kernel"]}), flush=True)
        for name in abba(list(versions) + ["composition"], rounds):
            run = {"version": name,
                   "device_ms": cs.device_ms(fns[name], 30, 3),
                   "ms": cs.timed_ms(fns[name], 30, 3)}
            rec["runs"].append(run)
            print(json.dumps({"kernel": "moe_swiglu_bwd", "case": label,
                              **run}), flush=True)
        out.append(rec)
        del x, dy, wg, wu, wd, want, fns
    return out


def _held(kernel: str, label: str, name: str, got, again, want,
          names, dtn: str) -> dict:
    """One version's gradients against the float32 reference: the error
    RMS ratio of each, within ``GRAD_TOL``/``GRAD_RMS_TOL``, the same bits
    twice; printed, and raised for this checkout's version."""
    import torch
    import chip_smoke as cs
    errs = [cs.grad_errors(a, b, dtn) for a, b in zip(got, want)]
    held = {"same_bits": all((a is None and b is None) or torch.equal(a, b)
                             for a, b in zip(got, again)),
            "rel_rms": {n: e[1] for n, e in zip(names, errs)},
            "within_tolerance": all(e[2] for e in errs)}
    print(json.dumps({"kernel": kernel, "case": label, "version": name,
                      **held}), flush=True)
    if name.startswith("this") and not (held["within_tolerance"]
                                        and held["same_bits"]):
        raise AssertionError(f"{kernel} {label} {name}: {held}")
    return held


def _timed(kernel: str, label: str, fns: dict, rec: dict,
           rounds: int) -> None:
    """by_kernel of every version, then ABBA rounds of device_ms and ms."""
    import chip_smoke as cs
    rec["by_kernel"] = {}
    for name, fn in fns.items():
        rec["by_kernel"][name] = by_kernel(fn)
        print(json.dumps({"kernel": kernel, "case": label, "version": name,
                          "by_kernel": rec["by_kernel"][name]}), flush=True)
    rec["runs"] = []
    for name in abba(list(fns), rounds):
        run = {"version": name, "device_ms": cs.device_ms(fns[name], 10, 2),
               "ms": cs.timed_ms(fns[name], 10, 2)}
        rec["runs"].append(run)
        print(json.dumps({"kernel": kernel, "case": label, **run}),
              flush=True)


def wkv_bwd_rows(versions: dict, rounds: int, device) -> list:
    """Row 7's backward at ``chip_smoke.TRAIN_WKV_CASES`` (rwkv6-3b's
    heads, bf16, with and without a state, both bodies), w with entries 0
    and 1: every version against float32 autograd through this
    checkout's plain recurrence, twice for the same bits, then by_kernel
    and ABBA rounds."""
    import torch
    import chip_smoke as cs
    from repro_torch.kernels import wkv6
    g = torch.Generator(device=device).manual_seed(18)
    out = []
    for B, S, H, n, dtn, with_s0 in cs.TRAIN_WKV_CASES:
        dt = getattr(torch, dtn)

        def rn(shape, scale=1.0):
            return torch.randn(shape, generator=g, device=device) * scale

        r, k, v = (rn((B, S, H, n), 0.5).to(dt) for _ in range(3))
        w = torch.rand((B, S, H, n), generator=g, device=device)
        w[..., ::7] = 0.0
        w[..., 3::11] = 1.0
        u, dy = rn((H, n), 0.5), rn((B, S, H, n))
        s0 = rn((B, H, n, n), 0.5) if with_s0 else None
        ds = rn((B, H, n, n)) if with_s0 else None
        leaves = [t.float().requires_grad_() for t in (r, k, v, w, u)]
        if with_s0:
            leaves.append(s0.clone().requires_grad_())
        y, s_fin = wkv6.wkv6_ref(*leaves[:5], leaves[5] if with_s0 else None)
        outs, grads = ([y, s_fin], [dy, ds]) if with_s0 else ([y], [dy])
        want = torch.autograd.grad(outs, leaves, grads)
        del y, s_fin, outs, leaves
        label = f"B {B}, S {S}, H {H}, n {n}, {dtn}" + (", s0" if with_s0
                                                         else "")
        fns = {name: (lambda f=f: f(r, k, v, w, u, s0, dy, ds))
               for name, f in versions.items()}
        rec = {"case": label, "held": {},
               "bound_ms": cs.WKV_BWD_OPS * B * S * H * n * n / cs.ISSUE_S
               * 1e3}
        for name, fn in fns.items():
            got, again = fn(), fn()
            torch.cuda.synchronize()
            rec["held"][name] = _held(
                "wkv6_bwd", label, name, [t for t in got if t is not None],
                [t for t in again if t is not None], want,
                ("dr", "dk", "dv", "dw", "du", "ds0"), dtn)
            del got, again
        _timed("wkv6_bwd", label, fns, rec, rounds)
        out.append(rec)
        del want, fns
    return out


def rglru_bwd_rows(versions: dict, rounds: int, device) -> list:
    """Row 6's backward at ``chip_smoke.TRAIN_RGLRU_CASES``
    (recurrentgemma-9b's training shape, a near 1 and near 0): every
    version against float32 autograd through this checkout's plain scan,
    twice for the same bits, and whether it equals this checkout's output
    bit for bit; then by_kernel and ABBA rounds."""
    import torch
    import chip_smoke as cs
    from repro_torch.kernels import rglru
    g = torch.Generator(device=device).manual_seed(19)
    out = []
    for B, S, C, a_near in cs.TRAIN_RGLRU_CASES:
        jitter = torch.rand((B, S, C), generator=g, device=device) * 1e-3
        a = 1.0 - jitter if a_near == 1.0 else jitter
        b = torch.randn((B, S, C), generator=g, device=device)
        dh = torch.randn((B, S, C), generator=g, device=device)
        h = rglru.rglru_scan_cuda(a, b)
        leaves = [a.clone().requires_grad_(), b.clone().requires_grad_()]
        want = torch.autograd.grad(rglru.rglru_scan_ref(*leaves), leaves, dh)
        del leaves
        label = f"B {B}, S {S}, C {C}, a~{a_near:g}"
        fns = {name: (lambda f=f: f(a, h, dh))
               for name, f in versions.items()}
        rec = {"case": label, "held": {}, "same_bits_as_this": {},
               "bound_ms": 20 * a.numel() / cs.PEAK_BYTES_S * 1e3}
        mine = fns["this"]()
        for name, fn in fns.items():
            got, again = fn(), fn()
            torch.cuda.synchronize()
            rec["held"][name] = _held("rglru_scan_bwd", label, name, got,
                                      again, want, ("da", "db"), "float32")
            rec["same_bits_as_this"][name] = all(
                torch.equal(x, y) for x, y in zip(got, mine))
            del got, again
        _timed("rglru_scan_bwd", label, fns, rec, rounds)
        out.append(rec)
        del want, fns, mine
    return out


def abba(names: list, rounds: int) -> list:
    order = []
    for _ in range(rounds):
        order += names + names[::-1]
    return order


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--other", action="append", default=[], type=Path)
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--rows", default="sweep,steps,moe,wkv",
                    help="comma-separated subset of sweep, steps, moe, "
                    "wkv, attn-bwd, rms-bwd, moe-bwd, wkv-bwd, rglru-bwd")
    ap.add_argument("--out", type=Path)
    args = ap.parse_args()

    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    import torch
    import torch.nn.functional as F
    if not torch.cuda.is_available():
        print("kernel_ab: needs a CUDA card", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from repro_torch.kernels import (flash_attention, ligd_step, moe_gemm,
                                     rglru, rmsnorm, wkv6)
    from repro_torch.kernels.moe_gemm import kernel as moe_kernel

    rows = set(args.rows.split(","))
    sweep = {"this": ligd_step.sweep_cuda}
    steps = {"this": ligd_step}
    moe = {"this": moe_gemm.moe_swiglu_cuda}
    wkv = {"this": wkv6.wkv6_cuda}
    attn = {"this": flash_attention}
    rms = {"this": rmsnorm.rmsnorm_bwd_cuda}
    moe_bwd = {"this": moe_gemm.moe_swiglu_bwd_cuda}
    wkv_bwd = {"this": wkv6.wkv6_bwd_cuda}
    rglru_bwd = {"this": rglru.rglru_scan_bwd_cuda}
    for i, root in enumerate(args.other):
        tag = f"{root.name}_{i}"
        if rows & {"sweep", "steps"}:
            other = load_package(root, "ligd_step", f"other{i}_ligd_step")
            sweep[tag], steps[tag] = other.sweep_cuda, other
        if rows & {"moe", "moe-bwd"}:
            other = load_package(root, "moe_gemm", f"other{i}_moe_gemm")
            moe[tag] = other.moe_swiglu_cuda
            moe_bwd[tag] = other.moe_swiglu_bwd_cuda
        if rows & {"wkv", "wkv-bwd"}:
            other = load_package(root, "wkv6", f"other{i}_wkv6")
            wkv[tag], wkv_bwd[tag] = other.wkv6_cuda, other.wkv6_bwd_cuda
        if "rglru-bwd" in rows:
            rglru_bwd[tag] = load_package(
                root, "rglru", f"other{i}_rglru").rglru_scan_bwd_cuda
        if "attn-bwd" in rows:
            attn[tag] = load_package(root, "flash_attention",
                                     f"other{i}_flash_attention")
        if "rms-bwd" in rows:
            rms[tag] = load_package(root, "rmsnorm",
                                    f"other{i}_rmsnorm").rmsnorm_bwd_cuda
    report = {"card": cs.card_line(), "sweep": [], "ligd_steps": [],
              "moe_swiglu": [], "wkv6": [], "flash_attention_bwd": [],
              "rmsnorm_bwd": [], "moe_swiglu_bwd": [], "wkv6_bwd": [],
              "rglru_scan_bwd": []}
    print(report["card"], flush=True)
    dev = torch.device("cuda")
    if "sweep" in rows:
        report["sweep"] = sweep_rows(sweep, args.rounds, dev)
    if "steps" in rows:
        report["ligd_steps"] = steps_rows(steps, args.rounds, dev)
    if "attn-bwd" in rows:
        report["flash_attention_bwd"] = attn_bwd_rows(attn, args.rounds, dev)
    if "rms-bwd" in rows:
        report["rmsnorm_bwd"] = rms_bwd_rows(rms, args.rounds, dev)
    if "moe-bwd" in rows:
        report["moe_swiglu_bwd"] = moe_bwd_rows(moe_bwd, args.rounds, dev)
    if "wkv-bwd" in rows:
        report["wkv6_bwd"] = wkv_bwd_rows(wkv_bwd, args.rounds, dev)
    if "rglru-bwd" in rows:
        report["rglru_scan_bwd"] = rglru_bwd_rows(rglru_bwd, args.rounds,
                                                  dev)
    g = torch.Generator(device=dev).manual_seed(17)

    def randn(shape, scale=1.0):
        return torch.randn(shape, generator=g, device=dev) * scale

    for label, E, C, d, ff in MOE_SHAPES if "moe" in rows else ():
        x = randn((E, C, d)).bfloat16()
        wg = randn((E, d, ff), d ** -0.5).bfloat16()
        wu = randn((E, d, ff), d ** -0.5).bfloat16()
        wd = randn((E, ff, d), ff ** -0.5).bfloat16()
        want = moe_gemm.moe_swiglu_ref(x, wg, wu, wd).float()
        tol, rms_tol = cs.MOE_TOL["bfloat16"], cs.MOE_RMS_TOL["bfloat16"]
        fns = {n: (lambda f=f: f(x, wg, wu, wd)) for n, f in moe.items()}
        if moe_kernel.body_for(x.dtype, C, d, ff) == "mma":
            fns["cuda_cores"] = lambda: cs.moe_cuda_cores(x, wg, wu, wd)
        mine = fns["this"]()
        same = {}
        for n, fn in fns.items():
            out16 = fn()
            same[n] = torch.equal(out16, mine)
            got = out16.float()
            rr = cs.rel_rms(got, want)
            if not (torch.allclose(got, want, atol=tol, rtol=tol)
                    and rr <= rms_tol):
                raise AssertionError(f"moe_swiglu {n} {label}: max "
                                     f"{(got - want).abs().max().item()}, "
                                     f"RMS ratio {rr}")
        fns["composition"] = lambda: torch.bmm(
            F.silu(torch.bmm(x, wg)) * torch.bmm(x, wu), wd)
        rec = {"case": label, "E": E, "C": C, "d": d, "ff": ff,
               "same_bits_as_this": same,
               "bound_ms": max(6.0 * E * C * d * ff / cs.PEAK_BF16_S,
                               (2 * E * C * d + 3 * E * d * ff) * 2
                               / cs.PEAK_BYTES_S) * 1e3,
               "by_kernel": by_kernel(fns["this"]), "runs": []}
        print(json.dumps({"kernel": "moe_swiglu", "case": label,
                          "same_bits_as_this": same,
                          "by_kernel": rec["by_kernel"]}), flush=True)
        for n in abba(list(fns), args.rounds):
            run = {"version": n, "device_ms": cs.device_ms(fns[n], 30, 3),
                   "ms": cs.timed_ms(fns[n], 30, 3)}
            rec["runs"].append(run)
            print(json.dumps({"kernel": "moe_swiglu", "case": label, **run}),
                  flush=True)
        report["moe_swiglu"].append(rec)
        del x, wg, wu, wd, want, mine

    for label, B, S, H, n, decays in WKV_SHAPES if "wkv" in rows else ():
        r, k, v = (randn((B, S, H, n)).bfloat16() for _ in range(3))
        if decays == "model":
            w = torch.exp(-torch.exp(torch.clamp(
                randn((B, S, H, n), 6.0) + 1.0, -20.0, 10.0)))
        else:
            w = torch.rand((B, S, H, n), generator=g, device=dev) * 0.65 \
                + 0.3
        u = randn((H, n), 0.5)
        s0 = randn((B, H, n, n), 0.5)
        want_y, want_s = wkv6.wkv6_ref(r, k, v, w, u, s0)
        fns = {nm: (lambda f=f: f(r, k, v, w, u, s0))
               for nm, f in wkv.items()}
        mine_y, mine_s = fns["this"]()
        same = {}
        for nm, fn in fns.items():
            y, s = fn()
            same[nm] = torch.equal(y, mine_y) and torch.equal(s, mine_s)
            rr = max(cs.rel_rms(y, want_y), cs.rel_rms(s, want_s))
            if not (torch.allclose(y, want_y, atol=cs.WKV_TOL,
                                   rtol=cs.WKV_TOL)
                    and torch.allclose(s, want_s, atol=cs.WKV_TOL,
                                       rtol=cs.WKV_TOL)
                    and rr <= cs.WKV_RMS_TOL):
                raise AssertionError(f"wkv6 {nm} {label}: RMS ratio {rr}")
        rec = {"case": label, "B": B, "S": S, "H": H, "n": n,
               "same_bits_as_this": same,
               "bound_ms": max(3.0 * B * S * H * n * n / cs.ISSUE_S,
                               (B * S * H * n * (3 * 2 + 4 + 4)
                                + 2 * B * H * n * n * 4 + H * n * 4)
                               / cs.PEAK_BYTES_S) * 1e3,
               "by_kernel": by_kernel(fns["this"]), "runs": []}
        print(json.dumps({"kernel": "wkv6", "case": label,
                          "same_bits_as_this": same,
                          "by_kernel": rec["by_kernel"]}), flush=True)
        for nm in abba(list(wkv), args.rounds):
            run = {"version": nm, "device_ms": cs.device_ms(fns[nm], 30, 3),
                   "ms": cs.timed_ms(fns[nm], 30, 3)}
            rec["runs"].append(run)
            print(json.dumps({"kernel": "wkv6", "case": label, **run}),
                  flush=True)
        report["wkv6"].append(rec)

    text = json.dumps(report)
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(text)
    print(text, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
