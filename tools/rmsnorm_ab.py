#!/usr/bin/env python3
"""RMSNorm kernel of this checkout against the same kernel of other
checkouts, and against ``F.rms_norm``, in one process on one CUDA card.

Each ``--other DIR`` is the root of another checkout of this repository
(for example the parent commit, unpacked with ``git archive``): its
``src/repro_torch/kernels/rmsnorm/kernel.py`` is loaded under a name of
its own, and its ``csrc/rmsnorm.cu`` is built beside this checkout's
libraries (the library's name hashes the source, so the two never mix).

For each shape, every version is first held against this checkout's
plain version (``RMS_TOL`` of ``chip_smoke.py``), then timed in rounds
ordered this, others, F.rms_norm, F.rms_norm, others reversed, this.  Per
version and round it reports

* ``ms``: ``chip_smoke.timed_ms``, the host's enqueue inside the events
  (where the host is slower than the kernel, this is the host's time);
* ``device_ms``: ``chip_smoke.device_ms``, the calls queued behind a
  sleep kernel, so only the device's work is inside;
* ``host_us``: host wall-clock per call over 200 back-to-back calls
  (fewer than the launch queue holds, so the host never waits for the
  card), the wrapper's whole host cost.

``--decode MODEL`` (default starcoder2-3b; ``none`` skips it) then serves
the model at full width and depth (random weights from the serving
seed): a prefill of 4 prompts of 128 tokens, then ``--steps`` greedy
decode steps timed on the host's clock, once with each version's wrapper
behind the model's RMSNorm, in the same ABBA order.  Everything else on
the path is this checkout's.

    python3 tools/rmsnorm_ab.py --other DIR [--other DIR ...]
        [--decode MODEL] [--steps 32] [--out report.json]

Needs a CUDA card; prints one JSON line per measurement and the whole
report as the last line (also written to ``--out`` when given).
"""
from __future__ import annotations

import argparse
import importlib.util
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
KERNEL = Path("src/repro_torch/kernels/rmsnorm/kernel.py")

#: (rows, d, dtype): starcoder2-3b's prefill and decode rows,
#: recurrentgemma-9b's prefill (4 x 2560 tokens) and decode rows, and
#: 4096 rows at d 4096
SHAPES = ((4096, 3072, "bfloat16"), (4096, 3072, "float32"),
          (10240, 4096, "bfloat16"), (4096, 4096, "bfloat16"),
          (8, 3072, "bfloat16"), (4, 4096, "bfloat16"))


def load_other(root: Path, tag: str):
    """The RMSNorm wrapper module of the checkout at ``root``."""
    path = (root / KERNEL).resolve()
    spec = importlib.util.spec_from_file_location(f"rmsnorm_{tag}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def host_us(fn, calls: int = 200) -> float:
    import torch
    for _ in range(5):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) / calls * 1e6


def abba(names: list) -> list:
    return names + names[::-1]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--other", action="append", default=[], type=Path)
    ap.add_argument("--decode", default="starcoder2-3b")
    ap.add_argument("--steps", type=int, default=32)
    ap.add_argument("--out", type=Path)
    args = ap.parse_args()

    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    import torch
    import torch.nn.functional as F
    if not torch.cuda.is_available():
        print("rmsnorm_ab: needs a CUDA card", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from repro_torch.kernels.rmsnorm import kernel as this
    from repro_torch.kernels.rmsnorm import ops, ref

    versions = {"this": this.rmsnorm_cuda}
    modules = {"this": this}
    for i, root in enumerate(args.other):
        tag = f"{root.name}_{i}"
        modules[tag] = load_other(root, tag)
        versions[tag] = modules[tag].rmsnorm_cuda
    report = {"card": cs.card_line(), "shapes": [], "decode": None}
    print(report["card"], flush=True)
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(11)
    eps = 1e-6
    for rows, d, dtn in SHAPES:
        dt = getattr(torch, dtn)
        x = torch.randn((rows, d), generator=g, device=dev).to(dt)
        w = torch.randn((d,), generator=g, device=dev).to(dt)
        w1 = (1.0 + w.float()).to(dt)
        want = ref.rmsnorm_ref(x, w, eps).float()
        tol = cs.RMS_TOL[dtn]
        fns = {n: (lambda f=f: f(x, w, eps)) for n, f in versions.items()}
        for n, fn in fns.items():
            got = fn().float()
            if not torch.allclose(got, want, atol=tol, rtol=tol):
                raise AssertionError(f"{n} {rows}x{d} {dtn}: max "
                                     f"{(got - want).abs().max().item()}")
        fns["F.rms_norm"] = lambda: F.rms_norm(x, (d,), w1, eps)
        nbytes = (2 * rows * d + d) * x.element_size()
        rec = {"rows": rows, "d": d, "dtype": dtn,
               "bound_ms": nbytes / cs.PEAK_BYTES_S * 1e3, "runs": []}
        for n in abba(list(versions) + ["F.rms_norm"]):
            run = {"version": n, "ms": cs.timed_ms(fns[n], 30, 3),
                   "device_ms": cs.device_ms(fns[n], 30, 3),
                   "host_us": host_us(fns[n])}
            rec["runs"].append(run)
            print(json.dumps({"rows": rows, "d": d, "dtype": dtn, **run}),
                  flush=True)
        report["shapes"].append(rec)
        del x, w, w1, want

    if args.decode != "none":
        report["decode"] = decode_ab(args.decode, args.steps, versions,
                                     modules, ops)
    text = json.dumps(report)
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(text)
    print(text, flush=True)
    return 0


def decode_ab(arch: str, steps: int, versions: dict, modules: dict,
              ops) -> dict:
    """Decode wall-clock per step with each version behind the model's
    RMSNorm (``ops.rmsnorm_cuda`` swapped), ABBA."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.launch import serve_split
    from repro_torch.models import transformer as tfm

    cfg = get_config(arch)
    params, tokens = serve_split.make_inputs(cfg, device="cuda", batch=4,
                                             prompt_len=128)
    S = tokens.shape[1]
    out = {"model": arch, "batch": 4, "prompt_len": S, "steps": steps,
           "runs": []}
    original = ops.rmsnorm_cuda
    try:
        for i, n in enumerate(["this"] + abba(list(versions))):
            ops.rmsnorm_cuda = versions[n]
            logits, caches = tfm.prefill(cfg, params, {"tokens": tokens},
                                         cache_len=S + steps + 1)
            cur = torch.argmax(logits[:, :cfg.vocab_size], dim=-1)
            torch.cuda.synchronize()
            before = modules[n].LAUNCHES["rmsnorm"]
            t0 = time.perf_counter()
            for j in range(steps):
                _, cur, caches = tfm.decode_step(cfg, params, cur[:, None],
                                                 S + j, caches)
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) / steps * 1e3
            run = {"version": n, "ms_per_step": ms,
                   "rmsnorm_launches": modules[n].LAUNCHES["rmsnorm"]
                   - before}
            del caches
            if i == 0:                  # the first round warms up
                out["warmup_ms_per_step"] = ms
                continue
            out["runs"].append(run)
            print(json.dumps({"decode": arch, **run}), flush=True)
    finally:
        ops.rmsnorm_cuda = original
    return out


if __name__ == "__main__":
    sys.exit(main())
