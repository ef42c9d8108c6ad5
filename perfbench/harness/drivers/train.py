"""The training driver (``"kind": "train"``): the program's train step
(``runtime.train.make_train_step``: ``loss_and_grads`` then
``optim.adamw.update``) on batches from the seed.

Set-up builds the weights, the AdamW state and the step, and drives the
same step object through its first three steps on batches 0-2 (the
kernels build and every call runs); it reads what the check needs on
the way: each step's loss, each leaf's first gradient as the optimizer
took it (its first moment over 1 - b1, after one step) and each leaf's
change after three steps (the weights made again from the seed).  The
window then runs whole steps on batches 3, 4, ... for ``seconds``,
reading each step's loss back.  In a traced run the benchmark wraps the
step's two calls, ``loss_and_grads`` and ``adamw.update``, in host spans
that end in a synchronise in the steps before the traced part (which
the host-clock metrics read), and not in the traced part (which the
device trace reads).  After the window the program's state is freed and
the reference follows the first three steps
(:func:`harness.check.reference_train`)."""
from __future__ import annotations

import contextlib
import gc
import math
import sys
from typing import Callable, Optional

import torch

from .. import check, common
from ..data import batch_at
from ..weights import get, leaf_paths, make_params

#: the steps set-up drives and the reference follows
CHECK_STEPS = 3


@contextlib.contextmanager
def _timed_calls(device, spans: dict):
    """Wrap the train step's two calls in host spans that end in a
    synchronise."""
    from repro_torch.optim import adamw
    from repro_torch.runtime import train as rt
    orig = {"fwd_bwd": (rt, "loss_and_grads"), "adamw": (adamw, "update")}
    saved = {k: getattr(mod, attr) for k, (mod, attr) in orig.items()}

    def wrap(name, fn):
        def timed(*a, **kw):
            with torch.profiler.record_function("bench." + name):
                t = common.now()
                out = fn(*a, **kw)
                common.sync(device)
                spans[name].append(common.now() - t)
            return out
        return timed

    for k, (mod, attr) in orig.items():
        setattr(mod, attr, wrap(k, saved[k]))
    try:
        yield
    finally:
        for k, (mod, attr) in orig.items():
            setattr(mod, attr, saved[k])


def run(m: dict, mix: dict, limits: dict, seed: int, seconds: float,
        trace: bool, device: torch.device,
        fault: Optional[Callable] = None) -> dict:
    """One run of a training cell.  ``fault`` (tests only) is called
    before set-up's steps and returns a context that breaks the
    program."""
    from repro_torch.optim import adamw
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.runtime.train import TrainConfig, make_train_step

    cfg = common.model_config(m)
    B, S = mix["batch"], mix["seq"]
    lr, cap = mix["lr"], mix["capacity_factor"]

    def feed(step: int) -> dict:
        return batch_at(m["vocab_size"], B, S, seed, step, device)

    ts = common.now()
    params = make_params(m, seed, device)
    opt = adamw.init(params)
    common.sync(device)
    tw = common.now()
    first = []
    step_fn = make_train_step(cfg, TrainConfig(
        adamw=AdamWConfig(lr=lr), remat=mix["remat"],
        capacity_factor=cap))
    paths = leaf_paths(m)
    prog = {"loss": [], "grad": {}, "change": {}}
    with (fault() if fault is not None else contextlib.nullcontext()):
        for k in range(CHECK_STEPS):
            params, opt, met = step_fn(params, opt, feed(k))
            prog["loss"].append(float(met["loss"]))
            first.append(common.now())
            if k == 0:
                b1 = AdamWConfig().b1
                prog["grad"] = {p: float(torch.linalg.vector_norm(
                    get(opt.m, p))) / (1.0 - b1) for p in paths}
    p0 = make_params(m, seed, device)
    with torch.no_grad():
        prog["change"] = {p: float(torch.linalg.vector_norm(
            get(params, p).float() - get(p0, p).float())) for p in paths}
    del p0
    gc.collect()
    print(f"setup: weights {tw - ts:.2f} s, steps "
          + ", ".join(f"{b - a:.2f}" for a, b in zip([tw] + first, first))
          + f" s, change {common.now() - first[-1]:.2f} s", file=sys.stderr)

    spans = {"fwd_bwd": [], "adamw": []}
    losses, host_steps, traced_steps = [], 0, 0
    common.sync(device)
    t0 = common.now()
    part = common.TracedPart(trace, device, t0, seconds)
    k = CHECK_STEPS
    while True:
        part.maybe_start()
        timed = (_timed_calls(device, spans) if trace and not part.running
                 else contextlib.nullcontext())
        with timed, common.span(part.running, "step"):
            params, opt, met = step_fn(params, opt, feed(k))
            losses.append(float(met["loss"]))
        traced_steps += part.running
        host_steps += not part.running
        t1 = common.now()
        k += 1
        if t1 >= t0 + seconds:
            break
    tsum = part.stop()
    peak = common.peak_memory(device)
    steps = len(losses)
    e2e = {"train_tokens_per_s": steps * B * S / (t1 - t0)}
    # host-clock readers: the steps before the traced part and its seconds
    host_end = part.begin if part.begin is not None else t1
    ctx = {"kind": "train", "model": m, "window_s": host_end - t0,
           "launches": part.launches, "trace": tsum, "batch": B, "seq": S,
           "steps": host_steps, "traced_steps": traced_steps,
           "remat": mix["remat"], "capacity_factor": cap, "spans": spans}

    del params, opt, step_fn, met
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    ref = check.reference_train(m, seed, device, feed, CHECK_STEPS, cap, lr)
    nums = check.train_numbers(prog, ref)
    checks = {k: (v, limits[k]) for k, v in nums.items()}
    failed = sum(1 for x in losses if not math.isfinite(x))
    return {"e2e": e2e, "ctx": ctx, "checks": checks, "attempted": steps,
            "failed": failed, "peak": peak, "trace": tsum, "t0": t0,
            "program": prog, "reference": ref}


def readings(m: dict, mix: dict, limits: dict, seed: int, seconds: float,
             control: bool, device) -> dict:
    """``control.py``'s readings of one seed: the program's numbers, each
    step's loss and the worst leaves, and with ``control`` those of the
    float8 reference and of the reference with half of each batch left
    out, in the program's place."""
    r = run(m, mix, limits, seed, seconds, False, device)
    out = {"program": {k: v for k, (v, _) in r["checks"].items()},
           "loss": {"program": r["program"]["loss"],
                    "reference": r["reference"]["loss"]},
           "worst": check.worst_leaves(r["program"], r["reference"]),
           "step_loss_gaps": check.loss_gaps(r["program"], r["reference"]),
           "unmoved_leaves": [".".join(map(str, k)) for k in
                              check.unmoved(r["reference"])]}
    if control:
        B = mix["batch"]

        def feed(step):
            return batch_at(m["vocab_size"], B, mix["seq"], seed, step,
                            device)

        for name, kw in (("control", {"quant": True}),
                         ("half_batch", {"rows": slice(0, B // 2)})):
            low = check.reference_train(m, seed, device, feed, CHECK_STEPS,
                                        mix["capacity_factor"], mix["lr"],
                                        **kw)
            out[name] = check.train_numbers(low, r["reference"])
            out[name]["step_loss_gaps"] = check.loss_gaps(low,
                                                          r["reference"])
            del low
            gc.collect()
    return out
