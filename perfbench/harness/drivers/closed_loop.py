"""The serving driver (``"kind": "closed_loop"``): a closed loop of
clients on the program's continuous-batching engine
(``serving.engine.InferenceEngine``).

Each client submits its next request as soon as the last token of its
previous one comes back, with no think time.  A turn of the server is
``admit()`` (each admission prefills its prompt and emits the first
token) and then ``step()`` (one decode for every slot); the host stamps
a token when the call that produced it returns, and both calls end by
reading their tokens back, so the stamps wait for the device.

Set-up builds the weights and the engine and runs the loop until every
client's first request has finished (the kernels build, every kind of
call runs, and the loop reaches its steady state).  The window then
runs whole turns for ``seconds``; after it, a sample of the requests
that finished in the window is judged against the reference
(:mod:`harness.check`).  In a traced run the per-layer metrics read on
the host clock (the turns' spans, the rate) come from the turns before
the traced part, and those of the device trace from the traced part."""
from __future__ import annotations

import gc
import sys
from typing import Callable, Optional

import numpy as np
import torch

from .. import check, common
from ..data import stream_seed
from ..traffic import RequestStream
from ..weights import make_params

#: the step index of the check sample's generator
CHECK_STREAM = 1 << 42


class _Req:
    __slots__ = ("prompt", "max_new", "submit", "times", "out", "end")

    def __init__(self, prompt, max_new, submit):
        self.prompt, self.max_new, self.submit = prompt, max_new, submit
        self.times, self.out, self.end = [], None, None


def run(m: dict, mix: dict, limits: dict, seed: int, seconds: float,
        trace: bool, device: torch.device,
        fault: Optional[Callable] = None) -> dict:
    """One run of a serving cell.  ``fault`` (tests only) is called with
    the engine before the window, to break it."""
    from repro_torch.serving.engine import InferenceEngine

    cfg = common.model_config(m)
    ts = common.now()
    params = make_params(m, seed, device)
    common.sync(device)
    tw = common.now()
    eng = InferenceEngine(cfg, params, device=device, slots=mix["slots"],
                          cache_len=mix["cache_len"])
    stream = RequestStream(mix, m["vocab_size"], seed)
    reqs: dict = {}
    log = {"admit": [], "decode": []}

    def submit(t: float) -> int:
        prompt, new = stream.next()
        rid = eng.submit(prompt, new)
        reqs[rid] = _Req(prompt, new, t)
        return rid

    def finish(rid: int, t: float) -> None:
        r = reqs[rid]
        r.out = eng.pop_result(rid)
        r.end = t
        submit(t)

    def turn(tr: bool) -> None:
        with common.span(tr, "admit"):
            ta = common.now()
            admitted = eng.admit()
            tb = common.now()
        for rid in admitted:
            reqs[rid].times.append(tb)
            if reqs[rid].max_new == 1:        # done at its prefill
                finish(rid, tb)
        if admitted:
            log["admit"].append((tb - ta, [len(reqs[r].prompt)
                                           for r in admitted], tb))
        active = eng.state.active.copy()
        pos = eng.state.pos[active].copy()
        with common.span(tr, "decode"):
            tc = common.now()
            emitted = eng.step()
            td = common.now()
        log["decode"].append((td - tc, int(active.sum()), pos, td))
        done = []
        for rid, _ in emitted:
            r = reqs[rid]
            r.times.append(td)
            if len(r.times) >= r.max_new:
                done.append(rid)
        for rid in done:
            finish(rid, td)

    first = [submit(common.now()) for _ in range(mix["clients"])]
    turns = 0
    while any(reqs[r].end is None for r in first):
        turn(False)
        turns += 1
    print(f"setup: weights {tw - ts:.2f} s, warm-up {common.now() - tw:.2f} s "
          f"({turns} turns)", file=sys.stderr)
    if fault is not None:
        fault(eng)
    log = {"admit": [], "decode": []}
    common.sync(device)
    t0 = common.now()
    part = common.TracedPart(trace, device, t0, seconds)
    while True:
        part.maybe_start()
        turn(part.running)
        t1 = common.now()
        if t1 >= t0 + seconds:
            break
    tsum = part.stop()
    host_end = part.begin if part.begin is not None else t1
    peak = common.peak_memory(device)

    in_win = [r for r in reqs.values() if r.times and t0 <= r.times[0] <= t1]
    ttft = [r.times[0] - r.submit for r in in_win]
    gaps = [b - a for r in reqs.values() for a, b in zip(r.times, r.times[1:])
            if t0 <= b <= t1]
    n_tok = sum(1 for r in reqs.values() for t in r.times if t0 <= t <= t1)
    finished = [r for r in reqs.values()
                if r.end is not None and t0 <= r.end <= t1]
    window_s = t1 - t0
    e2e = {"tokens_per_s": n_tok / window_s,
           "ttft_p95_ms": common.p95(ttft) * 1e3,
           "tpot_p95_ms": common.p95(gaps) * 1e3}
    traced = [lens for _, lens, tb in log["admit"]
              if part.t0 is not None and part.t0 <= tb <= part.t1]
    # host-clock readers: the turns before the traced part and its seconds
    ctx = {"kind": "serve", "model": m, "window_s": host_end - t0,
           "launches": part.launches, "trace": tsum,
           "admit": [(w, lens) for w, lens, tb in log["admit"]
                     if tb <= host_end],
           "traced_admit": traced,
           "decode": [(w, n, pos) for w, n, pos, td in log["decode"]
                      if td <= host_end]}

    del eng, params
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    rng = np.random.Generator(np.random.PCG64(stream_seed(seed,
                                                          CHECK_STREAM)))
    sample = check.serve_sample(finished, mix["check_requests"], rng)
    pairs = [(r.prompt, r.out) for r in sample]
    gap = check.serve_gap(m, seed, device, pairs)
    checks = {"served_logit_gap": (gap, limits["served_logit_gap"])}
    return {"e2e": e2e, "ctx": ctx, "checks": checks,
            "attempted": len(in_win), "failed": 0, "peak": peak, "t0": t0,
            "trace": tsum,
            "pairs": pairs}


def readings(m: dict, mix: dict, limits: dict, seed: int, seconds: float,
             control: bool, device) -> dict:
    """``control.py``'s readings of one seed: the program's served logit
    gap over a run's sample and, with ``control``, the float8
    reference's at the same positions."""
    r = run(m, mix, limits, seed, seconds, False, device)
    out = {"program": {"served_logit_gap": r["checks"][
        "served_logit_gap"][0]},
        "tokens": sum(len(o) for _, o in r["pairs"])}
    if control:
        gaps = check.serve_gaps(m, seed, device, r["pairs"], control=True)
        out["control"] = {"served_logit_gap": max(gaps,
                                                  default=float("inf"))}
    return out
