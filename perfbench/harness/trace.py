"""Read the profiler's trace of the measured window.

Device operations are the trace's CUDA events (kernels, copies, sets),
without the user annotations that mirror host spans on the device.
``busy_s`` is the length of the union of their intervals inside the
window, not a sum of kernel times (which would count overlap twice).
Idle gaps are named by the innermost ``bench.*`` host span and the
innermost host op that cover the gap's middle: what the host was doing
while the device waited."""
from __future__ import annotations

import bisect
import sys
import time

import torch

from .groups import groups

#: the host span that marks the measured window in a traced run
WINDOW = "bench.window"
#: a kernel name in the breakdown is cut to this many characters
NAME_CHARS = 160


def _events(raw) -> tuple:
    """(device operations (start, end, name), host spans (start, end,
    name), host ops (start, end, event)) in one pass; a host op's name
    is read only for the gaps it names."""
    dev, spans, ops = [], [], []
    cuda = torch.autograd.DeviceType.CUDA
    for e in raw:
        start = e.start_ns()
        end = start + e.duration_ns()
        if e.device_type() == cuda:
            if not e.is_user_annotation():
                dev.append((start, end, e.name()))
        elif e.is_user_annotation():
            spans.append((start, end, e.name()))
        else:
            ops.append((start, end, e))
    return dev, spans, ops


def summarize(prof, top: int = 10) -> dict:
    """{window_s, busy_s, device_s (seconds by kernel name), groups
    (seconds by op, :mod:`harness.groups`), device_ops, idle_gaps} of the
    window marked by :data:`WINDOW`."""
    t0 = time.perf_counter()
    raw = prof.profiler.kineto_results.events()
    dev, spans, ops = _events(raw)
    win = [(s, e) for s, e, n in spans if n == WINDOW]
    if not win:
        raise RuntimeError(f"no {WINDOW!r} span in the trace")
    w0, w1 = win[0]
    dev = sorted((max(s, w0), min(e, w1), n) for s, e, n in dev
                 if e > w0 and s < w1)
    device_s: dict = {}
    for s, e, n in dev:
        device_s[n] = device_s.get(n, 0.0) + (e - s) * 1e-9
    busy = 0
    gaps = []
    cur_s = cur_e = None
    for s, e, _ in dev:
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                busy += cur_e - cur_s
                gaps.append((cur_e, s))
            elif s > w0:
                gaps.append((w0, s))
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        busy += cur_e - cur_s
        if cur_e < w1:
            gaps.append((cur_e, w1))
    gaps.sort(key=lambda g: g[0] - g[1])
    spans = sorted((s, e, n) for s, e, n in spans if n != WINDOW)
    ops.sort(key=lambda o: o[0])
    span_starts = [s for s, _, _ in spans]
    op_starts = [s for s, _, _ in ops]

    def innermost(items, starts, t):
        best = None
        i = bisect.bisect_right(starts, t)
        for s, e, n in items[max(0, i - 4000):i]:
            if s <= t < e and (best is None or e - s < best[1] - best[0]):
                best = (s, e, n)
        return best[2] if best else None

    idle = []
    for a, b in gaps[:top]:
        mid = (a + b) // 2
        span = innermost(spans, span_starts, mid) or "outside spans"
        op = innermost(ops, op_starts, mid)
        idle.append([span + (f" / {op.name()}" if op is not None else ""),
                     (b - a) * 1e-9])
    ops_top = sorted(device_s.items(), key=lambda kv: -kv[1])[:top]
    ops_top = [(n if len(n) <= NAME_CHARS else n[:NAME_CHARS] + "...", sec)
               for n, sec in ops_top]
    print(f"trace: {len(raw)} events, {len(dev)} on the device, read in "
          f"{time.perf_counter() - t0:.1f} s", file=sys.stderr)
    return {"window_s": (w1 - w0) * 1e-9, "busy_s": busy * 1e-9,
            "device_s": device_s, "groups": groups(device_s),
            "device_ops": [[n, sec] for n, sec in ops_top],
            "idle_gaps": idle}
