#!/usr/bin/env python
"""Serve smoke on the PyTorch port (``repro_torch.api``), the twin of
tools/serve_smoke.py: run a ``serve_*`` preset's closed loop end-to-end
and assert the data-plane invariants hold (docs/ARCHITECTURE.md,
"Serving data plane"):

* ZERO lost requests — ``submitted == done + device + degraded`` even
  under the scripted mid-decode server kill (``drain`` raises on its
  own, but we re-check the summary arithmetic here);
* the kill actually interrupted live decode streams: at least one
  mid-stream failover event was recorded and surfaced into
  ``metrics().faults["serving_failovers"]``;
* under ``failover_mode="auto"`` at least one failover chose KV-cache
  **migration** (the preset's virtual token time makes recompute far
  pricier than shipping the cache, so auto must pick migrate);
* shed requests were degraded to device-only, never dropped
  (``shed <= degraded``);
* real tokens were emitted by the pools that stayed up.

``--adaptive`` switches to the telemetry feedback smoke instead
(docs/ARCHITECTURE.md, "Telemetry & feedback"): run the hotspot preset
twice on the same seed — closed loop (``feedback=True``, the preset's
own setting) vs open loop (``feedback=False``) — and assert the
adaptive run strictly degrades fewer requests AND ends with a lower
p99 virtual token latency.

The sessions and their engines run on ``--device`` (default ``cuda``:
the card, and no fallback without one); ``--device cpu`` takes the plain
PyTorch path and prints what tools/serve_smoke.py prints.

Run:  PYTHONPATH=src python tools/torch_serve_smoke.py [--scenario NAME]
      PYTHONPATH=src python tools/torch_serve_smoke.py --adaptive
      PYTHONPATH=src python tools/torch_serve_smoke.py --device cpu
"""
from __future__ import annotations

import argparse
import dataclasses

from repro_torch.api import Session, get_scenario


def _run_summary(sc, device):
    sess = Session(sc, device=device)
    for _ in range(sc.steps):
        sess.step()
    m = sess.run(0)
    return m.serving, m.telemetry


def adaptive_main(scenario: str, device: str = "cuda") -> int:
    sc = get_scenario(scenario)
    if sc.serving is None:
        raise SystemExit(f"scenario {sc.name!r} has no ServeConfig")
    runs = {}
    for fb in (False, True):
        s = sc.replace(serving=dataclasses.replace(sc.serving,
                                                   feedback=fb))
        sv, tel = _run_summary(s, device)
        runs[fb] = sv
        mults = (tel["compute_mult_max"] if tel else [])
        print(f"feedback={'on ' if fb else 'off'}  "
              f"degraded={sv['degraded']:4d}  shed={sv['shed']:4d}  "
              f"timeouts={sv['timeouts']:4d}  "
              f"p99_tok={sv['token_latency_p99_s']:.3f}s  "
              f"peak_mult={max(mults) if mults else 1.0:.2f}")
        assert sv["lost"] == 0, f"feedback={fb} lost requests"
    off, on = runs[False], runs[True]
    assert on["degraded"] < off["degraded"], \
        (f"closed loop must strictly degrade fewer requests: "
         f"on={on['degraded']} off={off['degraded']}")
    assert (on["token_latency_p99_s"] is not None
            and off["token_latency_p99_s"] is not None
            and on["token_latency_p99_s"] < off["token_latency_p99_s"]), \
        (f"closed loop must lower p99 token latency: "
         f"on={on['token_latency_p99_s']} "
         f"off={off['token_latency_p99_s']}")
    print(f"\nADAPTIVE_SMOKE_OK degraded {off['degraded']} -> "
          f"{on['degraded']}, p99 {off['token_latency_p99_s']:.3f}s -> "
          f"{on['token_latency_p99_s']:.3f}s")
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--scenario", default="serve_chaos_k3",
                    help="a registered preset with a ServeConfig "
                         "(default: serve_chaos_k3)")
    ap.add_argument("--min-failovers", type=int, default=1,
                    help="required mid-stream failover events (0 for "
                         "fault-free presets)")
    ap.add_argument("--adaptive", nargs="?", const="serve_hotspot_k3",
                    default=None, metavar="NAME",
                    help="run the feedback on-vs-off comparison on NAME "
                         "(default: serve_hotspot_k3) instead of the "
                         "failover smoke")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default: the card) or cpu")
    args = ap.parse_args(argv)
    if args.adaptive is not None:
        return adaptive_main(args.adaptive, args.device)

    sc = get_scenario(args.scenario)
    if sc.serving is None:
        raise SystemExit(f"scenario {sc.name!r} has no ServeConfig — "
                         f"nothing to smoke")
    if args.min_failovers > 0 and sc.faults is None:
        raise SystemExit(f"scenario {sc.name!r} has no FaultConfig but "
                         f"--min-failovers {args.min_failovers}")

    session = Session(sc, device=args.device)
    for i in range(sc.steps):
        rep = session.step()
        s = rep.serving
        print(f"step {i:2d}  t={rep.t:6.0f}s  "
              f"avail={session.topo.availability:4.2f}  "
              f"active={s['active']:4d}  queued={s['queued']:4d}  "
              f"done={s['completed']:5d}/{s['submitted']:5d}")
    m = session.run(0)          # drain raises if any request is lost
    s = m.serving

    assert s["lost"] == 0, f"data plane lost {s['lost']} request(s)"
    assert (s["submitted"] == s["completed"] + s["device"]
            + s["degraded"]), f"terminal-state arithmetic broken: {s}"
    assert s["shed"] <= s["degraded"], \
        f"shed {s['shed']} > degraded {s['degraded']} — sheds dropped?"
    assert s["tokens_emitted"] > 0, "no real decode tokens emitted"
    if args.min_failovers > 0:
        assert s["failover_events"] >= args.min_failovers, \
            (f"expected >= {args.min_failovers} mid-stream failover(s), "
             f"got {s['failover_events']}")
        fo = (m.faults or {}).get("serving_failovers")
        assert fo is not None and fo["events"] >= args.min_failovers, \
            f"failovers not surfaced into metrics().faults: {m.faults}"
        if sc.serving.failover_mode == "auto":
            assert s["failovers_migrate"] >= 1, \
                (f"auto mode never chose KV-cache migration: "
                 f"migrate={s['failovers_migrate']} "
                 f"reprefill={s['failovers_reprefill']}")
            assert fo["by_mode"]["migrate"] == s["failovers_migrate"], \
                f"by_mode split disagrees with summary: {fo['by_mode']}"

    print(f"\nSERVE_SMOKE_OK submitted={s['submitted']} "
          f"done={s['completed']} device={s['device']} "
          f"degraded={s['degraded']} lost=0 "
          f"failovers={s['failover_events']} "
          f"(migrate={s['failovers_migrate']} "
          f"reprefill={s['failovers_reprefill']}) "
          f"relay_ms={s['relay_s_total'] * 1e3:.2f} "
          f"peak_streams={s['peak_concurrent_streams']}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
