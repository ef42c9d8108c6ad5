"""Closed-loop serving entry point: the MCSA system serving real streams.

The port of the JAX package's ``repro/launch/serve.py``, the paper's
whole system as one loop:

  1. a ``repro_torch.api`` Scenario declares the world (APs, edge
     servers, fleet, mobility, faults) and a ``ServeConfig`` workload;
  2. the Session plans it (Li-GD splits, admission r/B budgets: the
     sweep kernel on the card) and builds one engine pool per edge
     server, slots sized from the admitted r usage;
  3. each step, seeded Poisson arrivals hit the pools and real decode
     streams run under deadlines, backpressure and — when the scenario
     scripts a server kill — mid-stream failover onto the planner's
     evacuation targets (the engines' prefill and decode on the card);
  4. ``metrics().serving`` reports the request outcomes and p50/p99 token
     latency, and the §6 baseline table prints next to it.

    python -m repro_torch.launch.serve                   # the card
    python -m repro_torch.launch.serve --device cpu      # plain PyTorch
    python -m repro_torch.launch.serve --failover-demo

The engines are the preset's reduced ``engine_arch`` (``engine_layers``
layers at CPU scale), as in the reference.  Exits non-zero if the data
plane loses a request.
"""
from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np
import torch

from repro_torch.api import Session, get_scenario

#: the §6 baselines printed beside the serving summary
BASELINES = ("device_only", "edge_only", "neurosurgeon", "dnn_surgery")


def _print_serving(serving: dict) -> None:
    print("== serving summary ==")
    for k in ("submitted", "completed", "device", "degraded", "lost",
              "shed", "timeouts", "retries", "relays",
              "failover_events", "tokens_emitted",
              "peak_concurrent_streams", "queue_depth_peak"):
        print(f"  {k:24s} {serving[k]}")
    for k in ("token_latency_p50_s", "token_latency_p99_s",
              "ttft_p50_s", "ttft_p99_s"):
        v = serving[k]
        print(f"  {k:24s} {v if v is None else f'{v:.3f}'}")
    print(f"  {'slots/server':24s} {serving['slots']} "
          f"({serving['servers_up']} up)")


def _failover_demo(seed: int, device) -> dict:
    """One SplitServer stream killed mid-decode: the caller-side retry
    loop (``generate_with_failover``) relays onto a fallback, and the
    report is folded into a Session's fault accounting through
    ``Session.record_failover``.  Returns the ``serving_failovers``
    entry."""
    from repro_torch.configs import get_config, reduced
    from repro_torch.models import transformer as tfm
    from repro_torch.serving.split import SplitServer

    cfg = reduced(get_config("starcoder2-3b"), layers=2)
    params = tfm.init_lm(cfg, torch.Generator().manual_seed(0), device)
    primary = SplitServer(cfg, params, device=device, name="edge0")
    backup = SplitServer(cfg, params, device=device, name="edge1")
    primary.fail(after_calls=3)

    sess = Session(get_scenario("serve_chaos_k3").replace(
        num_users=32, steps=1, serving=None, faults=None), device=device)
    prompt = torch.as_tensor(
        np.random.default_rng(seed).integers(1, 200, (1, 6)),
        device=device)
    toks, report = primary.generate_with_failover(
        prompt, split=1, max_new=6, fallbacks=[backup])
    sess.record_failover(report)
    fo = sess.metrics().faults["serving_failovers"]
    print(f"[failover-demo] stream survived {fo['events']} failover(s), "
          f"{fo['tokens_preserved']} token(s) preserved, "
          f"relay {fo['relay_s'] * 1e3:.2f} ms "
          f"-> tokens {toks[0].cpu().tolist()}")
    return fo


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--scenario", default="serve_chaos_k3",
                    help="a registered preset with a ServeConfig")
    ap.add_argument("--device", default=None,
                    help="'cuda' (the default) or 'cpu'")
    ap.add_argument("--users", type=int, default=None,
                    help="override the preset's fleet size")
    ap.add_argument("--steps", type=int, default=None,
                    help="override the preset's step count")
    ap.add_argument("--arrival-rate", type=float, default=None,
                    help="override the workload's req/s")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--failover-demo", action="store_true",
                    help="also run the SplitServer mid-stream failover "
                         "path and fold its report into a session")
    args = ap.parse_args(argv)

    sc = get_scenario(args.scenario)
    if sc.serving is None:
        raise SystemExit(f"scenario {sc.name!r} has no ServeConfig; "
                         f"try serve_chaos_k3")
    changes = {}
    if args.users is not None:
        changes["num_users"] = args.users
    if args.steps is not None:
        changes["steps"] = args.steps
    if args.arrival_rate is not None:
        changes["serving"] = dataclasses.replace(
            sc.serving, arrival_rate=args.arrival_rate)
    if changes:
        sc = sc.replace(**changes)

    t0 = time.time()
    sess = Session(sc, device=args.device)
    print(f"== {sc.name} on {sess.device}: {sc.num_users} users, "
          f"{sess.topo.num_servers} servers, "
          f"slots {[p.slots for p in sess.dataplane.pools]} ==")
    for _ in range(sc.steps):
        rep = sess.step()
        s = rep.serving
        print(f"t={rep.t:6.0f}s handoffs={len(rep.events):4d} "
              f"active={s['active']:4d} queued={s['queued']:4d} "
              f"done={s['completed']:5d}/{s['submitted']:5d} "
              f"avail={sess.topo.availability:.2f}")
    m = sess.run(0)    # drains planner + data plane, returns metrics
    wall = time.time() - t0
    _print_serving(m.serving)
    if m.faults and "serving_failovers" in m.faults:
        print(f"  serving_failovers        {m.faults['serving_failovers']}")
    print(f"  wall                     {wall:.1f}s "
          f"(serve {sess.timings['serve_s']:.1f}s)")
    if m.serving["lost"] != 0:
        raise SystemExit(f"data plane lost {m.serving['lost']} request(s)")

    # baseline comparison (paper Figs. 3-5 quantities, planner accounting)
    print("\n== per-strategy mean (delay s, energy J, rent $/round) ==")
    aps = sess.topo.nearest_ap(sess.mobility.positions())
    for name in BASELINES:
        b = sess.policy.run_baseline(name, sess.devices, aps)
        print(f"  {name:13s} T={float(b.T.double().mean()):.4f} "
              f"E={float(b.E.double().mean()):.4f} "
              f"C={float(b.C.double().mean()):.6f}")

    if args.failover_demo:
        _failover_demo(args.seed, sess.device)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
