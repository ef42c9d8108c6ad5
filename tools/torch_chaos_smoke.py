#!/usr/bin/env python
"""Chaos smoke on the PyTorch port (``repro_torch.api``), the twin of
tools/chaos_smoke.py: run a ``chaos_*`` preset end-to-end and assert the
fault-injection invariants hold (docs/ARCHITECTURE.md, "Failure
handling"):

* faults actually fired (availability dipped below 1.0);
* after EVERY step, zero users offload to a down server — affected
  users were evacuated to survivors or degraded to device-only within
  the step that killed their server;
* for purely-scripted scenarios whose schedule recovers everything it
  kills, availability is back to 1.0 at the end and every outage has a
  recorded time-to-recover.

The session runs on ``--device`` (default ``cuda``: the card, and no
fallback without one); ``--device cpu`` takes the plain PyTorch path and
prints what tools/chaos_smoke.py prints.

Run:  PYTHONPATH=src python tools/torch_chaos_smoke.py [--scenario NAME]
      PYTHONPATH=src python tools/torch_chaos_smoke.py --device cpu
"""
from __future__ import annotations

import argparse

from repro_torch.api import Session, get_scenario


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--scenario", default="chaos_singlefail_k3",
                    help="a registered chaos preset (default: "
                         "chaos_singlefail_k3)")
    ap.add_argument("--steps", type=int, default=None,
                    help="override the scenario's step count")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default: the card) or cpu")
    args = ap.parse_args(argv)

    sc = get_scenario(args.scenario)
    if sc.faults is None:
        raise SystemExit(f"scenario {sc.name!r} has no FaultConfig — "
                         f"nothing to smoke")
    session = Session(sc, device=args.device)
    n = args.steps if args.steps is not None else sc.steps

    min_avail = 1.0
    for i in range(n):
        rep = session.step()
        avail = session.topo.availability
        min_avail = min(min_avail, avail)
        up = session.topo.server_available()
        offl = session.fleet.split < session.profile.num_layers
        stranded = int(((~up[session.fleet.server]) & offl).sum())
        evac = rep.evacuation
        print(f"step {i:2d}  t={rep.t:6.0f}s  avail={avail:4.2f}  "
              f"handoffs={len(rep.events):4d}  "
              f"evacuated={0 if evac is None else evac.evacuated:4d}  "
              f"degraded={0 if evac is None else evac.degraded:4d}  "
              f"stranded={stranded}")
        assert stranded == 0, \
            f"{stranded} users left offloading to a down server"
    session.drain()
    m = session.metrics()

    assert min_avail < 1.0, \
        f"{sc.name!r} injected no faults in {n} steps"
    assert m.faults is not None and m.faults["availability_min"] == \
        min_avail

    # a purely-scripted schedule that recovers everything it kills must
    # end fully available, with one time-to-recover sample per outage
    stochastic = (sc.faults.server_mtbf is not None
                  or sc.faults.link_mtbf is not None)
    downs = sum(ev[0] == "server_down" for ev in sc.faults.schedule)
    ups = sum(ev[0] == "server_up" for ev in sc.faults.schedule)
    if not stochastic and downs and downs == ups:
        assert session.topo.availability == 1.0, \
            "scripted recovery did not restore availability"
        assert len(m.faults["recovery_times_s"]) == downs
        assert not m.faults["still_down"]

    print("CHAOS_SMOKE_OK", {k: v for k, v in m.faults.items()
                             if k != "recovery_times_s"})
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
