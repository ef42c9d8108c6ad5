"""Mobility simulation on the PyTorch port, the twin of
examples/mobility_sim.py: a fleet of users streaming inference requests
while driving through the AP grid — live MLi-GD decisions + running
per-strategy cost accounting (the paper's Figs. 9-14 scenario, animated
as text).

Everything rides the ``repro_torch.api`` surface: the world is the
``paper_fig1`` Scenario preset (CLI flags override its fields) and the
whole mobility → handoff → replan loop is owned by ``Session`` — this
file only prints what each step reports.  The loop is array-resident
end-to-end, so ``--users 100000`` is a flag away (each minute costs one
padded MLi-GD solve over that minute's handoffs, not a Python loop over
vehicles).

Control-plane extras (docs/ARCHITECTURE.md):
  --candidates K        admit each vehicle to the best of its K nearest
                        servers (water-filling under budgets)
  --server-capacity R   per-server compute budget (units) — forces
                        spills/rejections when tight
  --async-replanning    overlap each minute's MLi-GD solve with the next
                        mobility step (decisions land one minute late)

The session runs on ``--device`` (default ``cuda``: the card, and no
fallback without one); ``--device cpu`` takes the plain PyTorch path and
prints what examples/mobility_sim.py prints.

Run:  PYTHONPATH=src python examples/torch_mobility_sim.py [--minutes 30]
      PYTHONPATH=src python examples/torch_mobility_sim.py --users 100000
      PYTHONPATH=src python examples/torch_mobility_sim.py --device cpu \\
          --candidates 3 --server-capacity 200 --async-replanning
"""
import argparse

import numpy as np

from repro_torch.api import Session, get_scenario

MAX_EVENT_PRINTS = 8


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--minutes", type=int, default=30)
    ap.add_argument("--users", type=int, default=10)
    ap.add_argument("--candidates", type=int, default=1,
                    help="candidate servers per vehicle (K)")
    ap.add_argument("--server-capacity", type=float, default=None,
                    help="per-server compute budget in units "
                         "(default: uncapacitated)")
    ap.add_argument("--async-replanning", action="store_true",
                    help="overlap handoff solves with the next step")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default: the card) or cpu")
    args = ap.parse_args(argv)

    scenario = get_scenario("paper_fig1").replace(
        steps=args.minutes, num_users=args.users,
        candidates_k=args.candidates, r_capacity=args.server_capacity,
        async_replanning=args.async_replanning)
    sess = Session(scenario, device=args.device)
    print(f"{args.users} vehicles, {sess.topo.num_aps} APs, "
          f"{sess.topo.num_servers} edge servers; YOLOv2 inference stream")
    if sess.admission is not None:
        rep = sess.admission
        print(f"admission: K={args.candidates}, "
              f"users/server {rep['users_per_server']}, "
              f"{rep['spilled']} spilled, {rep['rejected']} device-only"
              + (f", r-load {np.round(rep['r_load'], 1).tolist()}"
                 f" / budget {args.server_capacity}"
                 if args.server_capacity else ""))

    fleet = sess.fleet
    for minute in range(args.minutes):
        rep = sess.step()
        if rep.in_flight:
            # the solve overlaps the next minute's mobility — decisions
            # land at the next event-bearing step (or the final drain)
            if rep.events:
                print(f"  [{minute:3d} min] {len(rep.events)} handoffs "
                      f"(solve in flight)")
            continue
        if rep.result is None:
            continue
        R = np.asarray(rep.result.R)
        for i, ev in enumerate(rep.events):
            if i >= MAX_EVENT_PRINTS:
                print(f"  [{minute:3d} min] ... "
                      f"{len(rep.events) - MAX_EVENT_PRINTS} more handoffs")
                break
            print(f"  [{minute:3d} min] vehicle {ev.user}: server "
                  f"{ev.old_server}->{ev.new_server} "
                  f"{'relay-back' if R[i] else 're-split'} "
                  f"(split={int(fleet.split[ev.user])}, "
                  f"T={fleet.T[ev.user] * 1e3:.1f} ms)")

    sess.drain()
    m = sess.metrics()
    if args.async_replanning:
        relays = int((fleet.R == 1).sum())
        print(f"\n{args.minutes} min simulated (async): "
              f"{relays} vehicles ended on a relay-back plan")
    else:
        print(f"\n{args.minutes} min simulated: "
              f"{int(m.resplits.sum())} re-splits, "
              f"{int(m.relays.sum())} relay-backs")
    print(f"fleet mean latency: {np.mean(m.mean_T) * 1e3:.1f} ms "
          f"(worst minute {np.max(m.mean_T) * 1e3:.1f} ms)")


if __name__ == "__main__":
    main()
