"""Quickstart on the PyTorch port, the twin of examples/quickstart.py: the
paper's MCSA pipeline end-to-end through the ``repro_torch.api`` front
door.

  1. declare the world as a Scenario (16 APs, 4 edge servers, VGG16
     profile, 6 users) — no hand-wiring of topology/profile/mobility;
  2. Session + the default MCSA policy run Li-GD: jointly pick each
     user's split point s, bandwidth B and edge-compute units r (paper
     Algorithm 1);
  3. swap in the baseline policies (Device-Only / Edge-Only /
     greedy-nearest Neurosurgeon / DNN-Surgery / Cloud) on the IDENTICAL
     world — one line each;
  4. step the session; on an edge-server handoff the policy runs MLi-GD
     (Algorithm 2): re-split against the new server vs relay traffic back.

Every session runs on ``--device`` (default ``cuda``: the card, and no
fallback without one); ``--device cpu`` takes the plain PyTorch path and
prints what examples/quickstart.py prints.

Run:  PYTHONPATH=src python examples/torch_quickstart.py [--device cpu]
"""
import argparse

import numpy as np

from repro_torch.api import Scenario, Session
from repro_torch.core.ligd import LiGDConfig

# 1. the world, declaratively (serializable: print(scenario.to_dict()))
scenario = Scenario(
    name="quickstart", num_aps=16, num_servers=4, topo_seed=0,
    model="vgg16", num_users=6, device_seed=0,
    speed_range=(5.0, 25.0), mobility_seed=1,
    ligd=LiGDConfig(max_iters=300), steps=360, dt=10.0)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="cuda (default: the card) or cpu")
    device = ap.parse_args(argv).device

    # 2. Session builds topology/profile/fleet and plans with MCSA
    sess = Session(scenario, device=device)
    topo, profile = sess.topo, sess.profile
    print(f"topology: {topo.num_aps} APs, {topo.num_servers} servers, "
          f"max hops {int(topo.hops.min(1).max())}")
    print(f"model: {profile.name}, {profile.num_layers} layers, "
          f"{profile.flops.sum() / 1e9:.2f} GFLOPs")

    print("\n== Li-GD plan (per user) ==")
    for i, p in enumerate(sess.fleet):
        print(f"  user{i}: server {p.server}  split s={p.split:2d}  "
              f"B={p.B / 1e6:5.2f} MHz  r={p.r:4.1f}  "
              f"T={p.T * 1e3:6.1f} ms  E={p.E * 1e3:6.1f} mJ")

    # 3. policy swap: the IDENTICAL world (topology/profile/devices
    #    injected from the mcsa session, positions re-seeded) planned by
    #    each baseline
    print("\n== baselines (mean over users, identical world) ==")
    for name in ("device_only", "edge_only", "greedy_nearest",
                 "dnn_surgery", "cloud"):
        b = Session(scenario, policy=name, topo=topo, profile=profile,
                    devices=sess.devices, device=device).fleet
        print(f"  {name:14s} T={float(np.mean(b.T)) * 1e3:7.1f} ms  "
              f"E={float(np.mean(b.E)) * 1e3:6.1f} mJ  "
              f"C=${float(np.mean(b.C)):.6f}/round")
    print(f"  {'mcsa':14s} T={float(np.mean(sess.fleet.T)) * 1e3:7.1f} ms  "
          f"E={float(np.mean(sess.fleet.E)) * 1e3:6.1f} mJ  "
          f"C=${float(np.mean(sess.fleet.C)):.6f}/round")

    # 4. mobility: step the session until somebody changes servers
    print("\n== mobility (MLi-GD handoff decisions) ==")
    report = sess.step()
    while not report.events and sess.steps_taken < scenario.steps:
        report = sess.step()
    for ev in report.events:
        p = sess.fleet[ev.user]
        action = "relay-back" if p.R else "re-split"
        print(f"  t={ev.t:5.0f}s user{ev.user}: server "
              f"{ev.old_server}->{ev.new_server}  decision={action}  "
              f"split={p.split}  T={p.T * 1e3:.1f} ms")
    print("\ndone.")


if __name__ == "__main__":
    main()
