#!/usr/bin/env python
"""Policy-matrix smoke on the PyTorch port, the twin of
tools/policy_matrix.py: run every registered policy against every
Scenario preset (optionally scale-capped) through the one
:class:`repro_torch.api.Session` lifecycle and print the comparison table
the apples-to-apples design exists for.

Beyond "every cell runs", the matrix asserts the cross-cutting
invariants no single-policy test covers:

* every (scenario, policy) cell produces finite, positive fleet-mean
  delay — no NaN/inf escapes any solver or baseline path;
* chaos scenarios leave ZERO users offloading to a down server under
  EVERY policy — including baselines with no fault hook, which rely on
  Session's synthesized evacuation handoffs;
* per scenario, the MCSA planner's mean delay is never worse than the
  worst baseline (it optimizes utility, so delay alone need not win
  every cell — but losing to the whole field would mean the control
  plane is broken).

Every session runs on ``--device`` (default ``cuda``: the card, and no
fallback without one); ``--device cpu`` takes the plain PyTorch path and
prints what tools/policy_matrix.py prints.

Run:  PYTHONPATH=src python tools/torch_policy_matrix.py
      PYTHONPATH=src python tools/torch_policy_matrix.py --device cpu \\
          --max-users 64 --steps 4          # CI smoke scale
"""
from __future__ import annotations

import argparse
import json
import math
import time

from repro_torch.api import (Session, get_scenario, list_policies,
                             list_scenarios)


def run_cell(scenario, policy: str, device: str = "cuda") -> dict:
    """One (scenario, policy) cell: run the full schedule on ``device``,
    return a summary row."""
    session = Session(scenario, policy=policy, device=device)
    t0 = time.perf_counter()
    m = session.run()
    wall = time.perf_counter() - t0

    offl = session.fleet.split < session.profile.num_layers
    stranded = 0
    if scenario.faults is not None:
        up = session.topo.server_available()
        stranded = int(((~up[session.fleet.server]) & offl).sum())

    return {
        "mean_T": float(m.mean_T.mean()),
        "final_T": float(m.mean_T[-1]),
        "mean_C": float(m.mean_C.mean()),
        "handoffs": int(m.handoffs.sum()),
        "evacuated": (int(m.evacuated.sum())
                      if m.evacuated is not None else 0),
        "offloading": int(offl.sum()),
        "stranded": stranded,
        "wall_s": wall,
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--scenarios", default=None,
                    help="comma-separated preset names "
                         "(default: every registered preset)")
    ap.add_argument("--policies", default=None,
                    help="comma-separated policy names "
                         "(default: every registered policy)")
    ap.add_argument("--max-users", type=int, default=None,
                    help="cap each scenario's fleet size (CI smoke)")
    ap.add_argument("--steps", type=int, default=None,
                    help="cap each scenario's step count (CI smoke)")
    ap.add_argument("--json", default=None,
                    help="also dump the matrix to this JSON path")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default: the card) or cpu")
    args = ap.parse_args(argv)

    scenarios = (args.scenarios.split(",") if args.scenarios
                 else list(list_scenarios()))
    policies = (args.policies.split(",") if args.policies
                else list(list_policies()))

    matrix: dict[str, dict[str, dict]] = {}
    for sname in scenarios:
        sc = get_scenario(sname)
        # the matrix compares PLANNING policies; the serving data plane
        # is covered by its own smoke/bench (tools/serve_smoke.py)
        changes = {} if sc.serving is None else {"serving": None}
        if args.max_users is not None and sc.num_users > args.max_users:
            changes["num_users"] = args.max_users
        if args.steps is not None and sc.steps > args.steps:
            changes["steps"] = args.steps
        if changes:
            sc = sc.replace(**changes)
        matrix[sname] = {}
        for pname in policies:
            cell = run_cell(sc, pname, args.device)
            matrix[sname][pname] = cell
            assert math.isfinite(cell["mean_T"]) and cell["mean_T"] > 0, \
                f"{sname}/{pname}: non-finite mean delay {cell['mean_T']}"
            assert cell["stranded"] == 0, \
                (f"{sname}/{pname}: {cell['stranded']} users left "
                 f"offloading to a down server")

        if "mcsa" in matrix[sname] and len(matrix[sname]) > 1:
            worst = max(c["mean_T"] for p, c in matrix[sname].items()
                        if p != "mcsa")
            assert matrix[sname]["mcsa"]["mean_T"] <= worst * (1 + 1e-6), \
                (f"{sname}: MCSA mean delay "
                 f"{matrix[sname]['mcsa']['mean_T']:.4f}s is worse than "
                 f"every baseline (worst {worst:.4f}s)")

    # -- render ---------------------------------------------------------
    width = max(len(p) for p in policies) + 2
    head = "mean_T (s)".ljust(22) + "".join(p.rjust(width)
                                            for p in policies)
    print(head)
    print("-" * len(head))
    for sname in scenarios:
        row = sname.ljust(22)
        for pname in policies:
            row += f"{matrix[sname][pname]['mean_T']:.4f}".rjust(width)
        print(row)

    if args.json:
        with open(args.json, "w") as f:
            json.dump(matrix, f, indent=2, sort_keys=True)
        print(f"\nwrote {args.json}")

    print("\nPOLICY_MATRIX_OK "
          f"({len(scenarios)} scenarios x {len(policies)} policies)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
