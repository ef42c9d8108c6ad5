"""Admission control in the port against the JAX package: the
water-filling greedy bit for bit on random inputs (ties, ``inf``
utilities, zero demands), the candidate-set static plan on
``capacitated_k3`` (500 users x K 3) and on faulted topologies, and the
ledger-aware admission of a dirty step after a synthetic load snapshot,
which reprices T against the physical edge table.

Tolerances are ``torch_diff``'s: admission choices and discrete columns
exact outside the users the reference's own solves and waterfill name
as near-ties, continuous columns within 1e-4 relative on the others."""
import dataclasses
from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.api import get_scenario as j_get_scenario             # noqa: E402
from repro.core import admission as jadm                         # noqa: E402
from repro.core import events as jev                             # noqa: E402
from repro.core import faults as jfaults                         # noqa: E402
from repro.core.planner import MCSAPlanner as JPlanner           # noqa: E402
from repro_torch.api import get_scenario as t_get_scenario       # noqa: E402
from repro_torch.core import admission as tadm                   # noqa: E402
from repro_torch.core import events as tev                       # noqa: E402
from repro_torch.core import faults as tfaults                   # noqa: E402
from repro_torch.core import planner as tplanner                 # noqa: E402

from torch_diff import (ReferenceTap, assert_discrete,           # noqa: E402
                        assert_fleets_agree, assert_rel)

REPORT_EXACT = ("candidates", "U", "choice", "server", "rejected", "spills",
                "r_load", "B_load", "users_per_server")


# ---------------------------------------------------------------------------
# admit_waterfill, bit for bit
# ---------------------------------------------------------------------------
def _waterfill_case(seed: int):
    """Random (X, K) proposals with exact U ties, ``inf`` utilities, zero
    demands, duplicate candidates and saturating budgets."""
    rng = np.random.default_rng(seed)
    X, K, Z = 300, 3, 5
    cand = np.stack([rng.permutation(Z)[:K] for _ in range(X)])
    cand[::17, 1] = cand[::17, 0]                     # duplicate proposals
    U = rng.choice(rng.uniform(1.0, 2.0, 40), (X, K))   # many exact ties
    U[::11, 2] = np.inf
    U[::29] = np.inf                                  # whole rows priced out
    r = rng.uniform(0.5, 4.0, (X, K))
    B = rng.uniform(1e6, 8e6, (X, K))
    r[::5] = 0.0                                      # device-only optima
    B[::7, 0] = 0.0
    caps = [(None, None), (np.full(Z, 60.0), None),
            (np.full(Z, 60.0), np.full(Z, 2e8)),
            (rng.uniform(0.0, 80.0, Z), rng.uniform(5e7, 3e8, Z))]
    return cand, U, r, B, Z, caps[seed % len(caps)]


@pytest.mark.parametrize("seed", range(8))
def test_admit_waterfill_bit_for_bit(seed):
    cand, U, r, B, Z, (r_cap, B_cap) = _waterfill_case(seed)
    jr = jadm.admit_waterfill(cand, U, r, B, Z, r_cap, B_cap)
    tr = tadm.admit_waterfill(cand, U, r, B, Z, r_cap, B_cap)
    for f in REPORT_EXACT:
        np.testing.assert_array_equal(getattr(tr, f), getattr(jr, f), f)
    if r_cap is not None:
        assert jr.rejected.any() and (jr.spills > 0).any()
    np.testing.assert_array_equal(
        tadm._segmented_running_sum(np.arange(20) % 6 == 0,
                                    np.arange(20.0)),
        jadm._segmented_running_sum(np.arange(20) % 6 == 0,
                                    np.arange(20.0)))


# ---------------------------------------------------------------------------
# The candidate-set static plan
# ---------------------------------------------------------------------------
def _worlds(name: str, **changes):
    js, ts = j_get_scenario(name), t_get_scenario(name)
    if changes:
        js, ts = js.replace(**changes), ts.replace(**changes)
    jt, tt = js.build_topology(), ts.build_topology()
    jm, tm = js.build_mobility(jt), ts.build_mobility(tt)
    aps = jt.nearest_ap(jm.positions())
    np.testing.assert_array_equal(tt.nearest_ap(tm.positions()), aps)
    jplan = JPlanner(js.build_profile(), jt, js.ligd,
                     candidates_k=js.candidates_k)
    tplan = tplanner.MCSAPlanner(ts.build_profile(), tt, ts.ligd,
                                 candidates_k=ts.candidates_k, device="cpu")
    return (jplan, js.build_devices(), jm), (tplan, ts.build_devices(), tm), \
        aps


def _assert_reports_agree(tr, jr, ties, where):
    for f in ("choice", "server", "rejected", "spills"):
        assert_discrete(getattr(tr, f), getattr(jr, f), ties,
                        f"{where} admission {f}")
    np.testing.assert_array_equal(tr.candidates, jr.candidates)
    assert_rel(tr.U, jr.U, f"{where} admission U", rows=~ties)
    if not ties.any():
        np.testing.assert_array_equal(tr.users_per_server,
                                      jr.users_per_server)
        for f in ("r_load", "B_load"):
            assert_rel(getattr(tr, f), getattr(jr, f), f"{where} {f}")


def test_plan_static_capacitated_k3(monkeypatch):
    """500 users x K 3 under a 200-unit budget a server: one Li-GD
    launch over 1500 user-major rows, then the waterfill."""
    (jplan, jdev, _), (tplan, tdev, _), aps = _worlds("capacitated_k3")
    tap = ReferenceTap(monkeypatch, len(aps))
    jres, jsrv, jfleet = jplan.plan_static(jdev, aps)
    launches = []
    real = tplanner.solve_ligd_batch
    monkeypatch.setattr(tplanner, "solve_ligd_batch", lambda *a, **k: (
        launches.append(a[1]["c_dev"].shape[0]), real(*a, **k))[1])
    tres, tsrv, tfleet = tplan.plan_static(tdev, aps)
    assert launches == [len(aps) * 3]
    assert tap.solves == 1 and tap.admissions == 1
    assert tap.ties.mean() <= 0.01, np.nonzero(tap.ties)[0].tolist()
    jr, tr = jplan.last_admission, tplan.last_admission
    assert (jr.spills > 0).sum() > 0, "the budget must force spills"
    _assert_reports_agree(tr, jr, tap.ties, "capacitated_k3")
    assert_discrete(tsrv, jsrv, tap.ties, "servers")
    assert_fleets_agree(tfleet, jfleet, tap.ties, "capacitated_k3 plan")
    assert tplan.t_ag_estimate == pytest.approx(jplan.t_ag_estimate,
                                                rel=1e-3)
    assert_rel(tplan.ledger.r_used, jplan.ledger.r_used, "ledger r",
               rtol=1e-4)
    assert np.all(tplan.ledger.r_used
                  <= np.asarray(tplan.topo.r_capacity) + 1e-9)
    # device-only rows hold nothing
    dev_only = tfleet.split == tplan.profile.num_layers
    assert np.all(tfleet.r[dev_only] == 0) and np.all(tfleet.B[dev_only] == 0)
    assert tplan._last_user_aps is not None


def _kill(servers, t):
    def batch(mod):
        return dataclasses.replace(
            mod.FaultBatch.empty(t),
            server_down=np.atleast_1d(np.asarray(servers, np.int64)))
    return batch(jfaults), batch(tfaults)


@pytest.mark.parametrize("dead", [[2], [0, 1, 3]])
def test_plan_static_on_a_faulted_topology(dead, monkeypatch):
    """Down candidates are masked (their slots duplicate the first valid
    one); with three of four servers down and K = 2 some APs have no
    valid candidate and their users plan device-only."""
    (jplan, jdev, _), (tplan, tdev, _), aps = _worlds(
        "chaos_singlefail_k3", num_users=300, r_capacity=120.0,
        candidates_k=2)
    jb, tb = _kill(dead, 0.0)
    jplan.topo.apply_faults(jb)
    tplan.topo.apply_faults(tb)
    tap = ReferenceTap(monkeypatch, len(aps))
    _, _, jfleet = jplan.plan_static(jdev, aps)
    _, _, tfleet = tplan.plan_static(tdev, aps)
    _assert_reports_agree(tplan.last_admission, jplan.last_admission,
                          tap.ties, f"dead {dead}")
    assert_fleets_agree(tfleet, jfleet, tap.ties, f"dead {dead}")
    assert tap.ties.mean() <= 0.01
    up = tplan.topo.server_available()
    offl = tfleet.split < tplan.profile.num_layers
    assert not np.any(~up[tfleet.server]), "an association on a dead server"
    assert offl.any()
    if len(dead) == 3:
        assert tplan.last_admission.rejected.any()


# ---------------------------------------------------------------------------
# _admit_dirty after a load snapshot (reaches _reprice_T_physical)
# ---------------------------------------------------------------------------
def test_admit_dirty_after_load_snapshot(monkeypatch):
    (jplan, jdev, jm), (tplan, tdev, tm), aps = _worlds(
        "capacitated_k3", num_users=300, r_capacity=120.0)
    tap = ReferenceTap(monkeypatch, len(aps))
    _, _, jfleet = jplan.plan_static(jdev, aps)
    _, _, tfleet = tplan.plan_static(tdev, aps)
    assert_fleets_agree(tfleet, jfleet, tap.ties, "plan")

    # a congested server 0 and a slow backhaul at server 1
    snap = SimpleNamespace(compute_mult=np.array([3.0, 1.0, 1.5, 1.0]),
                           backhaul_mult=np.array([1.0, 2.5, 1.0, 1.0]))
    jplan.update_load(snap)
    tplan.update_load(snap)
    assert tplan.load is snap
    repriced = []
    real = tplanner.MCSAPlanner._reprice_T_physical

    def spy(self, res_sel, *a, **kw):
        out = real(self, res_sel, *a, **kw)
        repriced.append((res_sel, a, out))
        return out

    monkeypatch.setattr(tplanner.MCSAPlanner, "_reprice_T_physical", spy)
    jb, tb = jm.step(30.0, 0.0), tm.step(30.0, 0.0)
    assert len(tb) == len(jb) > 0
    jo = jplan.on_events(jev.StepEvents(t=0.0, handoffs=jb), jdev, jfleet)
    to = tplan.on_events(tev.StepEvents(t=0.0, handoffs=tb), tdev, tfleet)
    assert len(repriced) == 1
    assert (to.relays, to.resplits, to.stays) == \
        (jo.relays, jo.resplits, jo.stays)
    assert_fleets_agree(tfleet, jfleet, tap.ties, "after the snapshot")
    assert tap.ties.mean() <= 0.01
    # the repricing itself is host numpy: the same inputs give the
    # reference's T bit for bit
    res_sel, args, out = repriced[0]
    ref = jplan._reprice_T_physical(res_sel, jdev, *args[1:])
    np.testing.assert_array_equal(out.T, ref.T)
    # the repricing moved T off the congested price on offloaded rows
    offl = out.split < tplan.profile.num_layers
    assert offl.any() and np.any(out.T[offl] != res_sel.T[offl])
    # the waterfill saw residuals shrunk by the multipliers, and the
    # ledger's books still balance
    assert tplan.ledger.drift(tfleet, tplan.profile.num_layers) < 1e-6
    assert_rel(tplan.ledger.r_used, jplan.ledger.r_used, "ledger r")
