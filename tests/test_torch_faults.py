"""The fault path and the capacitated event pipeline of the port against
the JAX package.

* ``Session`` on ``capacitated_k3``, ``chaos_singlefail_k3`` and
  ``chaos_churn`` at the presets' own sizes: every FleetState column
  after the plan and after each step, the handoff / relay / resplit
  counts, the admission summary, availability, evacuated, degraded and
  the ``faults`` dict.  Each case also asserts that its path ran:
  spills, and the evacuations, degradations and drains the preset makes
  (at this size ``chaos_singlefail_k3``'s outage finds 8 offloading
  users on server 2 and degrades all of them; ``chaos_churn`` both
  evacuates and degrades, and drains on its budget jitter).
* The planner's fault entry points on small worlds: evacuation into
  ample headroom, every server down, the recovery hold, and a stale
  async replan retried against the updated topology.

Tolerances are ``torch_diff``'s: discrete columns exact outside the users
the reference's own solves and waterfill name as near-ties, continuous
columns within 1e-4 relative on the others; the host counts exactly."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.api import Session as JSession                        # noqa: E402
from repro.api import get_scenario as j_get_scenario             # noqa: E402
from repro.configs import chain_cnns as jcnn                     # noqa: E402
from repro.core import costs as jcosts                           # noqa: E402
from repro.core import faults as jfaults                         # noqa: E402
from repro.core import mobility as jmob                          # noqa: E402
from repro.core import network as jnet                           # noqa: E402
from repro.core.ligd import LiGDConfig as JCfg                   # noqa: E402
from repro.core.planner import MCSAPlanner as JPlanner           # noqa: E402
from repro.core.profile import profile_of as j_profile_of        # noqa: E402
from repro_torch.api import Session as TSession                  # noqa: E402
from repro_torch.api import get_scenario as t_get_scenario       # noqa: E402
from repro_torch.configs import chain_cnns as tcnn               # noqa: E402
from repro_torch.core import costs as tcosts                     # noqa: E402
from repro_torch.core import faults as tfaults                   # noqa: E402
from repro_torch.core import mobility as tmob                    # noqa: E402
from repro_torch.core import network as tnet                     # noqa: E402
from repro_torch.core import planner as tplanner                 # noqa: E402
from repro_torch.core.ligd import LiGDConfig as TCfg             # noqa: E402
from repro_torch.core.profile import profile_of as t_profile_of  # noqa: E402

from torch_diff import (ReferenceTap, assert_admission_agree,    # noqa: E402
                        assert_fleets_agree)


def _evacuation_counts(rep):
    e = rep.evacuation
    return None if e is None else (len(e.users), e.evacuated, e.degraded,
                                   e.reassociated, e.retried, e.drained)


@pytest.mark.parametrize("name", ["capacitated_k3", "chaos_singlefail_k3",
                                  "chaos_churn"])
def test_session_matches_reference(name, monkeypatch):
    js_sc, ts_sc = j_get_scenario(name), t_get_scenario(name)
    assert ts_sc.to_dict() == js_sc.to_dict()
    tap = ReferenceTap(monkeypatch, js_sc.num_users)
    js, ts = JSession(js_sc), TSession(ts_sc, device="cpu")
    assert ts._admission_aware and js._admission_aware
    assert_fleets_agree(ts.fleet, js.fleet, tap.ties, f"{name} plan")
    assert_admission_agree(ts.admission, js.admission, f"{name} plan")
    assert ts.admission["spilled"] > 0, "the budget must force spills"
    M = ts.profile.num_layers
    drained = 0
    for k in range(ts_sc.steps):
        jr, tr = js.step(), ts.step()
        where = f"{name} step {k}"
        drained += 0 if tr.evacuation is None else tr.evacuation.drained
        assert len(tr.events) == len(jr.events), where
        assert (tr.faults is None) == (jr.faults is None), where
        assert _evacuation_counts(tr) == _evacuation_counts(jr), where
        if tr.evacuation is not None:
            np.testing.assert_array_equal(tr.evacuation.users,
                                          jr.evacuation.users)
        assert_fleets_agree(ts.fleet, js.fleet, tap.ties, where)
        assert_admission_agree(ts.admission, js.admission, where)
        np.testing.assert_array_equal(ts.topo.server_available(),
                                      js.topo.server_available())
        up = ts.topo.server_available()
        assert not np.any(~up[ts.fleet.server] & (ts.fleet.split < M)), \
            f"{where}: a user offloads to a down server"
        ledger = ts.policy.ledger
        assert ledger.drift(ts.fleet, M) < 1e-6
    js.drain()
    ts.drain()
    mj, mt = js.metrics(), ts.metrics()
    for f in ("t", "handoffs", "relays", "resplits"):
        np.testing.assert_array_equal(getattr(mt, f), getattr(mj, f), f)
    for f in ("availability", "evacuated", "degraded"):
        a, b = getattr(mt, f), getattr(mj, f)
        assert (a is None) == (b is None), f
        if b is not None:
            np.testing.assert_array_equal(a, b, f)
    assert mt.faults == mj.faults
    assert_admission_agree(mt.admission, mj.admission, f"{name} metrics")
    assert tap.ties.mean() <= 0.01, np.nonzero(tap.ties)[0].tolist()
    assert set(ts.timings) == set(js.timings) == {
        "plan_s", "steps_s", "drain_s", "faults_s", "serve_s", "telemetry_s"}
    # the path this preset exists for really ran
    if name == "chaos_singlefail_k3":
        assert mt.faults["degraded_total"] > 0
        assert mt.faults["reassociated_total"] > 0
        assert mt.faults["recovery_times_s"] == [120.0]
    elif name == "chaos_churn":
        assert mt.faults["evacuated_total"] > 0
        assert mt.faults["degraded_total"] > 0
        assert drained > 0, "the budget jitter must drain users"
        assert mt.availability.min() < 1.0
    else:
        assert mt.faults is None and mt.availability is None


# ---------------------------------------------------------------------------
# The planner's fault entry points on small worlds
# ---------------------------------------------------------------------------
CFG = dict(max_iters=60)


def _pair(X, seed, num_servers=4, num_aps=25, r_capacity=None, **kw):
    jt = jnet.build_topology(num_aps, num_servers, seed=0,
                             r_capacity=r_capacity)
    tt = tnet.build_topology(num_aps, num_servers, seed=0,
                             r_capacity=r_capacity)
    c_dev = np.random.default_rng(seed).uniform(3e9, 8e9, X)
    jp = JPlanner(j_profile_of(jcnn.nin()), jt, JCfg(**CFG), **kw)
    tp = tplanner.MCSAPlanner(t_profile_of(tcnn.nin()), tt, TCfg(**CFG),
                              device="cpu", **kw)
    return (jp, jcosts.DeviceFleet(c_dev=c_dev)), \
        (tp, tcosts.DeviceFleet(c_dev=c_dev))


def _kill(servers, t, up=()):
    def batch(mod):
        return dataclasses.replace(
            mod.FaultBatch.empty(t),
            server_down=np.atleast_1d(np.asarray(servers, np.int64)),
            server_up=np.asarray(up, np.int64))
    return batch(jfaults), batch(tfaults)


def _on_faults(pair, batches, aps=None):
    (jp, jd, jf), (tp, td, tf) = pair
    jb, tb = batches
    jp.topo.apply_faults(jb)
    tp.topo.apply_faults(tb)
    jr = jp.on_faults(jb, jd, jf, user_aps=aps)
    tr = tp.on_faults(tb, td, tf, user_aps=aps)
    assert tp.last_evacuation is tr
    for f in ("t", "evacuated", "degraded", "reassociated", "retried",
              "drained"):
        assert getattr(tr, f) == getattr(jr, f), f
    np.testing.assert_array_equal(tr.users, jr.users)
    return jr, tr


def _planned(X, seed, aps, **kw):
    (jp, jd), (tp, td) = _pair(X, seed, **kw)
    _, _, jf = jp.plan_static(jd, aps)
    _, _, tf = tp.plan_static(td, aps)
    return (jp, jd, jf), (tp, td, tf)


def _busiest(fleet, M):
    offl = fleet.split < M
    return int(np.bincount(fleet.server[offl], minlength=4).argmax())


def test_evacuation_readmits_into_headroom(monkeypatch):
    tap = ReferenceTap(monkeypatch, 64)
    pair = _planned(64, 0, np.arange(64) % 25, r_capacity=1e6,
                    candidates_k=3)
    (jp, _, jf), (tp, _, tf) = pair
    assert_fleets_agree(tf, jf, tap.ties, "plan")
    dead = _busiest(tf, tp.profile.num_layers)
    _, tr = _on_faults(pair, _kill(dead, 30.0))
    assert tr.evacuated > 0 and tr.degraded == 0
    assert tr.admission is not None
    assert_fleets_agree(tf, jf, tap.ties, "after the evacuation")
    assert tap.ties.mean() <= 0.01
    offl = tf.split < tp.profile.num_layers
    assert not np.any(tf.server[offl] == dead)


def test_every_server_down_degrades_everyone(monkeypatch):
    tap = ReferenceTap(monkeypatch, 24)
    pair = _planned(24, 1, np.arange(24) % 16, num_servers=2, num_aps=16,
                    candidates_k=2)
    (_, _, jf), (tp, _, tf) = pair
    was_offl = int((tf.split < tp.profile.num_layers).sum())
    assert was_offl > 0
    _, tr = _on_faults(pair, _kill([0, 1], 30.0))
    assert tr.degraded == was_offl and tr.evacuated == 0
    assert np.all(tf.split == tp.profile.num_layers)
    assert_fleets_agree(tf, jf, tap.ties, "blackout")


def test_recovery_hold_keeps_evacuees_off_the_recovered_server(
        monkeypatch):
    tap = ReferenceTap(monkeypatch, 64)
    pair = _planned(64, 2, np.arange(64) % 25, candidates_k=3,
                    recovery_hold_steps=2)
    (jp, _, jf), (tp, _, tf) = pair
    M = tp.profile.num_layers
    z0 = _busiest(tf, M)
    _on_faults(pair, _kill(z0, 30.0))
    z1 = _busiest(tf, M)
    assert z1 != z0
    _, tr = _on_faults(pair, _kill(z1, 60.0, up=[z0]))
    assert tp._hold[z0] == 2 and len(tr.users) > 0
    moved = tr.users
    assert not np.any(tf.server[moved][tf.split[moved] < M] == z0)
    assert_fleets_agree(tf, jf, tap.ties, "under the hold")
    for t in (90.0, 120.0):
        _on_faults(pair, (jfaults.FaultBatch.empty(t),
                          tfaults.FaultBatch.empty(t)))
    assert tp._hold[z0] == 0
    np.testing.assert_array_equal(tp._hold, jp._hold)


def test_stale_async_replan_is_retried(monkeypatch):
    """A launched replan that decided users onto a server that then dies
    is split: live rows apply, stale rows are re-dispatched through
    ``on_handoffs(..., _attempts=1)`` against the updated topology."""
    X = 48
    tap = ReferenceTap(monkeypatch, X)
    (jp, jd), (tp, td) = _pair(X, 3, candidates_k=3, async_replanning=True)
    jm = jmob.RandomWaypointMobility(jp.topo, X, seed=3,
                                     speed_range=(20.0, 40.0))
    tm = tmob.RandomWaypointMobility(tp.topo, X, seed=3,
                                     speed_range=(20.0, 40.0))
    aps = jp.topo.nearest_ap(jm.positions())
    _, _, jf = jp.plan_static(jd, aps)
    _, _, tf = tp.plan_static(td, aps)
    for t in range(300):
        jb, tb = jm.step(10.0, t * 10.0), tm.step(10.0, t * 10.0)
        assert len(jb) == len(tb)
        if jb:
            break
    jp.on_handoffs(jb, jd, jf)
    tp.on_handoffs(tb, td, tf)
    assert tp.pending and jp.pending
    p = tp._inflight[-1]
    assert torch.is_tensor(p.res.U) and torch.is_tensor(p.new_server)
    final = np.where(p.res.R.numpy().astype(bool), p.orig_servers,
                     p.new_server.numpy())
    dead = int(np.bincount(final, minlength=4).argmax())
    attempts = []
    real = tplanner.MCSAPlanner.on_events

    def spy(self, *a, _attempts=0, **kw):
        attempts.append(_attempts)
        return real(self, *a, _attempts=_attempts, **kw)

    monkeypatch.setattr(tplanner.MCSAPlanner, "on_events", spy)
    _, tr = _on_faults(((jp, jd, jf), (tp, td, tf)), _kill(dead, 999.0),
                       aps=tm.ap)
    assert tr.retried == int((final == dead).sum()) > 0
    assert tp.replan_retries == jp.replan_retries == tr.retried
    assert 1 in attempts
    jp.drain(jf)
    tp.drain(tf)
    assert_fleets_agree(tf, jf, tap.ties, "after the retry")
    up = tp.topo.server_available()
    assert not np.any(~up[tf.server] & (tf.split < tp.profile.num_layers))
