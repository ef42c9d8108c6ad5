"""The port's serving ``Session`` (the closed loop: planner -> data plane
-> telemetry -> planner) against the JAX package's.

* ``serve_chaos_k3`` and ``serve_hotspot_k3`` at the presets' own sizes
  with each package's ``FakeEngine`` injected, and at reduced fleets
  with each package's default (real, reduced starcoder2) engines: every
  step's plan table (``torch_diff``'s tolerances, near-tie users named
  by ``ReferenceTap``), every step's serving sample, and at the end
  ``metrics().serving``, ``.telemetry`` and
  ``.faults["serving_failovers"]``: counts exact, floats within
  ``SERVE_RTOL`` relative.  The two planes see the two planners'
  tables, whose T agree to ~2e-7 relative, so virtual times may differ
  by that much; a deadline test on such a time could flip, and the
  counts are then where it would show.
* Feedback off leaves the planner's pricing static; feedback on hands
  the planner every snapshot.
* The serving presets cross between the packages by ``to_dict``.
* A Session over a transformer's profile (starcoder2-3b, no serving)
  plans the same splits as the reference.
* ``python -m repro_torch.launch.serve --device cpu`` runs to its end.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.api import Session as JSession                        # noqa: E402
from repro.api import get_scenario as j_get_scenario             # noqa: E402
from repro.serving import dataplane as jdp                       # noqa: E402
from repro.testing.fake_engine import FakeEngine as JFake        # noqa: E402
from repro_torch.api import Scenario as TScenario                # noqa: E402
from repro_torch.api import Session as TSession                  # noqa: E402
from repro_torch.api import get_scenario as t_get_scenario       # noqa: E402
from repro_torch.serving import dataplane as tdp                 # noqa: E402
from repro_torch.serving.failover import (FailoverEvent,         # noqa: E402
                                          FailoverReport)
from repro_torch.testing.fake_engine import FakeEngine as TFake  # noqa: E402

from torch_diff import ReferenceTap, assert_fleets_agree         # noqa: E402

#: serving floats across the packages, relative.  Virtual times are sums
#: of per-token times T·scale/max_new, and the two planners' T agree to
#: ~2e-7 relative, so a time t carries up to ~2e-7·t of absolute error;
#: a difference of two such times (a queue delay: pool clock minus
#: ready time, ~240 s each in serve_chaos_k3) keeps that absolute error,
#: which can exceed 1e-6 of the small difference (measured: 8.2e-6 s on
#: a 3.8 s queue delay).  Such values are held to HORIZON_RTOL times the
#: run's virtual horizon instead, absolute.
SERVE_RTOL = 1e-6
HORIZON_RTOL = 2e-7


def assert_close_tree(port, ref, where, atol=0.0):
    """Nested dicts/lists: ints, bools, strings and None exact; floats
    within SERVE_RTOL relative, or ``atol`` absolute."""
    if isinstance(ref, dict):
        assert isinstance(port, dict) and set(port) == set(ref), (
            where, sorted(port), sorted(ref))
        for k in ref:
            assert_close_tree(port[k], ref[k], f"{where}.{k}", atol)
    elif isinstance(ref, (list, tuple)):
        assert len(port) == len(ref), (where, port, ref)
        for i, (a, b) in enumerate(zip(port, ref)):
            assert_close_tree(a, b, f"{where}[{i}]", atol)
    elif isinstance(ref, float) and not isinstance(ref, bool):
        assert isinstance(port, float), (where, port, ref)
        assert abs(port - ref) <= max(SERVE_RTOL * abs(ref), atol), (
            where, port, ref)
    else:
        assert type(port) is type(ref) and port == ref, (where, port, ref)


def _inject_fakes(sess, mod, fake):
    sv = sess.scenario.serving
    sess.dataplane = mod.ServingDataPlane(
        sv, sess.topo, num_layers=sess.profile.num_layers,
        slots=sess._serving_slots(), slots_fn=sess._serving_slots,
        engine_factory=fake)


def _engines_built(plane) -> int:
    return sum(p.engine is not None for p in plane.pools)


@pytest.mark.parametrize("name, engines, cut", [
    ("serve_chaos_k3", "fake", {}),
    ("serve_hotspot_k3", "fake", {}),
    # the kill at t = 30 s lands in step 1 and catches 4 live streams
    ("serve_chaos_k3", "real", {"num_users": 150, "steps": 2}),
    ("serve_hotspot_k3", "real", {"num_users": 64, "steps": 3}),
])
def test_serving_session_matches_reference(name, engines, cut,
                                           monkeypatch):
    js_sc = j_get_scenario(name).replace(**cut)
    ts_sc = t_get_scenario(name).replace(**cut)
    assert ts_sc.to_dict() == js_sc.to_dict()
    tap = ReferenceTap(monkeypatch, js_sc.num_users)
    js, ts = JSession(js_sc), TSession(ts_sc, device="cpu")
    if engines == "fake":
        _inject_fakes(js, jdp, JFake)
        _inject_fakes(ts, tdp, TFake)
    else:
        assert ts.dataplane._factory.device.type == "cpu"
    assert (ts.estimator is None) == (js.estimator is None)
    assert [p.slots for p in ts.dataplane.pools] == \
        [p.slots for p in js.dataplane.pools]
    for k in range(ts_sc.steps):
        jr, tr = js.step(), ts.step()
        where = f"{name} {engines} step {k}"
        assert_fleets_agree(ts.fleet, js.fleet, tap.ties, where)
        assert_close_tree(tr.serving, jr.serving, where)
    mj, mt = js.run(0), ts.run(0)
    tied = np.nonzero(tap.ties)[0]
    moved = tied[(ts.fleet.server[tied] != js.fleet.server[tied])
                 | (ts.fleet.split[tied] != js.fleet.split[tied])]
    # near-tie users, and those whose server or split differ at the end,
    # named; at most torch_diff's 1 % may be placed apart
    print(f"{name} {engines}: near-tie users {tied.tolist()}, of which "
          f"placed apart {moved.tolist()}")
    assert len(moved) <= 0.01 * js_sc.num_users, moved.tolist()
    atol = HORIZON_RTOL * mj.serving["virtual_time_s"]
    assert_close_tree(mt.serving, mj.serving, f"{name} serving", atol)
    assert_close_tree(mt.telemetry, mj.telemetry, f"{name} telemetry",
                      atol)
    assert_close_tree((mt.faults or {}).get("serving_failovers"),
                      (mj.faults or {}).get("serving_failovers"),
                      f"{name} serving_failovers")
    s = mt.serving
    assert s["lost"] == 0
    assert s["submitted"] == s["completed"] + s["device"] + s["degraded"]
    assert s["tokens_emitted"] > 0
    assert _engines_built(ts.dataplane) == _engines_built(js.dataplane)
    assert set(ts.timings) == {"plan_s", "steps_s", "drain_s", "faults_s",
                               "serve_s", "telemetry_s"}
    assert ts.timings["serve_s"] > 0
    if name == "serve_chaos_k3":
        assert s["failover_events"] > 0
        assert mt.faults["serving_failovers"]["events"] == \
            s["failover_events"]
        assert s["shed"] > 0
    else:
        assert mt.telemetry["updates"] == ts_sc.steps
        assert ts.timings["telemetry_s"] > 0


@pytest.mark.parametrize("feedback", [False, True])
def test_feedback_switch_and_planner_pricing(feedback):
    """Feedback off: no estimator, no telemetry trace, and the planner
    prices against its static edge table from the first step to the
    drain (the collector still records).  Feedback on: an estimator
    update every step, each snapshot handed to the planner."""
    sc = t_get_scenario("serve_hotspot_k3").replace(num_users=48, steps=3)
    sc = sc.replace(serving=dataclasses.replace(sc.serving,
                                                feedback=feedback))
    sess = TSession(sc, device="cpu")
    _inject_fakes(sess, tdp, TFake)
    static = sess.policy._edge_table
    seen = []
    if feedback:
        upd = sess.policy.update_load

        def spy(snap):
            seen.append(snap)
            return upd(snap)

        sess.policy.update_load = spy
    for _ in range(sc.steps):
        sess.step()
        if not feedback:
            assert sess.policy._edge_table_eff is static
    m = sess.run(0)
    if not feedback:
        assert sess.estimator is None and m.telemetry is None
        assert sess.policy.load is None
        assert sess.policy._edge_table_eff is static
    else:
        assert len(seen) == sc.steps == m.telemetry["updates"]
        assert seen[-1] is sess.load_snapshot
        assert m.telemetry["last"] == sess.load_snapshot.to_dict()
    assert sum(m.serving["per_server"]["admitted"]) > 0


def test_serving_presets_cross_packages():
    for name in ("serve_chaos_k3", "serve_hotspot_k3"):
        t_sc, j_sc = t_get_scenario(name), j_get_scenario(name)
        assert t_sc.to_dict() == j_sc.to_dict()
        assert isinstance(t_sc.serving, tdp.ServeConfig)
        back = TScenario.from_dict(j_sc.to_dict())
        assert back == t_sc and isinstance(back.serving, tdp.ServeConfig)
    assert t_get_scenario("serve_hotspot_k3").serving.feedback
    assert not t_get_scenario("serve_chaos_k3").serving.feedback


def test_transformer_session_matches_reference(monkeypatch):
    """A Session over starcoder2-3b's prefill profile (30 blocks, 31
    split points, no serving) plans and replans the same splits as the
    reference."""
    changes = dict(model="starcoder2-3b", num_users=48, steps=3)
    js_sc = j_get_scenario("paper_fig1").replace(**changes)
    ts_sc = t_get_scenario("paper_fig1").replace(**changes)
    assert ts_sc.to_dict() == js_sc.to_dict()
    tap = ReferenceTap(monkeypatch, js_sc.num_users)
    js, ts = JSession(js_sc), TSession(ts_sc, device="cpu")
    assert ts.profile.num_layers == js.profile.num_layers == 30
    np.testing.assert_array_equal(ts.profile.flops, js.profile.flops)
    np.testing.assert_array_equal(ts.profile.out_bits, js.profile.out_bits)
    assert ts.profile.name == js.profile.name
    assert_fleets_agree(ts.fleet, js.fleet, tap.ties, "starcoder2 plan")
    for k in range(ts_sc.steps):
        js.step()
        ts.step()
        assert_fleets_agree(ts.fleet, js.fleet, tap.ties,
                            f"starcoder2 step {k}")
    # a transformer's blocks are alike, so the reference names many
    # users' two best splits near-ties; none is placed apart
    for f in ("server", "split", "R"):
        np.testing.assert_array_equal(getattr(ts.fleet, f),
                                      getattr(js.fleet, f), f)
    assert ts.dataplane is None and ts.metrics().serving is None


def test_session_takes_an_injected_dataplane():
    """``dataplane=`` overrides the scenario's: a serving-free scenario
    driven through a prebuilt FakeEngine plane, drained by run()."""
    sc = t_get_scenario("serve_chaos_k3").replace(
        num_users=24, steps=2, serving=None, faults=None)
    topo = sc.build_topology()
    plane = tdp.ServingDataPlane(
        tdp.ServeConfig(arrival_rate=2.0, arrival_seed=3, max_requests=6,
                        prompt_len=4, max_new=4, cache_len=16,
                        token_time_scale=4.0),
        topo, num_layers=sc.build_profile().num_layers,
        slots=np.full(topo.num_servers, 2), engine_factory=TFake)
    sess = TSession(sc, device="cpu", topo=topo, dataplane=plane)
    assert sess.dataplane is plane and sess.estimator is None
    rep = sess.step()
    assert rep.serving is not None and "active" in rep.serving
    m = sess.run()
    assert m.serving["submitted"] == 6 and m.serving["lost"] == 0


def test_record_failover_surfaces_into_metrics():
    sess = TSession(t_get_scenario("serve_chaos_k3").replace(
        num_users=24, steps=1, serving=None, faults=None), device="cpu")
    assert sess.step().serving is None
    assert sess.metrics().faults is None
    sess.record_failover(FailoverReport(events=[
        FailoverEvent(lost="edge0", tokens_done=3, relay_s=0.5,
                      relay_bits=4096.0)]))
    m = sess.metrics()
    fo = m.faults["serving_failovers"]
    assert fo["events"] == 1 and fo["tokens_preserved"] == 3
    assert fo["relay_s"] == 0.5
    assert fo["by_mode"] == {"reprefill": 1, "migrate": 0}
    assert m.serving is None and m.telemetry is None


def test_launch_serve_runs_on_cpu(capsys):
    from repro_torch.launch import serve
    assert serve.main(["--device", "cpu", "--failover-demo"]) == 0
    out = capsys.readouterr().out
    assert "== serve_chaos_k3 on cpu:" in out
    assert "lost                     0" in out
    for name in serve.BASELINES:
        assert name in out
    assert "[failover-demo] stream survived 1 failover(s)" in out
