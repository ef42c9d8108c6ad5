"""The port's control plane against the JAX package's: the numpy host
logic bit for bit (topology, fault trajectories, mobility, handoff
batches, the dirty set, the ledger), the batched Li-GD / MLi-GD solves
against the reference's fused path (shared and per-user edges), one
``on_events`` step from an identical plan table carried across with
``repro_torch.interop``, and the deferred paths raising (or, for those
ported since, planning).

Solver tolerances are ``torch_diff``'s (continuous 1e-4 relative,
discrete exact outside named near-ties, iteration counts ±1 on <= 1%)."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp                                          # noqa: E402

from repro.configs import chain_cnns as jcnn                     # noqa: E402
from repro.core import costs as jcosts                           # noqa: E402
from repro.core import events as jev                             # noqa: E402
from repro.core import faults as jfaults                         # noqa: E402
from repro.core import ledger as jledger                         # noqa: E402
from repro.core import mobility as jmob                          # noqa: E402
from repro.core import network as jnet                           # noqa: E402
from repro.core.ligd import LiGDConfig as JCfg                   # noqa: E402
from repro.core.ligd import solve_ligd_batch_jit                 # noqa: E402
from repro.core.mligd import solve_mligd_batch_jit               # noqa: E402
from repro.core.planner import MCSAPlanner as JPlanner           # noqa: E402
from repro.core.profile import profile_of as j_profile_of        # noqa: E402
from repro_torch import interop                                  # noqa: E402
from repro_torch.configs import chain_cnns as tcnn               # noqa: E402
from repro_torch.core import costs as tcosts                     # noqa: E402
from repro_torch.core import events as tev                       # noqa: E402
from repro_torch.core import faults as tfaults                   # noqa: E402
from repro_torch.core import ledger as tledger                   # noqa: E402
from repro_torch.core import mobility as tmob                    # noqa: E402
from repro_torch.core import network as tnet                     # noqa: E402
from repro_torch.core import planner as tplanner                 # noqa: E402
from repro_torch.core.ligd import LiGDConfig as TCfg             # noqa: E402
from repro_torch.core.ligd import solve_ligd_batch               # noqa: E402
from repro_torch.core.mligd import solve_mligd_batch             # noqa: E402
from repro_torch.core.profile import profile_of as t_profile_of  # noqa: E402

from torch_diff import (ReferenceTap, assert_discrete,           # noqa: E402
                        assert_fleets_agree, assert_iters, assert_rel,
                        jax_joint_ties, near_ties, np_of)

TOPOS = [dict(num_aps=25, num_servers=4, seed=0),
         dict(num_aps=64, num_servers=8, area=1600.0, seed=2),
         dict(num_aps=12, num_servers=3, area=6000.0, seed=5,
              r_capacity=200.0)]


def _topos(kw):
    return (jnet.build_topology(kw["num_aps"], kw["num_servers"],
                                **{k: v for k, v in kw.items()
                                   if k not in ("num_aps", "num_servers")}),
            tnet.build_topology(kw["num_aps"], kw["num_servers"],
                                **{k: v for k, v in kw.items()
                                   if k not in ("num_aps", "num_servers")}))


def _assert_topo_equal(a, b):
    for f in ("ap_xy", "adj", "server_aps", "ap_server", "hops"):
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f), f)
    assert [dataclasses.asdict(e) for e in a.edges] == \
        [dataclasses.asdict(e) for e in b.edges]
    assert a.ap_radius == b.ap_radius
    for f in ("r_capacity", "B_capacity"):
        x, y = getattr(a, f), getattr(b, f)
        assert (x is None) == (y is None)
        if x is not None:
            np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("kw", TOPOS)
def test_build_topology_bit_for_bit(kw):
    jt, tt = _topos(kw)
    _assert_topo_equal(tt, jt)
    np.testing.assert_array_equal(tt.candidates(3), jt.candidates(3))


def test_fault_trajectory_and_apply_faults_bit_for_bit():
    cfg = dict(server_mtbf=240.0, server_mttr=60.0, link_mtbf=300.0,
               link_mttr=90.0, capacity_jitter=0.15, seed=7,
               schedule=(("server_down", 30.0, 2), ("server_up", 150.0, 2)))
    jt, tt = _topos(dict(num_aps=25, num_servers=4, seed=0,
                         r_capacity=250.0))
    jm = jfaults.FaultModel(jfaults.FaultConfig(**cfg), 4, len(jt.links()))
    tm = tfaults.FaultModel(tfaults.FaultConfig(**cfg), 4, len(tt.links()))
    for k in range(12):
        jb, tb = jm.step(30.0, 30.0 * k), tm.step(30.0, 30.0 * k)
        for f in dataclasses.fields(jb):
            a, b = getattr(tb, f.name), getattr(jb, f.name)
            if isinstance(b, np.ndarray):
                np.testing.assert_array_equal(a, b, f.name)
            else:
                assert a == b, f.name
        if jb:
            jt.apply_faults(jb)
            tt.apply_faults(tb)
        _assert_topo_equal(tt, jt)
        np.testing.assert_array_equal(tt.server_available(),
                                      jt.server_available())


@pytest.mark.parametrize("admitted", [False, True])
def test_mobility_and_handoff_batches_bit_for_bit(admitted):
    jt, tt = _topos(TOPOS[0])
    jm = jmob.RandomWaypointMobility(jt, 300, speed_range=(10.0, 30.0),
                                     seed=2)
    tm = tmob.RandomWaypointMobility(tt, 300, speed_range=(10.0, 30.0),
                                     seed=2)
    adm = np.random.default_rng(0).integers(0, 4, 300) if admitted else None
    for k in range(6):
        jb = jm.step(30.0, 30.0 * k, admitted=adm)
        tb = tm.step(30.0, 30.0 * k, admitted=adm)
        np.testing.assert_array_equal(tm.xy, jm.xy)
        np.testing.assert_array_equal(tm.ap, jm.ap)
        for f in ("user", "old_server", "new_server", "new_ap", "hops_new",
                  "hops_back"):
            np.testing.assert_array_equal(getattr(tb, f), getattr(jb, f), f)
        assert tb.t == jb.t
    js = jmob.StaticMobility(jt, 50, seed=3)
    ts = tmob.StaticMobility(tt, 50, seed=3)
    np.testing.assert_array_equal(ts.positions(), js.positions())
    assert len(ts.step(30.0, 0.0)) == len(js.step(30.0, 0.0)) == 0


def test_dirty_set_flush_bit_for_bit():
    rng = np.random.default_rng(4)
    jd, td = jev.DirtySet(), tev.DirtySet()
    for t in range(3):
        n = 40
        cols = dict(user=rng.integers(0, 60, n),
                    old_server=rng.integers(0, 4, n),
                    new_server=rng.integers(0, 4, n),
                    new_ap=rng.integers(0, 25, n),
                    hops_new=rng.integers(0, 5, n),
                    hops_back=rng.integers(0, 5, n))
        jd.enqueue_handoffs(jmob.HandoffBatch(t=float(t), **cols))
        td.enqueue_handoffs(tmob.HandoffBatch(t=float(t), **cols))
        ev = rng.integers(0, 60, 7)
        args = (ev, rng.integers(0, 4, 7), rng.integers(0, 4, 7),
                rng.integers(0, 25, 7), rng.integers(0, 5, 7))
        jd.enqueue_evacuations(*args, t=float(t))
        td.enqueue_evacuations(*args, t=float(t))
    jb, tb = jd.flush(), td.flush()
    for f in dataclasses.fields(jb):
        a, b = getattr(tb, f.name), getattr(jb, f.name)
        if isinstance(b, np.ndarray):
            np.testing.assert_array_equal(a, b, f.name)
        else:
            assert a == b
    assert len(td) == len(jd) == 0


def test_ledger_bit_for_bit():
    jt, tt = _topos(dict(num_aps=25, num_servers=4, seed=0,
                         r_capacity=300.0, B_capacity=2e8))
    rng = np.random.default_rng(5)
    cols = dict(server=rng.integers(0, 4, 80), split=rng.integers(0, 10, 80),
                B=rng.uniform(1e6, 2e7, 80), r=rng.uniform(1, 32, 80))
    fleet = type("F", (), cols)
    jl, tl = jledger.BudgetLedger(jt), tledger.BudgetLedger(tt)
    for led in (jl, tl):
        led.reset_from_fleet(fleet, 9)
        led.release_rows(fleet, np.arange(10), 9)
        led.charge(np.array([0, 3]), np.array([4.0, 5.0]),
                   np.array([1e6, 3e6]))
    np.testing.assert_array_equal(tl.residual_r(), jl.residual_r())
    np.testing.assert_array_equal(tl.residual_B(), jl.residual_B())
    np.testing.assert_array_equal(tl.slot_counts(8.0), jl.slot_counts(8.0))


# ---------------------------------------------------------------------------
# Batched solves against the reference's fused path
# ---------------------------------------------------------------------------
def _solver_inputs(X: int, per_user_edge: bool, seed: int):
    rng = np.random.default_rng(seed)
    dev = dict(jcosts.DeviceFleet(c_dev=rng.uniform(2e9, 40e9, X),
                                  w_T=rng.uniform(0.2, 0.5, X),
                                  hops=rng.integers(1, 5, X),
                                  t_ag=rng.uniform(0, 3e-3, X)).arrays)
    if per_user_edge:
        pool = [jcosts.EdgeParams(c_min=c, rho_min=p, r_max=rm)
                for c, p, rm in ((3e10, 3e-4, 16.0), (5e10, 2e-4, 32.0),
                                 (8e10, 1e-4, 48.0))]
        idx = rng.integers(0, len(pool), X)
        edge = {k: np.asarray([getattr(pool[i], k) for i in idx])
                for k in jcosts.EDGE_FIELDS}
    else:
        edge = {k: float(getattr(jcosts.EdgeParams(), k))
                for k in jcosts.EDGE_FIELDS}
    return rng, dev, edge


def _both(cols, X):
    j = {k: jnp.asarray(v, jnp.float32) for k, v in cols.items()}
    if all(np.ndim(v) == 0 for v in cols.values()):
        t = {k: torch.tensor(float(v), dtype=torch.float32)
             for k, v in cols.items()}
    else:
        t = tcosts.rows_to_device(cols, "cpu", X)
    return j, t


@pytest.mark.parametrize("per_user_edge", [False, True])
def test_solve_ligd_batch_matches_reference(per_user_edge):
    X = 256
    _, dev, edge = _solver_inputs(X, per_user_edge, seed=11)
    (jd, td), (je, te) = _both(dev, X), _both(edge, X)
    jp, tp = j_profile_of(jcnn.yolov2()), t_profile_of(tcnn.yolov2())
    rj = solve_ligd_batch_jit(jp, jd, je, JCfg(max_iters=150))
    rt = solve_ligd_batch(tp, td, te, TCfg(max_iters=150))
    ties = near_ties(rj.U_per_layer)
    assert_discrete(rt.split.long(), np.asarray(rj.split, np.int64), ties,
                    "split")
    rows = ~ties
    for f in ("B", "r", "U", "T", "E", "C"):
        assert_rel(getattr(rt, f), getattr(rj, f), f, rows=rows)
    assert_rel(rt.U_per_layer, rj.U_per_layer, "U_per_layer")
    assert_iters(rt.iters_per_layer, rj.iters_per_layer)


@pytest.mark.parametrize("per_user_edge", [False, True])
def test_solve_mligd_batch_matches_reference(per_user_edge):
    X = 256
    rng, dev, edge = _solver_inputs(X, per_user_edge, seed=12)
    jp, tp = j_profile_of(jcnn.nin()), t_profile_of(tcnn.nin())
    f_l, f_e, w = jp.prefix_tables()
    s = rng.integers(0, len(f_l), X)
    o = {"f_l": f_l[s], "f_e": f_e[s], "w": w[s],
         "r": rng.uniform(1.0, 24.0, X), "B": rng.uniform(1e6, 2e7, X)}
    hops_back = rng.integers(1, 6, X).astype(np.float64)
    (jd, td), (je, te), (jo, to) = _both(dev, X), _both(edge, X), \
        _both(o, X)
    jo["split"] = jnp.asarray(s, jnp.int32)
    to["split"] = torch.from_numpy(s.astype(np.int32))
    jo["rent"] = jcosts.rent_cost(je, jo["r"], jo["B"])
    to["rent"] = tcosts.rent_cost(te, to["r"], to["B"])
    # max_iters of megafleet_100k, the slice's configuration
    cfg_j, cfg_t = JCfg(max_iters=60), TCfg(max_iters=60)
    hb_j = jnp.asarray(hops_back, jnp.float32)
    rj = solve_mligd_batch_jit(jp, jd, je, jo, hb_j, cfg_j)
    rt = solve_mligd_batch(tp, td, te, to,
                           torch.from_numpy(hops_back.astype(np.float32)),
                           cfg_t)
    ties = jax_joint_ties(jp, jd, je, jo, hb_j, cfg_j, rj)
    for f in ("R", "split"):
        assert_discrete(getattr(rt, f).long(),
                        np.asarray(getattr(rj, f), np.int64), ties, f)
    for f in ("B", "r", "U", "T", "E", "C", "U_recalc", "U_back"):
        assert_rel(getattr(rt, f), getattr(rj, f), f, rows=~ties)
    assert_iters(rt.iters_per_layer, rj.iters_per_layer)
    assert set(np.unique(rt.R.numpy())) <= {0, 1}


# ---------------------------------------------------------------------------
# One event step from an identical plan table
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("sync", [True, False])
def test_on_events_step_from_reference_plan_table(sync, monkeypatch):
    X = 400
    jt, tt = _topos(TOPOS[0])
    jp, tp = j_profile_of(jcnn.nin()), t_profile_of(tcnn.nin())
    c_dev = np.random.default_rng(6).uniform(3e9, 6e9, X)
    jdev, tdev = jcosts.DeviceFleet(c_dev=c_dev), tcosts.DeviceFleet(
        c_dev=c_dev)
    jm = jmob.RandomWaypointMobility(jt, X, speed_range=(10.0, 30.0), seed=2)
    tm = tmob.RandomWaypointMobility(tt, X, speed_range=(10.0, 30.0), seed=2)
    tap = ReferenceTap(monkeypatch, X)

    jplan = JPlanner(jp, jt, JCfg(max_iters=60), async_replanning=not sync)
    _, _, jfleet = jplan.plan_static(jdev, jt.nearest_ap(jm.positions()))
    # the port starts from the reference's plan table and T_Ag estimate
    tplan = tplanner.MCSAPlanner(tp, tt, TCfg(max_iters=60),
                                 async_replanning=not sync, device="cpu")
    tplan.t_ag_estimate = jplan.t_ag_estimate
    tfleet = interop.fleet_from_columns(
        {f: getattr(jfleet, f) for f in tplanner.PLAN_FIELDS})
    assert tfleet.server is not jfleet.server

    jb, tb = jm.step(30.0, 0.0), tm.step(30.0, 0.0)
    assert len(tb) == len(jb) > 0
    jo = jplan.on_events(jev.StepEvents(t=0.0, handoffs=jb), jdev, jfleet)
    to = tplan.on_events(tev.StepEvents(t=0.0, handoffs=tb), tdev, tfleet)
    assert to.in_flight == jo.in_flight == (not sync)
    if sync:
        assert (to.relays, to.resplits) == (jo.relays, jo.resplits)
    else:
        assert tplan.pending and jplan.pending
        jplan.drain(jfleet)
        tplan.drain(tfleet)
        assert not tplan.pending
    assert tap.solves == 2
    assert_fleets_agree(tfleet, jfleet, tap.ties, "after on_events")


# ---------------------------------------------------------------------------
# Deferred paths raise, no stubs; the paths ported since plan
# ---------------------------------------------------------------------------
def _planner(**kw):
    tt = tnet.build_topology(16, 4, seed=0, **kw.pop("topo", {}))
    return tplanner.MCSAPlanner(t_profile_of(tcnn.nin()), tt,
                                device="cpu", **kw)


@pytest.mark.parametrize("case", ["candidates_k", "capacitated", "faults",
                                  "faulted_topology", "env",
                                  "run_baseline", "autodiff"])
def test_deferred_paths_raise(case):
    """The sharded plan still raises (ROADMAP, queue 1, item 8).  K > 1,
    budgets, a fault step, a faulted topology, ``run_baseline`` and the
    autodiff oracle were deferred until admission, faults, the baselines
    and the oracle were ported: they now plan, with finite tables.  The
    oracle's plan is the fused sweep's to ``torch_diff``'s tolerances
    (split exact outside named near-ties, B, r and U to 1e-4)."""
    dev = tcosts.DeviceFleet(c_dev=np.full(8, 4e9))
    aps = np.arange(8) % 16
    if case == "env":
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            _planner().plan_static(dev, aps, env=object())
        return
    if case == "autodiff":
        dev = tcosts.DeviceFleet(
            c_dev=np.random.default_rng(3).uniform(3e9, 6e9, 8))
        fused = _planner().plan(dev, aps)
        p = _planner(cfg=TCfg(solver="autodiff"))
        res, _, fleet = p.plan_static(dev, aps)
        assert res.iters_per_layer.shape == (8, p.profile.num_layers + 1)
        ties = near_ties(np_of(res.U_per_layer))
        assert_discrete(fleet.split, fused.split, ties, "split")
        np.testing.assert_array_equal(fleet.server, fused.server)
        for f in ("B", "r", "U"):
            assert_rel(getattr(fleet, f), getattr(fused, f), f,
                       rows=~ties)
        return
    if case == "run_baseline":
        res = _planner().run_baseline("edge_only", dev, aps)
        assert np.all(res.split.numpy() == 0)
        assert np.all(np.isfinite(res.U.numpy()))
        return
    if case == "candidates_k":
        p = _planner(candidates_k=3)
    elif case == "capacitated":
        p = _planner(topo=dict(r_capacity=100.0))
    else:
        p = _planner()
    fleet = p.plan(dev, aps)
    if case in ("candidates_k", "capacitated"):
        assert p.last_admission is not None
    elif case == "faults":
        out = p.on_events(tev.StepEvents(
            t=0.0, handoffs=tmob.HandoffBatch.empty(),
            faults=tfaults.FaultBatch.empty()), dev, fleet)
        assert out.evacuation is not None and p.last_evacuation is not None
    else:
        p.topo.apply_faults(dataclasses.replace(
            tfaults.FaultBatch.empty(), server_down=np.array([1])))
        fleet = p.plan(dev, aps)
        offl = fleet.split < p.profile.num_layers
        assert not np.any(fleet.server[offl] == 1)
    assert np.all(np.isfinite(fleet.U))


def test_device_none_means_cuda_and_never_falls_back(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        tplanner.MCSAPlanner(t_profile_of(tcnn.nin()),
                             tnet.build_topology(16, 4, seed=0))


def test_update_load_prices_like_the_reference():
    """update_load: an identity snapshot keeps the static table (same
    object); a congested one gives the reference's adjusted table, and
    engine_slots follows the ledger as the reference's does."""
    from types import SimpleNamespace
    jt, tt = _topos(TOPOS[0])
    jplan = JPlanner(j_profile_of(jcnn.nin()), jt)
    tplan = tplanner.MCSAPlanner(t_profile_of(tcnn.nin()), tt, device="cpu")
    tplan.update_load(SimpleNamespace(compute_mult=np.ones(4),
                                      backhaul_mult=np.ones(4)))
    assert tplan._edge_table_eff is tplan._edge_table and tplan.load is None
    snap = SimpleNamespace(compute_mult=np.array([1.0, 2.0, 1.5, 1.0]),
                           backhaul_mult=np.array([3.0, 1.0, 1.0, 1.0]))
    jplan.update_load(snap)
    tplan.update_load(snap)
    assert tplan.load is snap
    for k, v in jplan._edge_table_eff.items():
        np.testing.assert_array_equal(tplan._edge_table_eff[k], v)
    c_dev = np.random.default_rng(1).uniform(3e9, 6e9, 64)
    aps = np.arange(64) % 25
    jplan.plan(jcosts.DeviceFleet(c_dev=c_dev), aps)
    tplan.plan(tcosts.DeviceFleet(c_dev=c_dev), aps)
    np.testing.assert_array_equal(tplan.engine_slots(8.0),
                                  jplan.engine_slots(8.0))
