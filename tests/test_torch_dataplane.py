"""The port's closed-loop serving data plane
(``repro_torch.serving.dataplane``) against the JAX package's.

Both planes are driven step by step with the same fleet tables (server,
split, T) and the same fault batches, on the same stub topology, each
with its own package's ``FakeEngine`` (tokens ``last + 1``, a priced
"cache" of ``cache_bytes_per_token`` bytes a position).  The host logic
is numpy on both sides, so everything must be equal bit for bit: every
request's status, tokens, times, server, attempts and failovers, the
pools' clocks and queues, each step's track sample, ``summary()``,
``tracks`` and the failover events.  Covered: backpressure; timeout ->
retry -> degrade under ``edf`` and ``fifo``; failover to a live target,
to no target and over an unreachable relay; a server's recovery;
planned handoffs of running streams (reconcile); migrate / reprefill /
auto, with a fat cache that turns auto to re-prefill; a plane with its
collector removed; and seeded random worlds.

Then the same with real engines: the reference's ``InferenceEngine`` on
reduced starcoder2 in float32 against the port's, with the reference's
weights carried across (``torch_diff.model_pair``): equal tokens,
summaries and each failover's ``relay_bits``, which for a migration are
the bits of the exported cache leaves."""
import dataclasses
from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core.faults import HOP_UNREACHABLE                    # noqa: E402
from repro.serving import dataplane as jdp                       # noqa: E402
from repro.testing.fake_engine import FakeEngine as JFake        # noqa: E402
from repro_torch.serving import dataplane as tdp                 # noqa: E402
from repro_torch.testing.fake_engine import FakeEngine as TFake  # noqa: E402

from torch_diff import model_pair                                # noqa: E402

NUM_LAYERS = 4          # split >= 4 means device-only

REQUEST_FIELDS = ("rid", "user", "max_new", "t_submit", "deadline",
                  "token_s", "t_ready", "t_last", "status", "attempts",
                  "tokens", "server", "engine_rid", "t_first", "t_done",
                  "relay_s", "failovers")


class JFat(JFake):
    cache_bytes_per_token = 10 ** 6


class TFat(TFake):
    cache_bytes_per_token = 10 ** 6


def _topo(Z=2, backhaul=1e6):
    return SimpleNamespace(
        num_servers=Z,
        edges=[SimpleNamespace(B_backhaul=backhaul) for _ in range(Z)],
        server_aps=np.arange(Z, dtype=np.int64),
        hops=np.ones((Z, Z), np.float64))


def _fleet(servers, splits, T=None):
    servers = np.asarray(servers, np.int64)
    T = np.ones(len(servers)) if T is None else np.asarray(T, np.float64)
    return SimpleNamespace(server=servers,
                           split=np.asarray(splits, np.int64), T=T)


def _faults(down=(), up=()):
    return SimpleNamespace(server_down=np.asarray(down, np.int64),
                           server_up=np.asarray(up, np.int64))


def _cfg_kw(**kw):
    base = dict(arrival_rate=2.0, arrival_seed=3, max_requests=8,
                prompt_len=4, max_new=4, cache_len=16, deadline_s=100.0,
                max_retries=2, backoff_s=1.0, queue_limit=64,
                min_slots=2, max_slots=8, token_time_scale=4.0)
    base.update(kw)
    return base


def _request_state(plane):
    out = {}
    for rid, r in plane.requests.items():
        row = {f: getattr(r, f) for f in REQUEST_FIELDS}
        row["prompt"] = np.asarray(r.prompt).tolist()
        row["cache"] = None if r.cache is None else int(r.cache[1])
        out[rid] = row
    return out


def _pool_state(plane):
    return [(p.z, p.slots, p.up, p.clock, p.peak, p.queue_peak,
             [r.rid for r in p.queue], sorted(r.rid
                                              for r in p.active.values()))
            for p in plane.pools]


def _events(plane):
    return [dataclasses.asdict(e) for e in plane.events]


def assert_planes_equal(tp, jp, where):
    """Bit-for-bit equality of two planes' whole observable state."""
    assert _request_state(tp) == _request_state(jp), where
    assert _pool_state(tp) == _pool_state(jp), where
    assert tp.counters == jp.counters, where
    assert _events(tp) == _events(jp), where
    assert tp.tracks == jp.tracks, where
    assert tp.summary() == jp.summary(), where
    assert tp.in_flight() == jp.in_flight(), where
    assert tp.peak_concurrent == jp.peak_concurrent, where


def _planes(kw, *, Z=2, slots=2, topo=None, engines=(TFake, JFake),
            strip=False, slots_fn=None):
    topo = topo or _topo(Z)
    tcfg, jcfg = tdp.ServeConfig(**kw), jdp.ServeConfig(**kw)
    assert tcfg.to_dict() == jcfg.to_dict()
    made = []
    for mod, cfg, eng in ((tdp, tcfg, engines[0]), (jdp, jcfg, engines[1])):
        plane = mod.ServingDataPlane(cfg, topo, num_layers=NUM_LAYERS,
                                     slots=np.full(Z, slots),
                                     slots_fn=slots_fn, engine_factory=eng)
        if strip:
            plane.collector = None
        made.append(plane)
    return made


def run_script(tp, jp, script, label):
    """Drive both planes through ``script`` ([(dt, t, fleet, faults)]),
    comparing after every step and after the drain."""
    for k, (dt, t, fleet, faults) in enumerate(script):
        st = tp.step(dt, t, fleet=fleet, faults=faults)
        sj = jp.step(dt, t, fleet=fleet, faults=faults)
        assert st == sj, f"{label} step {k} sample"
        assert_planes_equal(tp, jp, f"{label} step {k}")
    tp.drain()
    jp.drain()
    assert_planes_equal(tp, jp, f"{label} drained")
    return tp.summary()


# ---------------------------------------------------------------------
# the hand-written worlds
# ---------------------------------------------------------------------
def _backpressure():
    kw = _cfg_kw(arrival_rate=8.0, max_requests=40, queue_limit=2)
    fleet = _fleet([0, 0, 0, 1], [1, 1, 1, 1])
    return kw, dict(Z=2, slots=1), [(10.0, 10.0 * i, fleet, None)
                                    for i in range(3)]


def _timeouts(order):
    kw = _cfg_kw(arrival_rate=6.0, max_requests=24, deadline_s=4.0,
                 max_retries=1, backoff_s=0.5, admission_order=order)
    fleet = _fleet([0, 1, 0], [2, 2, 2], T=[3.0, 5.0, 2.0])
    return kw, dict(Z=2, slots=1), [(10.0, 10.0 * i, fleet, None)
                                    for i in range(4)]


def _failover_live(mode="auto", fat=False):
    kw = _cfg_kw(arrival_rate=5.0, max_requests=6, max_new=6,
                 token_time_scale=6.0, cache_len=16, failover_mode=mode)
    before = _fleet([0, 0, 1], [1, 1, 1])
    after = _fleet([1, 1, 1], [1, 1, 1])
    script = [(3.0, 0.0, before, None), (3.0, 3.0, after, _faults([0])),
              (3.0, 6.0, after, None)]
    extra = dict(Z=2, slots=2)
    if fat:
        extra["engines"] = (TFat, JFat)
    return kw, extra, script


def _failover_no_target():
    kw = _cfg_kw(arrival_rate=5.0, max_requests=4, max_new=6,
                 token_time_scale=6.0)
    fleet = _fleet([0, 0], [1, 1])
    return kw, dict(Z=1, slots=2), [(3.0, 0.0, fleet, None),
                                    (3.0, 3.0, fleet, _faults([0]))]


def _unreachable():
    topo = _topo(2)
    topo.hops[0, 1] = HOP_UNREACHABLE
    kw = _cfg_kw(arrival_rate=5.0, max_requests=3, max_new=6,
                 token_time_scale=6.0)
    return kw, dict(Z=2, slots=2, topo=topo), [
        (3.0, 0.0, _fleet([0], [1]), None),
        (3.0, 3.0, _fleet([1], [1]), _faults([0]))]


def _recovery():
    kw = _cfg_kw(arrival_rate=4.0, max_requests=30, max_new=5,
                 token_time_scale=5.0, cache_len=16)
    a = _fleet([0, 1, 0, 1], [1, 2, 1, NUM_LAYERS])
    b = _fleet([1, 1, 1, 1], [1, 2, 1, NUM_LAYERS])
    return kw, dict(Z=2, slots=2,
                    slots_fn=lambda: np.asarray([4, 2], np.int64)), [
        (4.0, 0.0, a, None), (4.0, 4.0, b, _faults([0])),
        (4.0, 8.0, b, None), (4.0, 12.0, a, _faults(up=[0])),
        (4.0, 16.0, a, None)]


def _handoffs():
    """No faults: the planner moves users between servers and to and
    from device-only while their streams run (reconcile's relays)."""
    kw = _cfg_kw(arrival_rate=6.0, max_requests=30, max_new=6,
                 token_time_scale=6.0, cache_len=16)
    fleets = [_fleet([0, 1, 0, 1], [1, 1, 2, 1], T=[1.0, 2.0, 1.5, 1.0]),
              _fleet([1, 1, 0, 0], [1, 1, NUM_LAYERS, 1],
                     T=[1.0, 2.0, 1.5, 1.0]),
              _fleet([1, 0, 1, 0], [1, 2, 1, 1], T=[2.0, 1.0, 1.5, 3.0]),
              _fleet([0, 0, 1, 1], [NUM_LAYERS, 1, 1, 1],
                     T=[2.0, 1.0, 1.5, 3.0])]
    return kw, dict(Z=2, slots=2), [(3.0, 3.0 * i, f, None)
                                    for i, f in enumerate(fleets)]


CASES = {
    "backpressure": _backpressure,
    "timeout_retry_degrade_edf": lambda: _timeouts("edf"),
    "timeout_retry_degrade_fifo": lambda: _timeouts("fifo"),
    "failover_live_auto": _failover_live,
    "failover_live_migrate": lambda: _failover_live("migrate"),
    "failover_live_reprefill": lambda: _failover_live("reprefill"),
    "failover_live_auto_fat_cache": lambda: _failover_live("auto", True),
    "failover_no_target": _failover_no_target,
    "unreachable_relay": _unreachable,
    "recovery": _recovery,
    "handoffs": _handoffs,
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_plane_matches_reference(case):
    kw, extra, script = CASES[case]()
    tp, jp = _planes(kw, **extra)
    s = run_script(tp, jp, script, case)
    assert s["lost"] == 0
    # each world reaches the path it is named for
    if case == "backpressure":
        assert s["shed"] > 0 and s["degraded"] >= s["shed"]
    elif case.startswith("timeout"):
        assert s["timeouts"] > 0 and s["retries"] > 0
        assert s["degraded"] > s["shed"]
    elif case.startswith("failover_live"):
        want = {"migrate": tdp.MIGRATE, "reprefill": tdp.REPREFILL,
                "auto": tdp.MIGRATE}[kw["failover_mode"]]
        if case.endswith("fat_cache"):
            want = tdp.REPREFILL
        assert tp.events and all(e.mode == want for e in tp.events)
    elif case in ("failover_no_target", "unreachable_relay"):
        assert s["failover_events"] == 0 and s["degraded"] > 0
    elif case == "recovery":
        assert tp.pools[0].up and tp.pools[0].slots == 4
        assert s["failover_events"] > 0
    elif case == "handoffs":
        assert s["relays"] > 0 and s["failover_events"] == 0
        assert s["device"] > 0


def test_edf_differs_from_fifo_where_deadlines_do():
    """The two admission orders take different trajectories on the
    timeout world (retries carry older deadlines), each equal to the
    reference's own: edf's key is (deadline, rid)."""
    runs = {}
    for order in ("edf", "fifo"):
        kw, extra, script = _timeouts(order)
        tp, jp = _planes(kw, **extra)
        run_script(tp, jp, script, order)
        runs[order] = _request_state(tp)
    assert runs["edf"] != runs["fifo"]


@pytest.mark.parametrize("case", ["backpressure", "failover_live_auto",
                                  "recovery"])
def test_plane_without_collector_matches(case):
    """A plane whose collector is removed takes the same trajectory as
    the reference's stripped plane, and as the port's recording one
    (recording never steers)."""
    kw, extra, script = CASES[case]()
    tp, jp = _planes(kw, strip=True, **extra)
    run_script(tp, jp, script, case)
    rec, _ = _planes(kw, **extra)
    for dt, t, fleet, faults in script:
        rec.step(dt, t, fleet=fleet, faults=faults)
    rec.drain()
    assert _request_state(rec) == _request_state(tp)
    a, b = rec.summary(), tp.summary()
    a.pop("per_server")
    b.pop("per_server")
    assert a == b


@pytest.mark.parametrize("seed", range(12))
def test_random_worlds_match_reference(seed):
    """Seeded random worlds: servers, splits (some device-only) and T
    redrawn every step, servers killed and revived at random, random
    queue limits, deadlines, retries and failover modes."""
    rng = np.random.default_rng(7000 + seed)
    Z = int(rng.integers(2, 5))
    X = int(rng.integers(3, 12))
    kw = _cfg_kw(
        arrival_rate=float(rng.uniform(0.5, 12.0)),
        arrival_seed=int(rng.integers(0, 1000)),
        max_requests=int(rng.integers(4, 50)),
        deadline_s=float(rng.uniform(2.0, 60.0)),
        max_retries=int(rng.integers(0, 3)),
        backoff_s=float(rng.uniform(0.5, 3.0)),
        queue_limit=int(rng.integers(1, 8)),
        max_new=int(rng.integers(1, 8)),
        token_time_scale=float(rng.uniform(1.0, 20.0)),
        failover_mode=("auto", "reprefill", "migrate")[seed % 3],
        admission_order=("edf", "fifo")[seed % 2])
    topo = _topo(Z, backhaul=float(rng.choice([1e3, 1e6])))
    topo.hops = rng.integers(0, 4, (Z, Z)).astype(np.float64)
    if seed % 4 == 0:
        topo.hops[0, Z - 1] = HOP_UNREACHABLE
    up = np.ones(Z, bool)
    script, t = [], 0.0
    for _ in range(int(rng.integers(3, 7))):
        dt = float(rng.uniform(1.0, 8.0))
        down = [z for z in range(Z) if up[z] and rng.random() < 0.2]
        back = [z for z in range(Z) if not up[z] and rng.random() < 0.5]
        if len(down) == Z:
            down = down[1:]
        up[down] = False
        up[back] = True
        live = np.nonzero(up)[0]
        fleet = _fleet(rng.choice(live, X),
                       rng.integers(0, NUM_LAYERS + 1, X),
                       T=rng.uniform(0.2, 3.0, X))
        faults = _faults(down, back) if (down or back) else None
        script.append((dt, t, fleet, faults))
        t += dt
    tp, jp = _planes(kw, Z=Z, slots=int(rng.integers(1, 4)), topo=topo,
                     slots_fn=lambda: np.full(Z, 2, np.int64))
    s = run_script(tp, jp, script, f"seed {seed}")
    assert s["submitted"] == s["completed"] + s["device"] + s["degraded"]


def test_serve_config_round_trips_across_packages():
    cfg = tdp.ServeConfig(**_cfg_kw(relay_bits_per_token=128.0,
                                    feedback=True, failover_mode="migrate"))
    assert jdp.ServeConfig.from_dict(cfg.to_dict()).to_dict() == \
        cfg.to_dict()
    assert tdp.ServeConfig.from_dict(
        jdp.ServeConfig().to_dict()) == tdp.ServeConfig()
    for bad in ({"max_new": 0}, {"prompt_len": 8, "max_new": 8,
                                 "cache_len": 8},
                {"failover_mode": "teleport"}, {"admission_order": "lifo"},
                {"feedback_alpha": 0.0}, {"feedback_interval": 0},
                {"feedback_window": 0}, {"feedback_max_mult": 0.5}):
        with pytest.raises(ValueError):
            tdp.ServeConfig(**bad)
    with pytest.raises(TypeError):
        tdp.ServeConfig.from_dict({"bogus": 1})


def test_drain_raises_on_lost_request():
    tp, _ = _planes(_cfg_kw())
    tp.requests[99] = tdp.ServeRequest(
        rid=99, user=0, prompt=np.asarray([1, 2], np.int32), max_new=4,
        t_submit=0.0, deadline=10.0, token_s=1.0, t_ready=0.0, t_last=0.0)
    with pytest.raises(RuntimeError, match="lost 1 request"):
        tp.drain()


# ---------------------------------------------------------------------
# the default engine factory
# ---------------------------------------------------------------------
def test_default_factory_device_none_means_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        tdp.default_engine_factory(tdp.ServeConfig())
    with pytest.raises(RuntimeError, match="cuda"):
        tdp.ServingDataPlane(tdp.ServeConfig(), _topo(2),
                             num_layers=NUM_LAYERS, slots=np.full(2, 2))
    # an injected factory never asks for a device
    tdp.ServingDataPlane(tdp.ServeConfig(), _topo(2), num_layers=NUM_LAYERS,
                         slots=np.full(2, 2), engine_factory=TFake)


def test_default_factory_shares_one_parameter_set():
    """The reduced engine_arch on the CPU: one parameter set for every
    pool, reused when a pool is rebuilt after its server recovers, and
    ``d_model`` sets the re-prefill relay price (16 bits a unit)."""
    kw = _cfg_kw(arrival_rate=5.0, max_requests=6, max_new=6,
                 token_time_scale=6.0, cache_len=16)
    plane = tdp.ServingDataPlane(tdp.ServeConfig(**kw), _topo(2),
                                 num_layers=NUM_LAYERS, slots=np.full(2, 2),
                                 slots_fn=lambda: np.full(2, 2),
                                 engine_factory=tdp.default_engine_factory(
                                     tdp.ServeConfig(**kw), "cpu"))
    fac = plane._factory
    assert fac.device.type == "cpu" and fac.d_model == 64
    assert plane._bits_per_token == 16.0 * 64
    fleet = _fleet([0, 1, 0], [1, 1, 1])
    plane.step(3.0, 0.0, fleet=fleet)
    engines = [p.engine for p in plane.pools]
    assert all(e is not None for e in engines)
    assert engines[0].params is engines[1].params is fac._params
    assert engines[0].cfg.d_model == 64 and engines[0].cfg.num_layers == 2
    plane.step(3.0, 3.0, fleet=_fleet([1, 1, 1], [1, 1, 1]),
               faults=_faults([0]))
    plane.step(3.0, 6.0, fleet=fleet, faults=_faults(up=[0]))
    plane.step(3.0, 9.0, fleet=fleet)
    plane.drain()
    rebuilt = plane.pools[0].engine
    assert rebuilt is not None and rebuilt is not engines[0]
    assert rebuilt.params is fac._params
    s = plane.summary()
    assert s["lost"] == 0 and s["failover_events"] > 0


# ---------------------------------------------------------------------
# real engines: the reference's against the port's, float32
# ---------------------------------------------------------------------
@pytest.fixture(scope="module")
def real_models():
    return model_pair("starcoder2-3b", layers=2, dtype="float32")


def _real_factories(real_models, cache_len):
    from repro.runtime.meshenv import CPU_ENV
    from repro.serving.engine import InferenceEngine as JEngine
    from repro_torch.serving.engine import InferenceEngine as TEngine
    jcfg, jp, tcfg, tp = real_models

    class JFactory:
        d_model = jcfg.d_model

        def __call__(self, slots):
            return JEngine(jcfg, jp, env=CPU_ENV, slots=int(slots),
                           cache_len=cache_len)

    class TFactory:
        d_model = tcfg.d_model

        def __call__(self, slots):
            return TEngine(tcfg, tp, device="cpu", slots=int(slots),
                           cache_len=cache_len)

    return TFactory(), JFactory()


@pytest.mark.parametrize("mode, backhaul", [
    ("migrate", 1e6), ("reprefill", 1e6), ("auto", 1e6), ("auto", 1e3)])
def test_real_engines_match_reference(real_models, mode, backhaul):
    """Streams killed mid-decode on server 0 and moved to server 1 by
    each mechanism: tokens, summaries and every event (its relay_bits
    the exported cache's bits for a migration) equal the reference's;
    each failed-over stream's tokens equal its uninterrupted run's.  On
    a 1e3 Hz backhaul the cache (8 KiB a position) costs more to ship
    than the context's recompute, so auto re-prefills."""
    kw = _cfg_kw(arrival_rate=5.0, arrival_seed=4, max_requests=3,
                 max_new=6, token_time_scale=6.0, cache_len=32,
                 deadline_s=500.0, failover_mode=mode)
    topo = _topo(2, backhaul=backhaul)
    before, after = _fleet([0, 0], [1, 1]), _fleet([1, 1], [1, 1])
    kill = [(3.0, 0.0, before, None), (3.0, 3.0, after, _faults([0]))]
    factories = _real_factories(real_models, kw["cache_len"])
    tp, jp = _planes(kw, topo=topo, engines=factories)
    s = run_script(tp, jp, kill, f"{mode} kill")
    assert s["failover_events"] > 0 and s["lost"] == 0
    want = tdp.REPREFILL if (mode == "reprefill" or backhaul < 1e6) \
        else tdp.MIGRATE
    assert all(e.mode == want for e in tp.events)
    if want == tdp.MIGRATE:
        # 2 blocks x (k, v) x (pos, 2 heads, 32) float32
        for e in tp.events:
            assert e.relay_bits % (2 * 2 * 2 * 32 * 32) == 0
    it, ij = _planes(kw, topo=topo, engines=factories)
    run_script(it, ij, kill[:1], f"{mode} intact")
    for rid, req in tp.requests.items():
        assert req.status == tdp.DONE
        assert req.tokens == it.requests[rid].tokens, rid
