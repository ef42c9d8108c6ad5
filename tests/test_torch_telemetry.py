"""The port's telemetry (``repro_torch.telemetry``) against the JAX
package's: the same seeded sample streams go through both packages'
``RingBuffer``, ``TelemetryCollector`` and ``LoadEstimator``, and every
output is equal bit for bit (both are numpy doing the same operations in
the same order): ring windows, means and quantiles; harvest bundles with
their NaNs and counter deltas; EWMA state, snapshots and multipliers,
from the identity snapshot of a fresh estimator through a loaded phase
to the decay back to the identity."""
import numpy as np
import pytest

pytest.importorskip("torch")

from repro import telemetry as jtel                              # noqa: E402
from repro_torch import telemetry as ttel                        # noqa: E402

SNAPSHOT_FIELDS = ("compute_mult", "backhaul_mult", "queue_delay_s",
                   "occupancy", "token_ref_s", "token_latency_p90_s")


def _equal(a, b, where):
    """Bit-for-bit equality of two arrays (NaNs in the same places)."""
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape, (where, a, b)
    np.testing.assert_array_equal(a, b, err_msg=where)
    assert np.array_equal(np.signbit(a), np.signbit(b)), where


def _harvests_equal(h_t, h_j, where):
    assert set(h_t) == set(h_j), where
    for k in h_j:
        _equal(h_t[k], h_j[k], f"{where} {k}")


def _snapshots_equal(s_t, s_j, where):
    assert s_t.t == s_j.t, where
    for f in SNAPSHOT_FIELDS:
        _equal(getattr(s_t, f), getattr(s_j, f), f"{where} {f}")
    assert s_t.is_identity() == s_j.is_identity(), where
    assert s_t.to_dict() == s_j.to_dict(), where


def test_exports_match_reference():
    assert ttel.SAMPLERS == jtel.SAMPLERS
    assert ttel.COUNTERS == jtel.COUNTERS
    assert set(ttel.__all__) == set(jtel.__all__)


@pytest.mark.parametrize("capacity", [1, 5, 64])
def test_ring_buffer_matches_reference(capacity):
    rng = np.random.default_rng(capacity)
    rt, rj = ttel.RingBuffer(capacity), jtel.RingBuffer(capacity)
    assert rt.mean(default=-1.0) == rj.mean(default=-1.0) == -1.0
    assert rt.quantile(0.5) is None and rj.quantile(0.5) is None
    for i, x in enumerate(rng.exponential(2.0, 3 * capacity + 7)):
        rt.push(float(x))
        rj.push(float(x))
        where = f"push {i}"
        assert len(rt) == len(rj) and rt.capacity == rj.capacity, where
        _equal(rt.values(), rj.values(), where)
        assert rt.mean() == rj.mean(), where
        for q in (0.0, 0.5, 0.9, 0.99, 1.0):
            assert rt.quantile(q) == rj.quantile(q), (where, q)
        if i == 2 * capacity:
            rt.clear()
            rj.clear()
            assert len(rt) == len(rj) == 0
    with pytest.raises(ValueError):
        ttel.RingBuffer(0)


def _drive(collectors, rng, Z, n):
    """``n`` seeded hook calls into every collector alike: queue delays
    (some negative, clamped), token latencies, TTFTs, occupancies (some
    outside [0, 1], clamped), sheds and degradations, on random
    servers; some servers stay silent so their windows stay empty."""
    hooks = ("on_queue_delay", "on_token", "on_ttft", "on_occupancy",
             "on_shed", "on_degraded")
    for _ in range(n):
        hook = hooks[int(rng.integers(0, len(hooks)))]
        z = int(rng.integers(0, max(Z - 1, 1)))     # server Z-1 silent
        x = float(rng.normal(1.0, 2.0))
        for c in collectors:
            if hook in ("on_shed", "on_degraded"):
                getattr(c, hook)(z)
            else:
                getattr(c, hook)(z, x)


@pytest.mark.parametrize("Z, window", [(1, 1), (3, 4), (4, 64)])
def test_collector_harvest_matches_reference(Z, window):
    rng = np.random.default_rng(10 * Z + window)
    ct = ttel.TelemetryCollector(Z, window=window)
    cj = jtel.TelemetryCollector(Z, window=window)
    for k in range(6):
        _drive((ct, cj), rng, Z, int(rng.integers(0, 3 * window + 5)))
        where = f"harvest {k}"
        _harvests_equal(ct.harvest(), cj.harvest(), where)
        for name in ttel.COUNTERS:
            _equal(ct.totals(name), cj.totals(name), f"{where} {name}")
        for name in ttel.SAMPLERS:
            _equal(ct.window_mean(name), cj.window_mean(name), where)
            _equal(ct.window_quantile(name, 0.5),
                   cj.window_quantile(name, 0.5), where)
    # a harvest with nothing new reports zero deltas
    _harvests_equal(ct.harvest(), cj.harvest(), "idle harvest")
    assert all(int(ct.harvest()[n].sum()) == 0 for n in ttel.COUNTERS)


@pytest.mark.parametrize("alpha, max_mult", [(0.25, 8.0), (0.35, 8.0),
                                             (1.0, 3.0)])
def test_estimator_matches_reference(alpha, max_mult):
    """A fresh estimator's identity snapshot, a loaded phase (the
    collectors fed seeded samples, harvested each step), then an idle
    phase of explicit zero-occupancy samples only: the snapshots are
    equal bit for bit at every step, and both decay to the identity on
    the same step."""
    Z, window = 4, 16
    rng = np.random.default_rng(int(alpha * 100) + int(max_mult))
    ct = ttel.TelemetryCollector(Z, window=window)
    cj = jtel.TelemetryCollector(Z, window=window)
    et = ttel.LoadEstimator(Z, alpha=alpha, max_mult=max_mult)
    ej = jtel.LoadEstimator(Z, alpha=alpha, max_mult=max_mult)
    fresh_t, fresh_j = et.snapshot(t=0.0), ej.snapshot(t=0.0)
    _snapshots_equal(fresh_t, fresh_j, "fresh")
    assert fresh_t.is_identity()
    loaded = None
    for k in range(8):
        _drive((ct, cj), rng, Z, 40)
        # the queue keeps growing on server 0: a rising delay signal
        for c in (ct, cj):
            c.on_queue_delay(0, 3.0 * (k + 1))
            c.on_occupancy(0, 0.9)
        st = et.update(ct, t=30.0 * (k + 1))
        sj = ej.update(cj, t=30.0 * (k + 1))
        _snapshots_equal(st, sj, f"loaded step {k}")
        loaded = st
    assert not loaded.is_identity()
    assert et.updates == ej.updates == 8
    decayed = None
    for k in range(200):
        for c in (ct, cj):
            for z in range(Z):
                c.on_occupancy(z, 0.0)
        st = et.update(ct, t=300.0 + k)
        sj = ej.update(cj, t=300.0 + k)
        _snapshots_equal(st, sj, f"idle step {k}")
        if st.is_identity():
            decayed = k
            break
    assert decayed is not None, "the estimator never decayed to identity"
    assert sj.is_identity()
    # the per-token scale is held, never decayed, while idle
    _equal(st.token_ref_s, sj.token_ref_s, "held token scale")
    assert np.all(st.token_ref_s > 0)


def test_ewma_matches_reference():
    rng = np.random.default_rng(5)
    for n in (1, 2, 17):
        xs = rng.normal(0.0, 3.0, n).tolist()
        for alpha in (0.1, 0.5, 1.0):
            assert ttel.ewma(xs, alpha) == jtel.ewma(xs, alpha)
            assert (ttel.ewma(xs, alpha, init=2.5)
                    == jtel.ewma(xs, alpha, init=2.5))
            assert (ttel.ewma_update(xs[0], 4.0, alpha)
                    == jtel.ewma_update(xs[0], 4.0, alpha))
    with pytest.raises(ValueError):
        ttel.ewma([], 0.5)
    assert ttel.ewma([], 0.5, init=3.0) == 3.0
    for kw in ({"alpha": 0.0}, {"max_mult": 0.5}):
        with pytest.raises(ValueError):
            ttel.LoadEstimator(2, **kw)
