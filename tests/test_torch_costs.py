"""The port's cost model (``repro_torch.core.costs`` / ``profile``)
against the JAX package's: utility and its T/E/C terms on random batches
(within ``torch_diff.RTOL``: XLA's and ATen's pow/log2 differ by ulps),
prefix tables, fingerprints and profiles exactly (host numpy on both
sides), and the host-to-device column move bit for bit."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp                                          # noqa: E402

from repro.configs import chain_cnns as jcnn                     # noqa: E402
from repro.core import costs as jcosts                           # noqa: E402
from repro.core.profile import profile_of as j_profile_of        # noqa: E402
from repro_torch.configs import chain_cnns as tcnn               # noqa: E402
from repro_torch.core import costs as tcosts                     # noqa: E402
from repro_torch.core.profile import profile_of as t_profile_of  # noqa: E402

from torch_diff import assert_rel                                # noqa: E402

MODELS = ("nin", "yolov2", "vgg16")


def _random_batch(seed: int, X: int = 257):
    """Device/edge/strategy columns from numpy (float64 host draws)."""
    rng = np.random.default_rng(seed)
    dev = {k: np.full(X, float(getattr(jcosts.DeviceParams(), k)))
           for k in jcosts.DEV_FIELDS}
    dev.update(c_dev=rng.uniform(1e9, 60e9, X), w_T=rng.uniform(0.1, 0.6, X),
               w_E=rng.uniform(0.1, 0.6, X), hops=rng.integers(1, 6, X),
               t_ag=rng.uniform(0.0, 5e-3, X), p_tx=rng.uniform(0.1, 1.0, X))
    edge = {k: np.full(X, float(getattr(jcosts.EdgeParams(), k)))
            for k in jcosts.EDGE_FIELDS}
    edge.update(c_min=rng.uniform(2e10, 8e10, X),
                rho_min=rng.uniform(1e-4, 4e-4, X),
                B_backhaul=rng.uniform(5e8, 2e9, X))
    strat = {"f_l": rng.uniform(0, 2e9, X), "f_e": rng.uniform(0, 4e9, X),
             "w": rng.uniform(1e4, 4e6, X),
             "B": rng.uniform(1e6, 2e7, X), "r": rng.uniform(1.0, 32.0, X)}
    strat["f_e"][::7] = 0.0                 # device-only rows
    return dev, edge, strat


def _jax(cols):
    return {k: jnp.asarray(v, jnp.float32) for k, v in cols.items()}


def _torch(cols):
    return tcosts.rows_to_device(cols, "cpu")


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_utility_and_terms_match_reference(seed):
    dev, edge, st = _random_batch(seed)
    m = 320.0
    jd, je, js = _jax(dev), _jax(edge), _jax(st)
    td, te, ts = _torch(dev), _torch(edge), _torch(st)
    Uj, (Tj, Ej, Cj) = jcosts.utility(jd, je, js["f_l"], js["f_e"], js["w"],
                                      m, js["B"], js["r"])
    Ut, (Tt, Et, Ct) = tcosts.utility(td, te, ts["f_l"], ts["f_e"], ts["w"],
                                      m, ts["B"], ts["r"])
    for name, a, b in (("U", Ut, Uj), ("T", Tt, Tj), ("E", Et, Ej),
                       ("C", Ct, Cj)):
        assert_rel(a, b, name)
    assert_rel(tcosts.rent_cost(te, ts["r"], ts["B"]),
               jcosts.rent_cost(je, js["r"], js["B"]), "rent")
    assert_rel(tcosts.shannon_rate(td, te, ts["B"]),
               jcosts.shannon_rate(jd, je, js["B"]), "tau")


@pytest.mark.parametrize("model", MODELS)
def test_prefix_tables_and_fingerprint_equal(model):
    pj = j_profile_of(jcnn.CNN_BUILDERS[model]())
    pt = t_profile_of(tcnn.CNN_BUILDERS[model]())
    for a, b in zip(pt.prefix_tables(), pj.prefix_tables()):
        np.testing.assert_array_equal(a, b)
    assert pt.fingerprint == pj.fingerprint
    assert pt.num_layers == pj.num_layers


@pytest.mark.parametrize("model", MODELS)
def test_profile_of_equal(model):
    # the copied model spec is field for field the reference's
    assert dataclasses.asdict(tcnn.CNN_BUILDERS[model]()) == \
        dataclasses.asdict(jcnn.CNN_BUILDERS[model]())
    pj =j_profile_of(jcnn.CNN_BUILDERS[model]())
    pt = t_profile_of(tcnn.CNN_BUILDERS[model]())
    assert pt.name == pj.name
    np.testing.assert_array_equal(pt.flops, pj.flops)
    np.testing.assert_array_equal(pt.out_bits, pj.out_bits)
    assert (pt.in_bits, pt.result_bits) == (pj.in_bits, pj.result_bits)
    assert pt.flops.dtype == pj.flops.dtype == np.float64


def test_device_columns_move_bit_for_bit():
    """One-copy column move == the reference's per-field f32 cast."""
    rng = np.random.default_rng(3)
    fleet_t = tcosts.DeviceFleet(c_dev=rng.uniform(3e9, 6e9, 64),
                                 w_T=rng.uniform(0.1, 0.5, 64))
    fleet_j = jcosts.DeviceFleet(c_dev=fleet_t.arrays["c_dev"],
                                 w_T=fleet_t.arrays["w_T"])
    idx = rng.permutation(64)[:17]
    for got, want in ((tcosts.stack_devices(fleet_t, "cpu"),
                       jcosts.stack_devices(fleet_j)),
                      (tcosts.gather_devices(fleet_t, idx, "cpu"),
                       jcosts.gather_devices(fleet_j, idx))):
        assert set(got) == set(want)
        for k in want:
            assert got[k].dtype == torch.float32
            np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))


def test_apply_congestion_identity_and_division():
    edges = [tcosts.EdgeParams(c_min=4e10), tcosts.EdgeParams(c_min=6e10)]
    table = tcosts.stack_edges_np(edges)
    assert tcosts.apply_congestion(table, np.ones(2), None) is table
    out = tcosts.apply_congestion(table, np.array([2.0, 0.5]),
                                  np.array([1.0, 4.0]))
    ref = jcosts.apply_congestion(jcosts.stack_edges_np(
        [jcosts.EdgeParams(c_min=4e10), jcosts.EdgeParams(c_min=6e10)]),
        np.array([2.0, 0.5]), np.array([1.0, 4.0]))
    for k in ref:
        np.testing.assert_array_equal(out[k], ref[k])
