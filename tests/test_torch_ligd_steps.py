"""Kernel row 2, the single-split Li-GD steps (``ligd_steps_tpu``), in the
port: its feature packing, its edge constants and its plain version (the
autodiff oracle) against the JAX package's ``pack_features``,
``edge_tuple_of``, ``ligd_steps_ref`` and the Pallas kernel in interpret
mode, on the reference test's vgg16 inputs and on a random fleet over
every split of NiN.

Tolerances are the reference test's (``tests/test_kernels.py``): x
within 1e-5, U within atol 1e-5 / rtol 1e-4 (the Pallas kernel's closed
form against autograd; the two oracles agree to rounding)."""
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs.chain_cnns import nin as j_nin                    # noqa
from repro.configs.chain_cnns import vgg16 as j_vgg16                # noqa
from repro.core import costs as jcosts                               # noqa
from repro.core.profile import profile_of as j_profile_of            # noqa
from repro.kernels import ligd_step as jls                           # noqa
from repro_torch.core import costs as tcosts                         # noqa
from repro_torch.kernels import ligd_step as tls                     # noqa

from torch_diff import np_of                                         # noqa

X_ATOL, U_ATOL, U_RTOL = 1e-5, 1e-5, 1e-4


def _vgg_inputs():
    """The reference test's inputs: every split of vgg16, default device
    and edge, x0 = 0.5."""
    prof = j_profile_of(j_vgg16())
    f_l, f_e, w = prof.prefix_tables()
    n = len(f_l)
    offl = (f_e > 0).astype(np.float32)
    cols = (f_l, f_e, w, np.full(n, prof.result_bits), offl)
    jfeat = jls.pack_features(*(jnp.asarray(c, jnp.float32) for c in cols),
                              jcosts.dev_dict(jcosts.DeviceParams()))
    tfeat = tls.pack_features(
        *(torch.tensor(np.asarray(c, np.float32)) for c in cols),
        tcosts.dev_dict(tcosts.DeviceParams(), "cpu"))
    return jfeat, tfeat, np.full((n, 2), 0.5, np.float32)


def _fleet_inputs(X=300, seed=3):
    """Random users (c_dev, weights, hops, rounds, t_ag) at random splits
    of NiN, x0 random in [0, 1]^2, against one non-default edge server."""
    rng = np.random.default_rng(seed)
    prof = j_profile_of(j_nin())
    f_l, f_e, w = prof.prefix_tables()
    s = rng.integers(0, len(f_l), X)
    wts = rng.dirichlet(np.ones(3), X)
    dev = dict(c_dev=rng.uniform(3e9, 60e9, X), w_T=wts[:, 0],
               w_E=wts[:, 1], w_C=wts[:, 2],
               hops=rng.integers(1, 6, X).astype(np.float64),
               k_rounds=rng.uniform(10, 100, X),
               t_ag=rng.uniform(0, 5e-3, X))
    jdev = dict(jcosts.stack_devices(jcosts.DeviceFleet(**dev)))
    tdev = tcosts.rows_to_device(tcosts.device_columns(
        tcosts.DeviceFleet(**dev)), "cpu", X)
    cols = (f_l[s], f_e[s], w[s], np.full(X, prof.result_bits),
            (f_e[s] > 0).astype(np.float64))
    jfeat = jls.pack_features(*(jnp.asarray(c, jnp.float32) for c in cols),
                              jdev)
    tfeat = tls.pack_features(*(torch.tensor(c, dtype=torch.float32)
                                for c in cols), tdev)
    edge = dict(c_min=30e9, rho_min=3e-4, lam_a=0.8, rho_B=2e-4,
                gamma_B=1.4, B0=2e6, B_backhaul=5e8, N0=4e-21, B_min=1e6,
                B_max=2e7, r_min=1.0, r_max=32.0)
    x0 = rng.uniform(0, 1, (X, 2)).astype(np.float32)
    return jfeat, tfeat, x0, edge


def test_pack_features_and_edge_tuple_match_reference():
    jfeat, tfeat, _ = _vgg_inputs()
    assert tuple(tfeat.shape) == (jfeat.shape[0], tls.NF)
    np.testing.assert_array_equal(np_of(tfeat), np.asarray(jfeat))
    jf, tf, _, edge = _fleet_inputs(X=50)
    np.testing.assert_array_equal(np_of(tf), np.asarray(jf))
    assert tls.edge_tuple_of(edge) == jls.edge_tuple_of(edge)
    assert tls.edge_tuple_of(tcosts.edge_dict(tcosts.EdgeParams(), "cpu")) \
        == jls.edge_tuple_of(jcosts.edge_dict(jcosts.EdgeParams()))


def _check(x, u, xr, ur, what):
    np.testing.assert_allclose(np_of(x), np.asarray(xr), atol=X_ATOL,
                               err_msg=f"x vs {what}")
    np.testing.assert_allclose(np_of(u), np.asarray(ur), atol=U_ATOL,
                               rtol=U_RTOL, err_msg=f"U vs {what}")


@pytest.mark.parametrize("iters", [48, 64])
def test_ligd_steps_match_reference_on_vgg16(iters):
    jfeat, tfeat, x0 = _vgg_inputs()
    jedge = jcosts.edge_dict(jcosts.EdgeParams())
    tedge = tcosts.edge_dict(tcosts.EdgeParams(), "cpu")
    x, u = tls.ligd_steps(tfeat, torch.from_numpy(x0), tedge, iters=iters)
    assert tuple(x.shape) == (len(x0), 2) and tuple(u.shape) == (len(x0),)
    xr, ur = jls.ligd_steps_ref(jfeat, jnp.asarray(x0), jedge, iters=iters)
    _check(x, u, xr, ur, "ligd_steps_ref")
    xk, uk = jls.ligd_steps_tpu(jfeat, jnp.asarray(x0),
                                edge_tuple=jls.edge_tuple_of(jedge),
                                iters=iters, interpret=True)
    _check(x, u, xk, uk, "ligd_steps_tpu (interpret)")


def test_ligd_steps_match_reference_on_a_random_fleet():
    jfeat, tfeat, x0, edge = _fleet_inputs()
    x, u = tls.ligd_steps(tfeat, torch.from_numpy(x0), edge, iters=64,
                          lr=0.1)
    xr, ur = jls.ligd_steps_ref(jfeat, jnp.asarray(x0),
                                {k: jnp.float32(v) for k, v in edge.items()},
                                iters=64, lr=0.1)
    _check(x, u, xr, ur, "ligd_steps_ref")
    xk, uk = jls.ligd_steps_tpu(jfeat, jnp.asarray(x0),
                                edge_tuple=jls.edge_tuple_of(edge), iters=64,
                                lr=0.1, user_block=128, interpret=True)
    _check(x, u, xk, uk, "ligd_steps_tpu (interpret)")
    # the steps moved the users, and stayed in the box
    assert np.abs(np_of(x) - x0).max() > 1e-2
    assert np_of(x).min() >= 0.0 and np_of(x).max() <= 1.0


def test_zero_steps_return_the_start_and_its_utility():
    _, tfeat, x0 = _vgg_inputs()
    tedge = tcosts.edge_dict(tcosts.EdgeParams(), "cpu")
    x, u = tls.ligd_steps(tfeat, torch.from_numpy(x0), tedge, iters=0)
    np.testing.assert_array_equal(np_of(x), x0)
    _, u1 = tls.ligd_steps(tfeat, torch.from_numpy(x0), tedge, iters=1)
    assert np.all(np_of(u1) <= np_of(u) + 1e-9)       # a descent step


def test_cuda_wrapper_refuses_cpu_tensors_and_missing_edge_constants():
    _, tfeat, x0 = _vgg_inputs()
    et = tls.edge_tuple_of(tcosts.edge_dict(tcosts.EdgeParams(), "cpu"))
    before = tls.steps.LAUNCHES["ligd_steps"]
    with pytest.raises(ValueError, match="CUDA"):
        tls.ligd_steps_cuda(tfeat, torch.from_numpy(x0), et)
    with pytest.raises(ValueError, match="missing"):
        tls.ligd_steps(tfeat, torch.from_numpy(x0), {"B_min": 1.0})
    assert tls.steps.LAUNCHES["ligd_steps"] == before
