"""The port's autodiff Li-GD / MLi-GD oracles (``solver="autodiff"``,
``solve_ligd``, ``solve_mligd``) against the JAX package's, from the same
numpy inputs, and against the port's own fused sweep (its plain version,
on the CPU).

The fleets are the reference tests' own (tests/test_ligd.py:149-190,
tests/test_mligd.py:89-120), drawn by ``chip_smoke.oracle_columns``,
which ``[ligd-oracle]`` also runs on the card.  Tolerances:

* port oracle vs reference oracle: split and R exact; the solved fields
  (B, r, U, T, E, C, the vertex utilities) to 1e-5 relative (torch's and
  JAX's autodiff of the same float32 utility differ by ulps; readings
  below 3e-7); per-split iteration counts within 1, equal on at least
  99% of (lane, split) pairs, where the per-split fields agree to 1e-5;
  where a cold-started lane's |ΔU| sits on eps and one package stops a
  step before the other, U agrees to 2·eps absolute (each of those
  steps moves U by about eps) and B, r, which a flat U leaves free to
  move by one step, are not compared.
* port oracle vs port sweep: the reference's own fused-vs-autodiff
  tolerances, split and R exact, B, r, U to 1e-4, iteration counts
  within 1 (``chip_smoke.oracle_errors``).
"""
import dataclasses
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs.chain_cnns import nin as j_nin                  # noqa
from repro.configs.chain_cnns import vgg16 as j_vgg16              # noqa
from repro.core import costs as jcosts                             # noqa
from repro.core import ligd as jligd                               # noqa
from repro.core import mligd as jmligd                             # noqa
from repro.core.profile import profile_of as j_profile_of          # noqa
from repro_torch.core import costs as tcosts                       # noqa
from repro_torch.core import ligd as tligd                         # noqa
from repro_torch.core import mligd as tmligd                       # noqa

from torch_diff import np_of                                       # noqa

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke                                                  # noqa

CASES = {c["name"]: c for c in chip_smoke.ORACLE_CASES}
RESULT_RTOL = 1e-5
EPS = tligd.LiGDConfig().eps


def _j_inputs(case):
    cols = chip_smoke.oracle_columns(case)
    jd = {k: jnp.asarray(v, jnp.float32) for k, v in cols["dev"].items()}
    je = (jcosts.edge_dict(jcosts.EdgeParams()) if cols["edge"] is None
          else {k: jnp.asarray(v, jnp.float32)
                for k, v in cols["edge"].items()})
    prof = j_profile_of({"nin": j_nin, "vgg16": j_vgg16}[case["model"]]())
    return prof, jd, je


def _rel(a, b):
    a, b = np.asarray(np_of(a), np.float64), np.asarray(np_of(b), np.float64)
    return np.abs(a - b) / np.maximum(np.abs(b), 1e-30)


def _assert_oracles_agree(port, ref, per_layer=True):
    np.testing.assert_array_equal(np_of(port.split).astype(np.int64),
                                  np.asarray(ref.split, np.int64))
    fields = ["B", "r", "U"]
    if hasattr(ref, "R"):
        np.testing.assert_array_equal(np_of(port.R), np.asarray(ref.R))
        fields += ["T", "E", "C", "U_recalc", "U_back"]
    else:
        fields += ["T", "E", "C"]
    for f in fields:
        assert _rel(getattr(port, f), getattr(ref, f)).max() <= RESULT_RTOL, f
    it_p = np_of(port.iters_per_layer).astype(np.int64)
    it_r = np.asarray(ref.iters_per_layer, np.int64)
    assert np.abs(it_p - it_r).max() <= 1
    if per_layer:
        same = it_p == it_r
        assert same.mean() >= 0.99
        for f in ("U_per_layer", "B_per_layer", "r_per_layer"):
            assert _rel(getattr(port, f), getattr(ref, f))[same].max() \
                <= RESULT_RTOL, f
        du = np.abs(np_of(port.U_per_layer) - np.asarray(ref.U_per_layer))
        assert du[~same].max(initial=0.0) <= 2 * EPS


@pytest.mark.parametrize("name", ["nin_hetero_warm", "nin_hetero_cold",
                                  "vgg16_shared"])
def test_batched_ligd_oracle_matches_reference(name):
    case = CASES[name]
    prof, jd, je = _j_inputs(case)
    cfg = dict(max_iters=case["max_iters"], warm_start=case["warm_start"],
               solver="autodiff")
    ref = jligd.solve_ligd_batch_jit(prof, jd, je, jligd.LiGDConfig(**cfg))
    fn, args, _ = chip_smoke.oracle_args(case, "cpu")
    port = fn(*args, tligd.LiGDConfig(**cfg))
    assert port.iters_per_layer.dtype == torch.int32
    assert tuple(port.U_per_layer.shape) == (case["X"], prof.num_layers + 1)
    _assert_oracles_agree(port, ref)


def test_single_user_ligd_oracle_matches_reference():
    """``solve_ligd`` on one user (0-d leaves, default config)."""
    jp = j_profile_of(j_nin())
    from repro_torch.configs.chain_cnns import nin
    from repro_torch.core.profile import profile_of
    ref = jligd.solve_ligd(jp, jcosts.dev_dict(jcosts.DeviceParams(
        c_dev=25e9)), jcosts.edge_dict(jcosts.EdgeParams()))
    port = tligd.solve_ligd(profile_of(nin()), tcosts.dev_dict(
        tcosts.DeviceParams(c_dev=25e9), "cpu"),
        tcosts.edge_dict(tcosts.EdgeParams(), "cpu"))
    assert port.split.dim() == 0 and tuple(port.U_per_layer.shape) == (10,)
    _assert_oracles_agree(port, ref)


def _j_origs(case):
    """The reference test's frozen strategies: each user's reference
    ``solve_ligd`` against the default server."""
    prof, jd, _ = _j_inputs(case)
    edge_orig = jcosts.edge_dict(jcosts.EdgeParams())
    c_dev = np.asarray(jd["c_dev"])
    origs = []
    for c in c_dev:
        d = jcosts.dev_dict(jcosts.DeviceParams(c_dev=float(c)))
        prev = jligd.solve_ligd(prof, d, edge_orig)
        origs.append(jmligd.orig_strategy_dict(prof, edge_orig, prev))
    return jax.tree.map(lambda *xs: np.stack([np.asarray(x) for x in xs]),
                        *origs)


@pytest.mark.parametrize("name", ["mligd_relay_back", "mligd_resolve"])
def test_batched_mligd_oracle_matches_reference(name):
    """Both Corollary-7 vertices, from the same frozen strategies."""
    case = CASES[name]
    prof, jd, _ = _j_inputs(case)
    origs = _j_origs(case)
    X = case["X"]
    hops = np.full(X, case["hops_back"], np.float32)
    cfg = dict(max_iters=case["max_iters"], solver="autodiff")
    ref = jmligd.solve_mligd_batch_jit(
        prof, jd, jcosts.edge_dict(jcosts.EdgeParams(**case["new_edge"])),
        jax.tree.map(jnp.asarray, origs), jnp.asarray(hops),
        jligd.LiGDConfig(**cfg))
    assert (np.asarray(ref.R) == case["vertex"]).all()
    t_origs = {k: torch.from_numpy(np.asarray(v)) for k, v in origs.items()}
    t_origs = {k: (v.to(torch.int32) if k == "split" else v.float())
               for k, v in t_origs.items()}
    fn, args, _ = chip_smoke.oracle_args(case, "cpu", origs=t_origs)
    port = fn(*args, tligd.LiGDConfig(**cfg))
    _assert_oracles_agree(port, ref, per_layer=False)


def test_single_user_mligd_oracle_matches_reference():
    """``solve_mligd`` for one user after a handoff, its frozen strategy
    from its own ``solve_ligd`` in each package."""
    from repro_torch.configs.chain_cnns import nin
    from repro_torch.core.profile import profile_of
    jp, tp = j_profile_of(j_nin()), profile_of(nin())
    dp = dict(c_dev=8e9)
    new = dict(c_min=2e9, rho_min=5e-3, r_max=4.0)
    jd = jcosts.dev_dict(jcosts.DeviceParams(**dp))
    jeo, jen = (jcosts.edge_dict(jcosts.EdgeParams(**kw)) for kw in ({}, new))
    jo = jmligd.orig_strategy_dict(jp, jeo, jligd.solve_ligd(jp, jd, jeo))
    ref = jmligd.solve_mligd(jp, jd, jen, jo, jnp.asarray(1.0, jnp.float32))
    td = tcosts.dev_dict(tcosts.DeviceParams(**dp), "cpu")
    teo, ten = (tcosts.edge_dict(tcosts.EdgeParams(**kw), "cpu")
                for kw in ({}, new))
    to = tmligd.orig_strategy_dict(tp, teo, tligd.solve_ligd(tp, td, teo))
    port = tmligd.solve_mligd(tp, td, ten, to, 1.0)
    assert port.R.dim() == 0 and int(port.R) == int(ref.R) == 1
    _assert_oracles_agree(port, ref, per_layer=False)


@pytest.mark.parametrize("name", list(CASES))
def test_oracle_matches_the_ports_sweep(name):
    """The port's oracle against its fused sweep (the plain version here;
    ``[ligd-oracle]`` holds the kernel the same way on the card), at the
    reference's fused-vs-autodiff tolerances."""
    case = CASES[name]
    fn, args, cfg = chip_smoke.oracle_args(case, "cpu")
    fused = fn(*args, cfg)
    oracle = fn(*args, dataclasses.replace(cfg, solver="autodiff"))
    err, breaches = chip_smoke.oracle_errors(fused, oracle)
    assert not breaches, (err, breaches)
    if "vertex" in case:
        assert (oracle.R.numpy() == case["vertex"]).all()


def test_gd_solve_keeps_stopped_lanes():
    """Lanes stop on their own: a lane that has stopped keeps its carry
    while the others step on, as a vmapped while loop does — each lane's
    result equals its own one-lane solve."""
    cfg = tligd.LiGDConfig(max_iters=200)
    target = torch.tensor([[0.2, 0.9, 0.5], [0.7, 0.1, 0.5]])
    scale = torch.tensor([1.0, 0.05, 3.0])

    def u(x, t=target, s=scale):
        return (s * (x - t).square()).sum(0)

    x0 = torch.full((2, 3), 0.5)
    x, val, it = tligd._gd_solve(u, x0, cfg)
    assert len(set(it.tolist())) == 3
    for i in range(3):
        xi, vi, ii = tligd._gd_solve(
            lambda y, i=i: u(y, target[:, i:i + 1], scale[i:i + 1]),
            x0[:, i:i + 1], cfg)
        assert torch.equal(xi[:, 0], x[:, i]) and int(ii) == int(it[i])
