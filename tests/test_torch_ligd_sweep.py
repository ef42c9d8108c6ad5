"""The port's fused sweep (``repro_torch.kernels.ligd_step``) against the
JAX package's: the plain PyTorch version vs the reference's masked-JAX
sweep and its Pallas kernel in interpret mode (run as
tests/test_kernels.py runs them), both variants, at X = 96 on the NiN
profile with ``max_iters=60``; chunk invariance; the device dispatch.
The CUDA kernel itself is held against the plain version in
tests/test_torch_cuda.py, which needs a card.

Tolerances are those of ``torch_diff`` (per-layer U and the best U
within 1e-4 relative, x within 1e-4, iteration counts equal on >= 99% of
lanes and within ±1, best split exact outside named near-ties).

The rehearsal of a fast-math body (``ref.fast_math_sweep_twin``) is held
to the card's tolerances instead (U within 1e-5 relative, x within 1e-5,
the same iteration and near-tie rules at 1e-5), as tests/test_torch_cuda.py
holds the kernel: it meets them on NiN and VGG16 and on megafleet's
main-path launches, and breaks them on lanes whose stopping test sits on
eps (the divergent MLi-GD case, the serving plan), which is why
csrc/sweep.cu keeps the plain version's arithmetic."""
import re
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp                                          # noqa: E402

from repro.configs.chain_cnns import nin as j_nin                # noqa: E402
from repro.core import costs as jcosts                           # noqa: E402
from repro.core.profile import profile_of as j_profile_of        # noqa: E402
from repro.kernels import ligd_step as jsweep                    # noqa: E402
from repro_torch.configs.chain_cnns import nin as t_nin          # noqa: E402
from repro_torch.core import costs as tcosts                     # noqa: E402
from repro_torch.core.profile import profile_of as t_profile_of  # noqa: E402
from repro_torch.kernels import ligd_step as tsweep              # noqa: E402

from torch_diff import (assert_discrete, assert_iters, assert_rel,  # noqa
                        near_ties, np_of, sweep_columns)

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke                                                # noqa: E402

KW = dict(lr=0.15, eps=1e-5, max_iters=60)
#: the card's tolerances (tests/test_torch_cuda.py, chip_smoke.py)
CARD_RTOL, CARD_XTOL = 1e-5, 1e-5


def _inputs(joint: bool, X: int = 96, device="cpu"):
    """The same numpy inputs, packed by each package."""
    dev, orig = sweep_columns(joint, X)
    jp, tp = j_profile_of(j_nin()), t_profile_of(t_nin())
    K = 4 if joint else 2

    jd = {k: jnp.asarray(v, jnp.float32) for k, v in dev.items()}
    je = jcosts.edge_dict(jcosts.EdgeParams())
    jo = None if orig is None else {k: jnp.asarray(v, jnp.float32)
                                    for k, v in orig.items()}
    feat_j = jsweep.pack_sweep_features(
        jd, je, jnp.asarray(jp.result_bits, jnp.float32), X, orig=jo,
        hops_back=None if jo is None else jo["hops_back"])
    x0_j = jnp.broadcast_to(jnp.full((K, 1), 0.5, jnp.float32), (K, X))

    td = tcosts.rows_to_device(dev, device)
    te = tcosts.edge_dict(tcosts.EdgeParams(), device)
    to = None if orig is None else tcosts.rows_to_device(orig, device)
    feat_t = tsweep.pack_sweep_features(
        td, te, float(tp.result_bits), X, orig=to,
        hops_back=None if to is None else to["hops_back"])
    x0_t = torch.full((K, X), 0.5, dtype=torch.float32, device=device)
    return (feat_j, x0_j, jsweep.sweep_tables(jp)), \
        (feat_t, x0_t, tsweep.sweep_tables(tp))


def _assert_sweeps_agree(port, ref, K):
    """port/ref: (u (M1,X), xB, xr, it, best_s, best_x tuple, best_u)."""
    u_t, xB_t, xr_t, it_t, bs_t, bx_t, bu_t = port
    u_r, xB_r, xr_r, it_r, bs_r, bx_r, bu_r = ref
    assert_rel(u_t, u_r, "U per layer")
    assert_rel(bu_t, bu_r, "best U")
    assert_iters(np_of(it_t).T, np_of(it_r).T)
    ties = near_ties(np_of(u_r).T)
    assert_discrete(np_of(bs_t).astype(np.int64),
                    np_of(bs_r).astype(np.int64), ties, "best split")
    agree = np_of(bs_t).astype(np.int64) == np_of(bs_r).astype(np.int64)
    for name, a, b in (("xB", xB_t, xB_r), ("xr", xr_t, xr_r)):
        np.testing.assert_allclose(np_of(a), np_of(b), atol=1e-4,
                                   err_msg=name)
    for i in range(K):
        np.testing.assert_allclose(np_of(bx_t[i])[agree],
                                   np_of(bx_r[i])[agree], atol=1e-4,
                                   err_msg=f"best x[{i}]")


def test_feature_matrices_equal():
    """Both packers produce the same float32 matrix, bit for bit."""
    for joint in (False, True):
        (fj, _, tj), (ft, _, tt) = _inputs(joint)
        np.testing.assert_array_equal(ft.numpy(), np.asarray(fj))
        assert tt == tj
        np.testing.assert_array_equal(
            tsweep.table_tensor(tt, "cpu").numpy(),
            np.asarray(tj, np.float32))


@pytest.mark.parametrize("reference", ["masked_ref", "pallas_interpret"])
@pytest.mark.parametrize("joint", [False, True])
def test_plain_sweep_matches_reference(joint, reference):
    (fj, x0j, tabj), (ft, x0t, tabt) = _inputs(joint)
    K = x0t.shape[0]
    init = (0.5,) * K
    if reference == "masked_ref":
        ref_fn = jsweep.mligd_sweep_ref if joint else jsweep.ligd_sweep_ref
        u, xs, it, bs, bx, bu = ref_fn(fj, x0j, tabj, init=init, chunk=4,
                                       **KW)
        ref = (u, xs[0], xs[1], it, bs, bx, bu)
    else:
        u, xB, xr, it, best = jsweep.sweep_tpu(
            fj, x0j, tables=tabj, joint=joint, init=init, interpret=True,
            user_block=64, chunk=4, **KW)          # 96 = 64 + ragged 32
        ref = (u, xB, xr, it, best[0], tuple(best[2 + i] for i in range(K)),
               best[1])
    t_fn = tsweep.mligd_sweep_ref if joint else tsweep.ligd_sweep_ref
    u, xs, it, bs, bx, bu = t_fn(ft, x0t, tabt, init=init, chunk=4, **KW)
    _assert_sweeps_agree((u, xs[0], xs[1], it, bs, bx, bu), ref, K)


def test_chunk_invariance():
    """The masked step is idempotent on frozen lanes: chunk 1 and chunk 5
    give the same sweep (same arithmetic, so exactly)."""
    _, (ft, x0t, tabt) = _inputs(joint=False)
    r1 = tsweep.ligd_sweep_ref(ft, x0t, tabt, chunk=1, **KW)
    r5 = tsweep.ligd_sweep_ref(ft, x0t, tabt, chunk=5, **KW)
    for a, b in zip((r1[0], r1[2], r1[3], r1[5]), (r5[0], r5[2], r5[3],
                                                   r5[5])):
        np.testing.assert_array_equal(a.numpy(), b.numpy())
    for a, b in zip(r1[1] + r1[4], r5[1] + r5[4]):
        np.testing.assert_array_equal(a.numpy(), b.numpy())


def test_ops_cpu_dispatch_uses_plain_version():
    """A CPU tensor takes the plain version and never the kernel."""
    _, (ft, x0t, tabt) = _inputs(joint=True)
    before = dict(tsweep.LAUNCHES)
    res = tsweep.mligd_sweep(ft, x0t, tabt, chunk=1, **KW)
    ref = tsweep.mligd_sweep_ref(ft, x0t, tabt, chunk=1, **KW)
    assert tsweep.LAUNCHES == before
    assert res.best_s.dtype == torch.int32
    np.testing.assert_array_equal(res.u_layers.numpy(), ref[0].numpy())
    np.testing.assert_array_equal(res.best_s.numpy(),
                                  ref[3].to(torch.int32).numpy())
    assert len(res.best_x) == 4


def test_kernel_wrapper_refuses_cpu_tensors():
    """The CUDA wrapper checks its inputs before building or launching:
    a CPU tensor raises, and nothing is counted."""
    _, (ft, x0t, tabt) = _inputs(joint=False)
    before = dict(tsweep.LAUNCHES)
    with pytest.raises(ValueError, match="CUDA"):
        tsweep.sweep_cuda(ft, x0t, tsweep.table_tensor(tabt, "cpu"),
                          joint=False, warm_start=True, init=(0.5, 0.5),
                          **KW)
    assert tsweep.LAUNCHES == before


def test_feature_rows_match_kernel_abi():
    """SWEEP_FIELDS and the rows each variant reads are the kernel's
    ``enum Row`` (csrc/sweep.cu), in order."""
    src = (Path(tsweep.__file__).parent / "csrc" / "sweep.cu").read_text()
    body = re.search(r"enum Row \{(.*?)\};", src, re.S).group(1)
    names = [t.split("=")[0].strip() for t in body.split(",") if t.strip()]
    rows = [n for n in names if not n.startswith("NROWS")]
    renamed = {"k": "KR", "m": "M_BITS"}        # the enum's two renames
    assert rows == [renamed.get(f, f.upper()) for f in tsweep.SWEEP_FIELDS]
    assert len(rows) == tsweep.NROWS_JOINT == 29
    assert rows.index("M_BITS") + 1 == tsweep.NROWS_LIGD == 23
    assert tsweep.NROWS_JOINT <= tsweep.NF_SWEEP


def test_ops_unsupported_device_raises():
    feat = torch.zeros((tsweep.NF_SWEEP, 4), device="meta")
    x0 = torch.zeros((2, 4), device="meta")
    tab = torch.zeros((10, 4), device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        tsweep.ligd_sweep(feat, x0, tab)


# ---------------------------------------------------------------------------
# Rehearsal of a fast-math body (ref.fast_math_sweep_twin) at the card's
# tolerances
# ---------------------------------------------------------------------------
def _captured_launches(scenario, profile_arch=None):
    """The first Li-GD and MLi-GD launch of a CPU ``Session`` (or of the
    serving plan of ``profile_arch``): name -> (feat, x0, tables, kw)."""
    from repro_torch.kernels.ligd_step import ops as sweep_ops
    seen, launch = {}, sweep_ops._sweep

    def spy(feat, x0, tables, **kw):
        name = "mligd" if kw["joint"] else "ligd"
        seen.setdefault(name, (feat.clone(), x0.clone(),
                               tsweep.table_tensor(tables, feat.device),
                               dict(kw)))
        return launch(feat, x0, tables, **kw)

    sweep_ops._sweep = spy
    try:
        if profile_arch is None:
            from repro_torch.api import Session, get_scenario
            Session(get_scenario(scenario).replace(num_users=2048, steps=1),
                    device="cpu").run()
        else:
            from repro_torch.configs import get_config
            from repro_torch.launch import serve_split
            serve_split.plan_split(get_config(profile_arch), seq=1024,
                                   batch=4, c_dev=serve_split.C_DEV,
                                   device="cpu")
    finally:
        sweep_ops._sweep = launch
    return seen


def _case(name):
    """(feat, x0, tables, kw) of a rehearsal case, CPU tensors."""
    kw = dict(KW, warm_start=True)
    if name in ("nin", "vgg16", "nin-joint", "vgg16-joint"):
        from repro_torch.configs.chain_cnns import vgg16 as t_vgg16
        model = t_vgg16 if name.startswith("vgg16") else t_nin
        joint = name.endswith("joint")
        dev, orig = sweep_columns(joint, 96)
        prof = t_profile_of(model())
        td = tcosts.rows_to_device(dev, "cpu")
        te = tcosts.edge_dict(tcosts.EdgeParams(), "cpu")
        to = None if orig is None else tcosts.rows_to_device(orig, "cpu")
        feat = tsweep.pack_sweep_features(
            td, te, float(prof.result_bits), 96, orig=to,
            hops_back=None if to is None else to["hops_back"])
        K = 4 if joint else 2
        return (feat, torch.full((K, 96), 0.5), tsweep.table_tensor(
            tsweep.sweep_tables(prof), "cpu"),
            dict(kw, joint=joint, init=(0.5,) * K))
    if name in ("main-ligd", "main-mligd"):
        feat, x0, tab, k = _captured_launches("megafleet_100k")[name[5:]]
        return feat, x0, tab, dict(kw, joint=k["joint"], init=k["init"],
                                   max_iters=k["max_iters"])
    if name == "synthetic-mligd":
        feat, x0, tab, k = chip_smoke.synthetic_case(
            t_profile_of(t_nin()), 512, True, 60, "cpu")
        return feat, x0, tab, dict(kw, joint=True, init=k["init"])
    if name == "serving-plan":
        feat, x0, tab, k = _captured_launches(
            None, profile_arch="starcoder2-3b")["ligd"]
        return feat, x0, tab, dict(kw, joint=False, init=k["init"],
                                   max_iters=k["max_iters"])
    raise ValueError(name)


def _jax_masked_ref(feat, x0, tab, kw):
    fn = jsweep.mligd_sweep_ref if kw["joint"] else jsweep.ligd_sweep_ref
    tables = tuple(tuple(float(v) for v in row) for row in tab.tolist())
    u, xs, it, bs, bx, bu = fn(
        jnp.asarray(feat.numpy()), jnp.asarray(x0.numpy()), tables,
        lr=kw["lr"], eps=kw["eps"], max_iters=kw["max_iters"], chunk=4,
        warm_start=kw["warm_start"], init=kw["init"])
    return u, xs[0], xs[1], it, bs, bx, bu


def _twin(feat, x0, tab, kw, seed):
    u, xs, it, bs, bx, bu = tsweep.fast_math_sweep_twin(
        feat, x0, tab, joint=kw["joint"], lr=kw["lr"], eps=kw["eps"],
        max_iters=kw["max_iters"], warm_start=kw["warm_start"],
        init=kw["init"], seed=seed)
    return u, xs[0], xs[1], it, bs, bx, bu


def _assert_card_tolerances(port, ref):
    """port/ref: (u (M1,X), xB, xr, it, best_s, best_x tuple, best_u), held
    as tests/test_torch_cuda.py holds the kernel."""
    u_t, xB_t, xr_t, it_t, bs_t, bx_t, bu_t = port
    u_r, xB_r, xr_r, it_r, bs_r, bx_r, bu_r = ref
    assert_rel(u_t, u_r, "U per layer", rtol=CARD_RTOL)
    assert_rel(bu_t, bu_r, "best U", rtol=CARD_RTOL)
    for name, a, b in (("xB", xB_t, xB_r), ("xr", xr_t, xr_r)):
        np.testing.assert_allclose(np_of(a), np_of(b), atol=CARD_XTOL,
                                   err_msg=name)
    assert_iters(np_of(it_t).T, np_of(it_r).T)
    assert_discrete(np_of(bs_t).astype(np.int64),
                    np_of(bs_r).astype(np.int64),
                    near_ties(np_of(u_r).T, CARD_RTOL), "best split")


@pytest.mark.parametrize("seed", [None, 1, 2])
@pytest.mark.parametrize("case", ["nin", "vgg16", "nin-joint", "vgg16-joint",
                                  "main-ligd", "main-mligd"])
def test_fast_math_twin_meets_card_tolerances(case, seed):
    """On NiN and VGG16 (both variants) and on megafleet's two main-path
    launches (2,048 users), the fast-math algebra, with every approximate
    result perturbed within its PTX bound, stays within the card's
    tolerances of the JAX reference."""
    feat, x0, tab, kw = _case(case)
    _assert_card_tolerances(_twin(feat, x0, tab, kw, seed),
                            _jax_masked_ref(feat, x0, tab, kw))


def _stop_test_breaches(port, plain):
    """Lanes whose x differs by more than CARD_XTOL at some split, and the
    number of lanes whose iteration count differs."""
    dx = np.maximum(np.abs(np_of(port[1]) - np_of(plain[1])),
                    np.abs(np_of(port[2]) - np_of(plain[2]))).max(0)
    d_it = np.abs(np_of(port[3]) - np_of(plain[3])).max(0)
    return np.nonzero(dx > CARD_XTOL)[0], int(np.sum(d_it > 0))


@pytest.mark.parametrize("case", ["synthetic-mligd", "serving-plan"])
def test_fast_math_twin_breaks_card_check_on_threshold_lanes(case):
    """Where a lane's |dU| crosses eps by a few ulps a step (MLi-GD's R
    creeping at a constant gradient; the serving plan, whose U of 12-2400
    makes |dU| < 1e-5 a test of its last bits), any other rounding stops it
    at another step: the unperturbed fast-math algebra or one of eight
    perturbations moves such a lane's x by more than the card's 1e-5 from
    the plain version's, while every other lane keeps its iteration
    counts.  The card has no exception for these lanes, so the kernel
    keeps the plain version's arithmetic."""
    feat, x0, tab, kw = _case(case)
    ref = tsweep.mligd_sweep_ref if kw["joint"] else tsweep.ligd_sweep_ref
    u, xs, it, bs, bx, bu = ref(feat, x0, tab, chunk=1, **{
        k: kw[k] for k in ("lr", "eps", "max_iters", "warm_start",
                           "init")})
    plain = (u, xs[0], xs[1], it, bs, bx, bu)
    if case == "synthetic-mligd":
        assert np.mean(np_of(it) >= kw["max_iters"]) > 0.1    # capped
    X = feat.shape[1]
    broken = []
    for seed in (None,) + tuple(range(1, 9)):
        lanes, moved = _stop_test_breaches(_twin(feat, x0, tab, kw, seed),
                                           plain)
        assert moved <= max(1, 0.02 * X), (seed, moved)
        broken.append(len(lanes))
    assert max(broken) > 0, broken


@pytest.mark.parametrize("eps", [1e-5, 1e-3, 0.5, 3.0, 1e-20, 7e18])
def test_sqrt_bound_is_the_same_predicate(eps):
    """The kernel's gsq < sqrt_bound(eps) is sqrt(gsq) < eps for every
    float32 around the bound and across the range."""
    e = np.float32(eps)
    t = np.float32(tsweep.sqrt_bound(eps))
    near = t.view(np.int32) + np.arange(-4096, 4097, dtype=np.int32)
    rng = np.random.default_rng(0)
    wide = rng.integers(0, 0x7f800000, 200_000, dtype=np.int32)
    g = np.concatenate([near, wide]).view(np.float32)
    g = g[np.isfinite(g) & (g >= 0)]
    np.testing.assert_array_equal(np.sqrt(g) < e, g < t)
    assert tsweep.sqrt_bound(0.0) == 0.0
    assert np.isnan(tsweep.sqrt_bound(float("nan")))
