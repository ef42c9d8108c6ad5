"""The port's fused sweep (``repro_torch.kernels.ligd_step``) against the
JAX package's: the plain PyTorch version vs the reference's masked-JAX
sweep and its Pallas kernel in interpret mode (run as
tests/test_kernels.py runs them), both variants, at X = 96 on the NiN
profile with ``max_iters=60``; chunk invariance; the device dispatch.
The CUDA kernel itself is held against the plain version in
tests/test_torch_cuda.py, which needs a card.

Tolerances are those of ``torch_diff`` (per-layer U and the best U
within 1e-4 relative, x within 1e-4, iteration counts equal on >= 99% of
lanes and within ±1, best split exact outside named near-ties)."""
import re
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

KW = dict(lr=0.15, eps=1e-5, max_iters=60)


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
