"""Tests that need a CUDA card: the hand-written sweep kernel against
its plain PyTorch version on the same card tensors.  They skip without a
card.  On the machine with the card (no JAX there, so without the
repository's conftest):

    python -m pytest --noconftest -q -m cuda tests/test_torch_cuda.py

Both versions evaluate the same float32 ops in the same order (the
kernel is built without fast math and without FMA contraction), so they
are held to 1e-5."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import costs as tcosts                     # noqa: E402
from repro_torch.configs.chain_cnns import nin, vgg16            # noqa: E402
from repro_torch.core.profile import profile_of                  # noqa: E402
from repro_torch.kernels import ligd_step as tsweep              # noqa: E402

from torch_diff import (assert_discrete, assert_iters, assert_rel,  # noqa
                        near_ties, np_of, sweep_columns)

KW = dict(lr=0.15, eps=1e-5, max_iters=60)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run on the machine with the card)")
    return torch.device("cuda", 0)


def _card_inputs(joint, X, profile, device):
    dev, orig = sweep_columns(joint, X)
    td = tcosts.rows_to_device(dev, device)
    te = tcosts.edge_dict(tcosts.EdgeParams(), device)
    to = None if orig is None else tcosts.rows_to_device(orig, device)
    feat = tsweep.pack_sweep_features(
        td, te, float(profile.result_bits), X, orig=to,
        hops_back=None if to is None else to["hops_back"])
    K = 4 if joint else 2
    x0 = torch.full((K, X), 0.5, dtype=torch.float32, device=device)
    return feat, x0, tsweep.table_tensor(tsweep.sweep_tables(profile),
                                         device)


@pytest.mark.cuda
@pytest.mark.parametrize("model", [nin, vgg16])
@pytest.mark.parametrize("joint", [False, True])
def test_cuda_kernel_matches_plain_version(joint, model, cuda):
    profile = profile_of(model())
    feat, x0, tab = _card_inputs(joint, 4099, profile, cuda)   # ragged
    init = (0.5,) * x0.shape[0]
    name = "mligd_sweep" if joint else "ligd_sweep"
    before = tsweep.LAUNCHES[name]
    u, xB, xr, it, best = tsweep.sweep_cuda(
        feat, x0, tab, joint=joint, warm_start=True, init=init, **KW)
    torch.cuda.synchronize()
    assert tsweep.LAUNCHES[name] == before + 1
    ref_fn = tsweep.mligd_sweep_ref if joint else tsweep.ligd_sweep_ref
    ur, xs, itr, bs, bx, bu = ref_fn(feat, x0, tab, init=init, chunk=1,
                                     **KW)
    assert_rel(u, ur, "U per layer", rtol=1e-5)
    assert_rel(best[1], bu, "best U", rtol=1e-5)
    np.testing.assert_allclose(np_of(xB), np_of(xs[0]), atol=1e-5)
    np.testing.assert_allclose(np_of(xr), np_of(xs[1]), atol=1e-5)
    assert_iters(np_of(it).T, np_of(itr).T)
    assert_discrete(np_of(best[0]).astype(np.int64),
                    np_of(bs).astype(np.int64),
                    near_ties(np_of(ur).T, 1e-5), "best split")


@pytest.mark.cuda
def test_cuda_ops_dispatch_launches_the_kernel(cuda):
    profile = profile_of(nin())
    feat, x0, tab = _card_inputs(False, 512, profile, cuda)
    before = tsweep.LAUNCHES["ligd_sweep"]
    res = tsweep.ligd_sweep(feat, x0, tab, **KW)
    assert tsweep.LAUNCHES["ligd_sweep"] == before + 1
    assert res.best_s.device == cuda and res.best_s.dtype == torch.int32


@pytest.mark.cuda
def test_cuda_wrapper_rejects_bad_inputs(cuda):
    profile = profile_of(nin())
    feat, x0, tab = _card_inputs(False, 64, profile, cuda)
    kw = dict(joint=False, warm_start=True, init=(0.5, 0.5), **KW)
    with pytest.raises(TypeError, match="float32"):
        tsweep.sweep_cuda(feat.double(), x0, tab, **kw)
    with pytest.raises(ValueError, match="contiguous"):
        tsweep.sweep_cuda(feat.t().contiguous().t(), x0, tab, **kw)
    with pytest.raises(ValueError, match="shape"):
        tsweep.sweep_cuda(feat, x0[:1], tab, **kw)
