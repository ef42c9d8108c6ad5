"""Tests that need a CUDA card: the hand-written kernels (the sweep,
RMSNorm, flash attention, the fused expert SwiGLU, WKV6) against their
plain PyTorch versions on the same card tensors.  They skip without a
card.  On the machine with the card (no JAX there, so without the
repository's conftest):

    python -m pytest --noconftest -q -m cuda tests/test_torch_cuda.py

The sweep's two versions evaluate the same float32 ops in the same order
(the kernel is built without fast math and without FMA contraction), so
they are held to 1e-5; the language-model kernels' tolerances are given
beside their tests."""
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


# ---------------------------------------------------------------------------
# RMSNorm (row 4) and flash attention (row 3): kernel against plain
# version on the card.  RMSNorm: 1e-5 in float32 (another summation
# order, rsqrtf), one bf16 rounding (5e-2) in bfloat16.  Attention: 2e-5
# in float32 (another summation order) elementwise and on the error's
# RMS over the output's RMS; in bfloat16 1e-2 elementwise and 1e-3 on
# that RMS ratio: outputs of long causal rows are ~0.05, so the reference
# kernel tests' 3e-2 could pass a dropped kv tile there.  Both sides
# round the same f32 value to bfloat16, so they differ by one ulp on a
# few elements only.
# ---------------------------------------------------------------------------
from repro_torch.kernels import flash_attention as tflash        # noqa: E402
from repro_torch.kernels import rmsnorm as trms                  # noqa: E402


def _randn(shape, dtype, device, seed):
    g = torch.Generator(device=device).manual_seed(seed)
    return torch.randn(shape, generator=g, device=device).to(dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("rows,d", [(8, 3072), (1000, 384), (3, 200)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_rmsnorm_matches_plain_version(rows, d, dtype, cuda):
    dt = getattr(torch, dtype)
    x, w = _randn((rows, d), dt, cuda, 0), _randn((d,), dt, cuda, 1)
    before = trms.LAUNCHES["rmsnorm"]
    y = trms.rmsnorm_cuda(x, w, 1e-6)
    torch.cuda.synchronize()
    assert trms.LAUNCHES["rmsnorm"] == before + 1
    tol = 1e-5 if dtype == "float32" else 5e-2
    torch.testing.assert_close(y.float(), trms.rmsnorm_ref(x, w).float(),
                               atol=tol, rtol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("B,Hq,Hkv,S,hd,causal,window", [
    (1, 4, 2, 128, 64, True, 0),
    (2, 8, 1, 200, 32, True, 0),        # MQA, ragged
    (1, 24, 2, 333, 128, True, 0),      # starcoder2 heads, ragged
    (1, 2, 2, 192, 32, True, 32),
    (2, 4, 2, 96, 64, False, 0),
    (1, 4, 4, 160, 128, False, 48),
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_flash_attention_matches_plain_version(B, Hq, Hkv, S, hd, causal,
                                                    window, dtype, cuda):
    dt = getattr(torch, dtype)
    q = _randn((B, S, Hq, hd), dt, cuda, 2)
    k = _randn((B, S, Hkv, hd), dt, cuda, 3)
    v = _randn((B, S, Hkv, hd), dt, cuda, 4)
    before = tflash.LAUNCHES["flash_attention"]
    out = tflash.flash_attention_cuda(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert tflash.LAUNCHES["flash_attention"] == before + 1
    ref = tflash.attention_ref(q, k, v, causal=causal, window=window).float()
    tol, rms_tol = (2e-5, 2e-5) if dtype == "float32" else (1e-2, 1e-3)
    torch.testing.assert_close(out.float(), ref, atol=tol, rtol=tol)
    rms = lambda t: t.square().mean().sqrt().item()               # noqa: E731
    assert rms(out.float() - ref) <= rms_tol * rms(ref)


@pytest.mark.cuda
def test_cuda_lm_ops_dispatch_launch_the_kernels(cuda):
    x = _randn((2, 5, 64), torch.bfloat16, cuda, 5)
    w = _randn((64,), torch.bfloat16, cuda, 6)
    before = trms.LAUNCHES["rmsnorm"]
    assert trms.rmsnorm(x, w).shape == x.shape
    assert trms.LAUNCHES["rmsnorm"] == before + 1
    q = _randn((1, 16, 4, 32), torch.bfloat16, cuda, 7)
    before = tflash.LAUNCHES["flash_attention"]
    assert tflash.flash_attention(q, q[:, :, :2].contiguous(),
                                  q[:, :, 2:].contiguous()).shape == q.shape
    assert tflash.LAUNCHES["flash_attention"] == before + 1


@pytest.mark.cuda
def test_cuda_lm_wrappers_reject_bad_inputs(cuda):
    x = _randn((4, 64), torch.float32, cuda, 8)
    w = _randn((64,), torch.float32, cuda, 9)
    with pytest.raises(TypeError, match="dtype"):
        trms.rmsnorm_cuda(x.double(), w.double())
    with pytest.raises(TypeError, match="dtype"):
        trms.rmsnorm_cuda(x, w.bfloat16())
    with pytest.raises(ValueError, match="contiguous"):
        trms.rmsnorm_cuda(x.t().contiguous().t(), w)
    with pytest.raises(ValueError, match="CUDA"):
        trms.rmsnorm_cuda(x.cpu(), w.cpu())
    xb = _randn((3, 100), torch.bfloat16, cuda, 12)     # 200-byte rows
    with pytest.raises(ValueError, match="16-byte"):
        trms.rmsnorm_cuda(xb, _randn((100,), torch.bfloat16, cuda, 13))
    with pytest.raises(ValueError, match="16-byte"):     # offset by 4 bytes
        trms.rmsnorm_cuda(x.view(-1)[1:65].view(1, 64), w)
    q = _randn((1, 16, 4, 32), torch.float32, cuda, 10)
    k = _randn((1, 12, 2, 32), torch.float32, cuda, 11)
    with pytest.raises(ValueError, match="causal"):
        tflash.flash_attention_cuda(q, k, k, causal=True)
    with pytest.raises(ValueError, match="head_dim"):
        tflash.flash_attention_cuda(q[..., :16].contiguous(),
                                    q[:, :, :2, :16].contiguous(),
                                    q[:, :, :2, :16].contiguous())
    with pytest.raises(TypeError, match="dtype"):
        tflash.flash_attention_cuda(q, q.bfloat16(), q)
    with pytest.raises(ValueError, match="contiguous"):
        tflash.flash_attention_cuda(q.transpose(1, 2), q.transpose(1, 2),
                                    q.transpose(1, 2))


# ---------------------------------------------------------------------------
# Fused expert SwiGLU (row 5) and WKV6 (row 7): kernel against plain
# version on the card.  MoE: 1e-5 in float32 (the reference kernel tests'
# figure; the same float32 products summed in another order); in
# bfloat16 both sides round the same float32 value once (the tensor-core
# path keeps h as bf16 hi + lo, ~16 bits), 2e-2 elementwise and 1e-3 on
# the error's RMS over the output's RMS.  WKV6: 2e-4, the
# reference kernel tests' figure, on y and on the final state.
# ---------------------------------------------------------------------------
from repro_torch.kernels import moe_gemm as tmoe                 # noqa: E402
from repro_torch.kernels import wkv6 as twkv                     # noqa: E402


@pytest.mark.cuda
@pytest.mark.parametrize("E,C,d,ff", [
    (32, 4, 1024, 512),         # granite decode: bf16 splits ff in 8 slices
    (32, 1280, 1024, 512),      # granite prefill: one slice
    (4, 37, 1024, 1408),        # ragged C
    (4, 37, 1024, 1000),        # ragged C and ff tail (1000 = 15·64 + 40)
    (32, 300, 128, 96),         # one slice, ragged ff tail
    (3, 20, 64, 40),            # CUDA-core path in bf16 too (d % 128)
    (2, 17, 2048, 96)])         # CUDA-core path (d > 1024)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_moe_swiglu_matches_plain_version(E, C, d, ff, dtype, cuda):
    dt = getattr(torch, dtype)
    x = _randn((E, C, d), dt, cuda, 20)
    wg = (_randn((E, d, ff), torch.float32, cuda, 21) * d ** -0.5).to(dt)
    wu = (_randn((E, d, ff), torch.float32, cuda, 22) * d ** -0.5).to(dt)
    wd = (_randn((E, ff, d), torch.float32, cuda, 23) * ff ** -0.5).to(dt)
    before = tmoe.LAUNCHES["moe_swiglu"]
    y = tmoe.moe_swiglu_cuda(x, wg, wu, wd)
    torch.cuda.synchronize()
    assert tmoe.LAUNCHES["moe_swiglu"] == before + 1
    ref = tmoe.moe_swiglu_ref(x, wg, wu, wd).float()
    tol = 1e-5 if dtype == "float32" else 2e-2
    torch.testing.assert_close(y.float(), ref, atol=tol, rtol=tol)
    if dtype == "bfloat16":
        rms = lambda t: t.square().mean().sqrt().item()           # noqa: E731
        assert rms(y.float() - ref) <= 1e-3 * rms(ref)


def _wkv_inputs(B, S, H, n, dt, device):
    r, k, v = (_randn((B, S, H, n), dt, device, 30 + i) for i in range(3))
    w = torch.rand((B, S, H, n), generator=torch.Generator(
        device=device).manual_seed(33), device=device) * 0.65 + 0.3
    u = _randn((H, n), torch.float32, device, 34)
    s0 = _randn((B, H, n, n), torch.float32, device, 35) * 0.5
    return r, k, v, w, u, s0


@pytest.mark.cuda
@pytest.mark.parametrize("B,S,H,n", [(2, 100, 3, 64), (1, 33, 2, 32),
                                     (3, 1, 40, 64)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_wkv6_matches_plain_version(B, S, H, n, dtype, cuda):
    r, k, v, w, u, s0 = _wkv_inputs(B, S, H, n, getattr(torch, dtype), cuda)
    before = twkv.LAUNCHES["wkv6"]
    y, s = twkv.wkv6_cuda(r, k, v, w, u, s0)
    torch.cuda.synchronize()
    assert twkv.LAUNCHES["wkv6"] == before + 1
    ry, rs = twkv.wkv6_ref(r, k, v, w, u, s0)
    torch.testing.assert_close(y, ry, atol=2e-4, rtol=2e-4)
    torch.testing.assert_close(s, rs, atol=2e-4, rtol=2e-4)
    y0, _ = twkv.wkv6_cuda(r, k, v, w, u)                    # zero state
    torch.testing.assert_close(y0, twkv.wkv6_ref(r, k, v, w, u)[0],
                               atol=2e-4, rtol=2e-4)


@pytest.mark.cuda
def test_cuda_wkv6_state_may_alias(cuda):
    """Decode: the cache's own state is s0 and the output, one tensor."""
    r, k, v, w, u, s0 = _wkv_inputs(4, 1, 40, 64, torch.bfloat16, cuda)
    ry, rs = twkv.wkv6_ref(r, k, v, w, u, s0)
    state = s0.clone()
    y, s = twkv.wkv6(r, k, v, w, u, state, state_out=state)
    torch.cuda.synchronize()
    assert s.data_ptr() == state.data_ptr()
    torch.testing.assert_close(y, ry, atol=2e-4, rtol=2e-4)
    torch.testing.assert_close(state, rs, atol=2e-4, rtol=2e-4)


@pytest.mark.cuda
def test_cuda_moe_wkv_wrappers_reject_bad_inputs(cuda):
    x = _randn((2, 4, 64), torch.float32, cuda, 40)
    wg = _randn((2, 64, 32), torch.float32, cuda, 41)
    wd = _randn((2, 32, 64), torch.float32, cuda, 42)
    with pytest.raises(TypeError, match="dtype"):
        tmoe.moe_swiglu_cuda(x, wg.bfloat16(), wg, wd)
    with pytest.raises(ValueError, match="contiguous"):
        tmoe.moe_swiglu_cuda(x.transpose(1, 2).contiguous().transpose(1, 2),
                             wg, wg, wd)
    with pytest.raises(ValueError, match="d="):
        big = _randn((1, 2, 4096), torch.float32, cuda, 43)
        tmoe.moe_swiglu_cuda(big, big.new_zeros((1, 4096, 8)),
                             big.new_zeros((1, 4096, 8)),
                             big.new_zeros((1, 8, 4096)))
    r, k, v, w, u, s0 = _wkv_inputs(1, 4, 2, 64, torch.float32, cuda)
    with pytest.raises(TypeError, match="dtype"):
        twkv.wkv6_cuda(r, k, v, w.bfloat16(), u)
    with pytest.raises(ValueError, match="head size"):
        twkv.wkv6_cuda(*(t[..., :16].contiguous() for t in (r, k, v, w)),
                       u[:, :16].contiguous())
    with pytest.raises(ValueError, match="CUDA"):
        twkv.wkv6_cuda(r, k, v, w, u.cpu())
