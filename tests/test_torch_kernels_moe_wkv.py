"""The port's fused expert SwiGLU (kernel row 5) and WKV6 recurrence
(kernel row 7) on the CPU, against the JAX package: their plain PyTorch
versions (what ``ops`` runs for a CPU tensor and what the CUDA kernels
are held against on the card) and the per-head group norm.

Inputs are drawn with numpy from a seed and go through both packages.
Tolerances, with their reasons:

* MoE SwiGLU, float32: 1e-5, the reference kernel tests' figure
  (tests/test_kernels.py); both sides compute the same float32 products,
  summed in another order.  bfloat16 in, bfloat16 out: one bf16 rounding
  of the same float32 value, 1e-2 (values are below 2).
* WKV6, float32: 2e-5 on y and on the state.  The same per-step float32
  ops as ``wkv6_scan``, whose einsum sums in another order; the
  reference's own kernel bound is 2e-4 (tests/test_kernels.py), which
  the Pallas kernel (run in interpret mode) is held to here too.
* Group norm: 1e-6 in float32 (mean and variance in another order); one
  bf16 rounding in bfloat16.
"""
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.kernels.moe_gemm.kernel import moe_swiglu_tpu             # noqa
from repro.kernels.moe_gemm.ref import moe_swiglu_ref as j_moe_ref   # noqa
from repro.kernels.wkv6.kernel import wkv6_tpu                       # noqa
from repro.kernels.wkv6.ref import wkv6_ref as j_wkv6_ref            # noqa
from repro.models import layers as j_layers                          # noqa
from repro.models.rwkv import wkv6_scan                              # noqa
from repro_torch.kernels.moe_gemm import ops as t_moe                # noqa
from repro_torch.kernels.moe_gemm.ref import moe_swiglu_ref          # noqa
from repro_torch.kernels.wkv6 import ops as t_wkv                    # noqa
from repro_torch.kernels.wkv6.ref import wkv6_ref                    # noqa
from repro_torch.models import layers as t_layers                    # noqa

from torch_diff import np_of                                         # noqa

MOE_TOL = 1e-5
WKV_TOL = 2e-5
WKV_PALLAS_TOL = 2e-4


def _moe_inputs(E, C, d, ff, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((E, C, d)).astype(np.float32) * 0.5
    wg, wu = (rng.standard_normal((E, d, ff)).astype(np.float32) * 0.1
              for _ in range(2))
    wd = rng.standard_normal((E, ff, d)).astype(np.float32) * 0.1
    return x, wg, wu, wd


# ---------------------------------------------------------------------------
# fused expert SwiGLU
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("E,C,d,ff,c_block,ff_block", [
    (2, 32, 16, 32, 128, 256),
    (4, 64, 32, 64, 128, 256),
    (3, 20, 16, 40, 8, 16),          # ragged C and ragged ff tail
    (4, 4, 64, 128, 128, 256),       # decode-sized capacity
])
def test_moe_swiglu_matches_reference_and_pallas(E, C, d, ff, c_block,
                                                 ff_block):
    ins = _moe_inputs(E, C, d, ff)
    got = np_of(t_moe.moe_swiglu(*(torch.from_numpy(a) for a in ins)))
    want = np.asarray(j_moe_ref(*(jnp.asarray(a) for a in ins)))
    pallas = np.asarray(moe_swiglu_tpu(*(jnp.asarray(a) for a in ins),
                                       c_block=c_block, ff_block=ff_block,
                                       interpret=True))
    np.testing.assert_allclose(got, want, atol=MOE_TOL, rtol=MOE_TOL)
    np.testing.assert_allclose(got, pallas, atol=MOE_TOL, rtol=MOE_TOL)


def test_moe_swiglu_bf16_rounds_once():
    ins = _moe_inputs(2, 12, 32, 48, seed=1)
    tb = [torch.from_numpy(a).to(torch.bfloat16) for a in ins]
    got = t_moe.moe_swiglu(*tb)
    assert got.dtype == torch.bfloat16
    want = np.asarray(j_moe_ref(*(jnp.asarray(np_of(t.float()),
                                              jnp.bfloat16) for t in tb)),
                      np.float32)
    np.testing.assert_allclose(np_of(got.float()), want, atol=1e-2,
                               rtol=1e-2)
    torch.testing.assert_close(got, moe_swiglu_ref(*tb), atol=0, rtol=0)


@pytest.mark.parametrize("bad", ["rank", "wg", "wd"])
def test_moe_swiglu_refuses_bad_shapes(bad):
    x, wg, wu, wd = (torch.from_numpy(a) for a in _moe_inputs(2, 4, 8, 16))
    if bad == "rank":
        x = x[0]
    elif bad == "wg":
        wg = wg[:, :4]
    else:
        wd = wd.transpose(1, 2)
    with pytest.raises(ValueError, match="moe_swiglu"):
        t_moe.moe_swiglu(x, wg, wu, wd)


# ---------------------------------------------------------------------------
# WKV6
# ---------------------------------------------------------------------------
def _wkv_inputs(B, S, H, n, seed=0, state=True):
    rng = np.random.default_rng(seed)
    r, k, v = (rng.standard_normal((B, S, H, n)).astype(np.float32)
               for _ in range(3))
    w = rng.uniform(0.3, 0.95, (B, S, H, n)).astype(np.float32)
    u = rng.standard_normal((H, n)).astype(np.float32)
    s0 = (rng.standard_normal((B, H, n, n)).astype(np.float32) * 0.5
          if state else None)
    return r, k, v, w, u, s0


def _t(a):
    return None if a is None else torch.from_numpy(a)


@pytest.mark.parametrize("B,S,H,n,state", [
    (1, 32, 1, 16, False), (2, 24, 2, 16, True), (1, 17, 2, 32, True),
    (3, 1, 2, 8, True)])
def test_wkv6_matches_model_scan(B, S, H, n, state):
    ins = _wkv_inputs(B, S, H, n, state=state)
    y, s = t_wkv.wkv6(*(_t(a) for a in ins))
    jy, js = wkv6_scan(*(None if a is None else jnp.asarray(a)
                         for a in ins))
    assert y.dtype == s.dtype == torch.float32
    np.testing.assert_allclose(np_of(y), np.asarray(jy), atol=WKV_TOL,
                               rtol=WKV_TOL)
    np.testing.assert_allclose(np_of(s), np.asarray(js), atol=WKV_TOL,
                               rtol=WKV_TOL)


def test_wkv6_two_halves_with_carried_state_equal_one_run():
    r, k, v, w, u, s0 = (_t(a) for a in _wkv_inputs(2, 30, 2, 16, seed=3))
    y, s = wkv6_ref(r, k, v, w, u, s0)
    y1, s1 = wkv6_ref(r[:, :13], k[:, :13], v[:, :13], w[:, :13], u, s0)
    y2, s2 = wkv6_ref(r[:, 13:], k[:, 13:], v[:, 13:], w[:, 13:], u, s1)
    torch.testing.assert_close(torch.cat([y1, y2], dim=1), y, atol=0,
                               rtol=0)
    torch.testing.assert_close(s2, s, atol=0, rtol=0)


@pytest.mark.parametrize("B,H,S,n,chunk", [(1, 1, 32, 16, 16),
                                           (2, 2, 48, 32, 16)])
def test_wkv6_matches_head_major_reference_and_pallas(B, H, S, n, chunk):
    """From a zero state, the model layout transposed to the reference
    kernel's head-major (B, H, S, n) one."""
    r, k, v, w, u, _ = _wkv_inputs(B, S, H, n, seed=4, state=False)
    y, _ = t_wkv.wkv6(*(_t(a) for a in (r, k, v, w, u)))
    hm = [jnp.asarray(a.transpose(0, 2, 1, 3)) for a in (r, k, v, w)]
    want = np.asarray(j_wkv6_ref(*hm, jnp.asarray(u))).transpose(0, 2, 1, 3)
    pallas = np.asarray(wkv6_tpu(*hm, jnp.asarray(u), chunk=chunk,
                                 interpret=True)).transpose(0, 2, 1, 3)
    np.testing.assert_allclose(np_of(y), want, atol=WKV_TOL, rtol=WKV_TOL)
    np.testing.assert_allclose(np_of(y), pallas, atol=WKV_PALLAS_TOL,
                               rtol=WKV_PALLAS_TOL)


def test_wkv6_state_out_may_alias_s0():
    """Decode passes the cache's own state as s0 and as the output: the
    result equals a run into a fresh tensor, and lands in that tensor."""
    r, k, v, w, u, s0 = (_t(a) for a in _wkv_inputs(3, 1, 2, 16, seed=5))
    want_y, want_s = t_wkv.wkv6(r, k, v, w, u, s0.clone())
    state = s0.clone()
    y, s = t_wkv.wkv6(r, k, v, w, u, state, state_out=state)
    assert s is state
    torch.testing.assert_close(y, want_y, atol=0, rtol=0)
    torch.testing.assert_close(state, want_s, atol=0, rtol=0)


def test_wkv6_bf16_inputs_are_read_as_float32():
    r, k, v, w, u, s0 = (_t(a) for a in _wkv_inputs(1, 9, 2, 16, seed=6))
    rb, kb, vb = (t.to(torch.bfloat16) for t in (r, k, v))
    y, s = t_wkv.wkv6(rb, kb, vb, w, u, s0)
    y32, s32 = t_wkv.wkv6(rb.float(), kb.float(), vb.float(), w, u, s0)
    assert y.dtype == torch.float32
    torch.testing.assert_close(y, y32, atol=0, rtol=0)
    torch.testing.assert_close(s, s32, atol=0, rtol=0)


@pytest.mark.parametrize("bad", ["k", "u", "s0"])
def test_wkv6_refuses_bad_shapes(bad):
    r, k, v, w, u, s0 = (_t(a) for a in _wkv_inputs(1, 4, 2, 8))
    if bad == "k":
        k = k[:, :3]
    elif bad == "u":
        u = u[:1]
    else:
        s0 = s0[:, :, :4]
    with pytest.raises(ValueError, match="wkv6"):
        t_wkv.wkv6(r, k, v, w, u, s0)


# ---------------------------------------------------------------------------
# group norm over heads (RWKV-6 ln_x)
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_group_norm_heads_matches_reference(dtype):
    rng = np.random.default_rng(7)
    x = rng.standard_normal((2, 5, 3, 16)).astype(np.float32) * 3 + 1
    w = rng.standard_normal((3, 16)).astype(np.float32)
    tdt = getattr(torch, dtype)
    got = t_layers.group_norm_heads(torch.from_numpy(x).to(tdt),
                                    torch.from_numpy(w))
    assert got.dtype == tdt
    want = j_layers.group_norm_heads(
        jnp.asarray(np_of(torch.from_numpy(x).to(tdt).float()),
                    getattr(jnp, dtype)), jnp.asarray(w))
    tol = 1e-6 if dtype == "float32" else 2e-2
    np.testing.assert_allclose(np_of(got.float()),
                               np.asarray(want, np.float32), atol=tol,
                               rtol=tol)
