"""The chunked backward forms (kernel rows 7 and 6's backward bodies) on
the CPU: the plain float32 models ``kernels/wkv6/ref.py::
wkv6_chunked_bwd_ref`` and ``kernels/rglru/ref.py::
rglru_scan_bwd_chunked_ref`` against the serial plain gradients (the
port's ``wkv6_bwd_ref``, ``rglru_scan_bwd_ref``) and against ``jax.grad``
of the JAX package's ``models/rwkv.py::wkv6_scan`` and
``models/rglru.py::rglru_scan`` (and of its RG-LRU reference kernel's
``rglru_scan_ref``), and the plans that pick the bodies.

Tolerances are those ``chip_smoke.py`` holds the float32 backward kernels
to (``GRAD_TOL``, ``GRAD_RMS_TOL``): each gradient within 1e-4 of the
reference's largest magnitude elementwise (and 1e-4 relative), and the
error's RMS within 1e-5 of the reference's RMS.  Inputs come from numpy
with a seed.  WKV6 decays are drawn as the model forms them, w =
exp(-exp(clip(x, -20, 10))), so some are exactly 0 and, in the longer
cases, some exactly 1; RG-LRU runs with a spread over (0, 1), within 1e-3
of 1 and within 1e-3 of 0.  Lengths are ragged against the 16-step
sub-chunks and the chunks (64 steps for WKV6, 128 for RG-LRU).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.kernels.rglru.ref import rglru_scan_ref as j_rglru_ref   # noqa
from repro.models import rglru as j_rglru                           # noqa
from repro.models.rwkv import wkv6_scan                             # noqa
from repro_torch.kernels.rglru import backward as gb                # noqa
from repro_torch.kernels.rglru import ref as gr                     # noqa
from repro_torch.kernels.wkv6 import backward as wb                 # noqa
from repro_torch.kernels.wkv6 import kernel as wk                   # noqa
from repro_torch.kernels.wkv6.ref import (CHUNK, SUB,               # noqa
                                          wkv6_bwd_ref,
                                          wkv6_chunked_bwd_ref)

from torch_diff import np_of                                        # noqa

GRAD_TOL = 1e-4
GRAD_RMS_TOL = 1e-5


def _assert_grad(got, want, name=""):
    got = np.asarray(np_of(got) if torch.is_tensor(got) else got,
                     np.float64)
    want = np.asarray(np_of(want) if torch.is_tensor(want) else want,
                      np.float64)
    assert got.shape == want.shape, name
    assert np.isfinite(got).all(), name
    scale = np.abs(want).max()
    np.testing.assert_allclose(got, want, rtol=GRAD_TOL,
                               atol=GRAD_TOL * scale, err_msg=name)
    if scale > 0:
        rr = np.sqrt(np.mean((got - want) ** 2) / np.mean(want ** 2))
        assert rr <= GRAD_RMS_TOL, f"{name}: error RMS ratio {rr:.3g}"


# ---------------------------------------------------------------------------
# WKV6
# ---------------------------------------------------------------------------
def _wkv_inputs(B, S, H, n, seed, state=True, decays="model"):
    rng = np.random.default_rng(seed)
    r, k, v = (rng.standard_normal((B, S, H, n)).astype(np.float32) * 0.5
               for _ in range(3))
    if decays == "model":
        # log-decays spread over the model's clamp range and past it
        x = rng.standard_normal((B, S, H, n)) * 6.0 + 1.0
        w = np.exp(-np.exp(np.clip(x, -20.0, 10.0))).astype(np.float32)
    else:
        w = np.full((B, S, H, n), decays, np.float32)
    u = rng.standard_normal((H, n)).astype(np.float32)
    dy = rng.standard_normal((B, S, H, n)).astype(np.float32)
    s0 = (rng.standard_normal((B, H, n, n)).astype(np.float32) * 0.5
          if state else None)
    ds = rng.standard_normal((B, H, n, n)).astype(np.float32) if state \
        else None
    return r, k, v, w, u, s0, dy, ds


def _t(a):
    return None if a is None else torch.from_numpy(a)


NAMES = ("dr", "dk", "dv", "dw", "du", "ds0")


@pytest.mark.parametrize("S", [1, 63, 64, 65, 200])
@pytest.mark.parametrize("state", [False, True])
def test_wkv6_chunked_bwd_model_matches_serial_gradient(S, state):
    ins = _wkv_inputs(2, S, 2, 16, seed=S + 3 * state, state=state)
    assert (ins[3] == 0).any()
    if S >= 200:
        assert (ins[3] == 1).any()
    got = wkv6_chunked_bwd_ref(*(_t(a) for a in ins))
    want = wkv6_bwd_ref(*(_t(a) for a in ins))
    assert (got[5] is None) == (not state) == (want[5] is None)
    for name, a, b in zip(NAMES, got, want):
        if b is None:
            continue
        assert a.dtype == torch.float32
        _assert_grad(a, b, name)


@pytest.mark.parametrize("S,state", [(65, True), (200, False), (130, True)])
def test_wkv6_chunked_bwd_model_matches_jax_grad(S, state):
    """Against jax.grad of the JAX package's exact per-step scan, with
    the final state's gradient when there is a state."""
    r, k, v, w, u, s0, gy, gs = _wkv_inputs(1, S, 2, 32, seed=7 + S,
                                            state=state)

    def f(r, k, v, w, u, s0):
        y, s = wkv6_scan(r, k, v, w, u, s0 if state else None)
        out = jnp.sum(y * gy)
        return out + jnp.sum(s * gs) if state else out

    want = jax.grad(f, argnums=(0, 1, 2, 3, 4, 5))(
        r, k, v, w, u, s0 if state else np.zeros((1, 2, 32, 32),
                                                   np.float32))
    got = wkv6_chunked_bwd_ref(*(_t(a) for a in (r, k, v, w, u, s0, gy,
                                                 gs)))
    for name, a, b in zip(NAMES[:5], got, want):
        _assert_grad(a, np.asarray(b), name)
    if state:
        _assert_grad(got[5], np.asarray(want[5]), "ds0")


@pytest.mark.parametrize("w_value", [0.0, 1.0])
def test_wkv6_chunked_bwd_model_where_decays_are_0_or_1(w_value):
    """w exactly 0 everywhere (the state forgets each step) or exactly 1
    (it never decays), across three chunks: finite, and the serial
    gradient's, with no log or division of w anywhere to blow up."""
    ins = _wkv_inputs(1, 150, 2, 16, seed=5, decays=w_value)
    got = wkv6_chunked_bwd_ref(*(_t(a) for a in ins))
    want = wkv6_bwd_ref(*(_t(a) for a in ins))
    for name, a, b in zip(NAMES, got, want):
        assert torch.isfinite(a).all(), name
        _assert_grad(a, b, name)


def test_wkv6_chunked_bwd_model_in_the_training_dtype():
    """bf16 r, k, v (the training path's): the gradients come back in
    bf16, from float32 arithmetic on the rounded inputs, as the serial
    plain version's do."""
    ins = list(_wkv_inputs(1, 100, 2, 16, seed=9))
    t = [_t(a) for a in ins]
    for i in range(3):
        t[i] = t[i].bfloat16()
    got = wkv6_chunked_bwd_ref(*t)
    want = wkv6_bwd_ref(*t)
    assert [g.dtype for g in got[:3]] == [torch.bfloat16] * 3
    for name, a, b in zip(NAMES[3:], got[3:], want[3:]):
        _assert_grad(a, b, name)
    for name, a, b in zip(NAMES[:3], got[:3], want[:3]):
        # one bf16 rounding of each: within a unit in the last place
        np.testing.assert_allclose(np_of(a.float()), np_of(b.float()),
                                   rtol=2 ** -7, atol=2 ** -7 *
                                   b.float().abs().max().item(),
                                   err_msg=name)


def test_wkv6_backward_body_plan_follows_the_forward():
    """The backward picks the chunked body exactly where the forward
    does (S past one chunk at head size 64), counts each body, and the
    chunked body's workspace (each chunk's start state, the gradient
    after it and the states before its sub-chunks 1-3) is under two
    thirds of the serial body's checkpoints at rwkv6-3b's training
    shape."""
    assert (CHUNK, SUB) == (64, 16)
    for S in (1, 8, 63, 64, 65, 100, 128, 777, 1024):
        for n in (32, 64):
            assert wb.body_for(S, n) == wk.body_for(S, n)
    assert wb.body_for(65, 64) == "chunked"
    assert wb.body_for(64, 64) == "serial"
    assert set(wb.LAUNCHES) == {"wkv6_bwd", "wkv6_bwd_serial",
                                "wkv6_bwd_chunked"}
    chunked = wb.workspace_bytes(4, 1024, 40, 64)
    serial = wb.workspace_bytes(4, 1024, 40, 64, "serial")
    states = 5 * 4 * 40 * 16 * 64 * 64 * 4
    assert states <= chunked < states * 1.05
    assert serial == 4 * 4 * 40 * (1024 // wb.SEGMENT) * 64 * 64
    assert 1.5 * chunked < serial


# ---------------------------------------------------------------------------
# RG-LRU
# ---------------------------------------------------------------------------
def _rglru_inputs(B, S, C, seed, kind):
    rng = np.random.default_rng(seed)
    u = rng.uniform(0.05, 1.0, (B, S, C)).astype(np.float32)
    a = {"uniform": u, "near_one": 1.0 - 1e-3 * u,
         "near_zero": 1e-3 * u}[kind].astype(np.float32)
    b = rng.standard_normal((B, S, C)).astype(np.float32)
    g = rng.standard_normal((B, S, C)).astype(np.float32)
    return a, b, g


@pytest.mark.parametrize("S", [1, 63, 64, 65, 200, 300])
@pytest.mark.parametrize("kind", ["uniform", "near_one", "near_zero"])
def test_rglru_chunked_bwd_model_matches_serial_and_jax(S, kind):
    """Against the serial reverse scan and jax.grad of the JAX package's
    reference scan; S 200 and 300 cross the 128-step chunks."""
    a, b, g = _rglru_inputs(2, S, 8, seed=S, kind=kind)
    ta, tb, tg = (torch.from_numpy(x) for x in (a, b, g))
    h = gr.rglru_scan_ref(ta, tb)
    got = gr.rglru_scan_bwd_chunked_ref(ta, h, tg)
    serial = gr.rglru_scan_bwd_ref(ta, h, tg)
    want = jax.grad(lambda a, b: jnp.sum(j_rglru_ref(a, b) * g),
                    argnums=(0, 1))(a, b)
    for name, x, y, z in zip(("da", "db"), got, serial, want):
        assert x.dtype == torch.float32
        _assert_grad(x, y, name)
        _assert_grad(x, np.asarray(z), name)


@pytest.mark.parametrize("S,chunk,sub", [(100, 32, 8), (77, 16, 4),
                                         (64, 32, 16)])
def test_rglru_chunked_bwd_model_at_other_chunk_lengths(S, chunk, sub):
    """More chunk levels at a small size: the same carries whatever the
    chunk and sub-chunk lengths."""
    a, b, g = _rglru_inputs(3, S, 5, seed=S + chunk, kind="near_one")
    ta, tb, tg = (torch.from_numpy(x) for x in (a, b, g))
    h = gr.rglru_scan_ref(ta, tb)
    got = gr.rglru_scan_bwd_chunked_ref(ta, h, tg, chunk=chunk, sub=sub)
    for name, x, y in zip(("da", "db"), got,
                          gr.rglru_scan_bwd_ref(ta, h, tg)):
        _assert_grad(x, y, name)


@pytest.mark.parametrize("kind", ["uniform", "near_one"])
def test_rglru_chunked_bwd_model_matches_the_models_scan(kind):
    """Against jax.grad of ``models/rglru.py::rglru_scan`` (log-decays and
    gated inputs, b = sqrt(1 - a²) x): the model's gradients follow from
    (da, db) as d log_a = a da + x db dsqrt(1 - a²)/dlog a and dx = sqrt(1
    - a²) db, over two 128-step chunks and a ragged end."""
    a, _, g = _rglru_inputs(2, 300, 8, seed=21, kind=kind)
    rng = np.random.default_rng(22)
    x = rng.standard_normal(a.shape).astype(np.float32)
    log_a = np.log(a).astype(np.float32)

    def f(log_a, x):
        return jnp.sum(j_rglru.rglru_scan(log_a, x) * g)

    want_la, want_x = jax.grad(f, argnums=(0, 1))(log_a, x)
    a_j = jnp.exp(log_a)
    beta = jnp.sqrt(jnp.maximum(1.0 - jnp.exp(2.0 * log_a), 1e-12))
    b = np.array(beta * x)
    ta = torch.from_numpy(np.array(a_j))
    h = gr.rglru_scan_ref(ta, torch.from_numpy(b))
    da, db = gr.rglru_scan_bwd_chunked_ref(ta, h, torch.from_numpy(g))
    da, db = np_of(da).astype(np.float64), np_of(db).astype(np.float64)
    a64, beta64 = np.asarray(a_j, np.float64), np.asarray(beta, np.float64)
    dbeta = -a64 ** 2 / beta64
    _assert_grad(beta64 * db, np.asarray(want_x), "dx")
    _assert_grad(a64 * da + x * db * dbeta, np.asarray(want_la), "dlog_a")


def test_rglru_backward_body_plan():
    """One chunk is 128 steps of 8 warps x 16; one count; the workspace is
    a carry a (chunk, batch, channel) and a flag a (chunk, batch, 32
    channels) plus the ticket."""
    assert (gr.CHUNK, gr.SUB) == (128, 16) and gr.CHUNK % gr.SUB == 0
    assert set(gb.LAUNCHES) == {"rglru_scan_bwd"}
    nc = 2560 // 128
    assert gb.workspace_bytes(2, 2560, 4096) == \
        4 * (nc * 2 * 4096 + nc * 2 * 128 + 1)
    assert gb.workspace_bytes(3, 129, 100) == 4 * (2 * 3 * 100 + 2 * 3 * 4 + 1)
