"""The chunked WKV6 form (kernel row 7's prefill body) on the CPU: its
plain float32 model ``kernels/wkv6/ref.py::wkv6_chunked_ref`` against
the serial recurrence (the port's ``wkv6_ref``) and against the JAX
package's ``wkv6_ref``, ``wkv6_scan`` and Pallas ``wkv6_tpu`` (interpret
mode), and the plan that picks the body.

Tolerances are those ``chip_smoke.py`` holds the CUDA kernel to:
``WKV_TOL`` = 2e-4 elementwise on y and the final state (the reference
kernel tests' figure), and the error's RMS within ``WKV_RMS_TOL`` = 1e-6
of the result's RMS (the serial float32 recurrence itself reads about
1.2e-7 against float64).  Inputs come from numpy with a seed.  Decays
are drawn as the model forms them, w = exp(-exp(clamp(x, -20, 10))), so
some are exactly 0 (and, in the longer cases, some round to 1); sequence
lengths are ragged (not multiples of the 16-step sub-chunk or the 64-step
chunk).
"""
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.kernels.wkv6.kernel import wkv6_tpu                       # noqa
from repro.kernels.wkv6.ref import wkv6_ref as j_wkv6_ref            # noqa
from repro.models.rwkv import wkv6_scan                              # noqa
from repro_torch.kernels.wkv6 import kernel as wk                    # noqa
from repro_torch.kernels.wkv6.ref import (CHUNK, SUB,                # noqa
                                          wkv6_chunked_ref, wkv6_ref)

from torch_diff import np_of                                         # noqa

WKV_TOL = 2e-4
WKV_RMS_TOL = 1e-6


def _inputs(B, S, H, n, seed, decays="model", state=True):
    rng = np.random.default_rng(seed)
    r, k, v = (rng.standard_normal((B, S, H, n)).astype(np.float32)
               for _ in range(3))
    if decays == "model":
        # log-decays spread over the model's clamp range and past it
        x = rng.standard_normal((B, S, H, n)) * 6.0 + 1.0
        w = np.exp(-np.exp(np.clip(x, -20.0, 10.0))).astype(np.float32)
    else:
        w = rng.uniform(0.3, 0.95, (B, S, H, n)).astype(np.float32)
    u = rng.standard_normal((H, n)).astype(np.float32)
    s0 = (rng.standard_normal((B, H, n, n)).astype(np.float32) * 0.5
          if state else None)
    return r, k, v, w, u, s0


def _t(a):
    return None if a is None else torch.from_numpy(a)


def _rms_ratio(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.sqrt(np.mean((got - want) ** 2) / np.mean(want ** 2))


def _assert_close(got, want):
    np.testing.assert_allclose(got, want, atol=WKV_TOL, rtol=WKV_TOL)
    assert _rms_ratio(got, want) <= WKV_RMS_TOL


@pytest.mark.parametrize("B,S,H,n,decays,state", [
    (1, 256, 2, 64, "model", True),      # whole chunks
    (1, 777, 1, 64, "model", True),      # ragged: 12 chunks + 9 steps
    (2, 77, 2, 32, "model", False),      # ragged, zero state, n 32
    (2, 130, 2, 64, "uniform", True),    # chip_smoke's decay range
    (1, 5, 2, 16, "model", True)])       # shorter than one sub-chunk
def test_chunked_model_matches_serial_recurrence(B, S, H, n, decays,
                                                 state):
    ins = _inputs(B, S, H, n, seed=S + n, decays=decays, state=state)
    if decays == "model":
        assert (ins[3] == 0).any()
    y, s = wkv6_chunked_ref(*(_t(a) for a in ins))
    want_y, want_s = wkv6_ref(*(_t(a) for a in ins))
    assert y.dtype == s.dtype == torch.float32
    assert tuple(y.shape) == (B, S, H, n) and tuple(s.shape) == (B, H, n, n)
    _assert_close(np_of(y), np_of(want_y))
    _assert_close(np_of(s), np_of(want_s))


@pytest.mark.parametrize("S", [100, 200])
def test_chunked_model_matches_jax_scan_from_a_state(S):
    ins = _inputs(2, S, 2, 32, seed=7 + S)
    y, s = wkv6_chunked_ref(*(_t(a) for a in ins))
    jy, js = wkv6_scan(*(jnp.asarray(a) for a in ins))
    _assert_close(np_of(y), np.asarray(jy))
    _assert_close(np_of(s), np.asarray(js))


@pytest.mark.parametrize("S,chunk", [(150, 128), (97, 32)])
def test_chunked_model_matches_jax_reference_and_pallas(S, chunk):
    """From a zero state, in the reference kernel's head-major layout; the
    Pallas kernel in interpret mode with its own chunk length."""
    r, k, v, w, u, _ = _inputs(1, S, 2, 32, seed=11, state=False)
    y, _ = wkv6_chunked_ref(*(_t(a) for a in (r, k, v, w, u)))
    hm = [jnp.asarray(a.transpose(0, 2, 1, 3)) for a in (r, k, v, w)]
    want = np.asarray(j_wkv6_ref(*hm, jnp.asarray(u))).transpose(0, 2, 1, 3)
    pallas = np.asarray(wkv6_tpu(*hm, jnp.asarray(u), chunk=chunk,
                                 interpret=True)).transpose(0, 2, 1, 3)
    _assert_close(np_of(y), want)
    _assert_close(np_of(y), pallas)


def test_chunked_model_is_exact_where_decays_vanish():
    """w = 0 everywhere: the state forgets each step, so y_t reads only
    v_t (r_t·(u ⊙ k_t)) and r_t·k_{t-1} v_{t-1}; no NaN or inf from a
    log of 0."""
    r, k, v, _, u, s0 = _inputs(1, 70, 1, 16, seed=13)
    w = np.zeros_like(r)
    y, s = wkv6_chunked_ref(*(_t(a) for a in (r, k, v, w, u, s0)))
    want_y, want_s = wkv6_ref(*(_t(a) for a in (r, k, v, w, u, s0)))
    assert torch.isfinite(y).all() and torch.isfinite(s).all()
    _assert_close(np_of(y), np_of(want_y))
    np.testing.assert_allclose(np_of(s)[0, 0],
                               np.outer(k[0, -1, 0], v[0, -1, 0]),
                               rtol=1e-6, atol=1e-6)


def test_chunk_lengths_and_body_plan():
    """The kernel's chunk and sub-chunk (csrc/wkv6.cu) are those of the
    model; up to one chunk runs the serial body (decode at S 1), longer
    sequences at head size 64 the chunked one, other head sizes the
    serial one."""
    assert (CHUNK, SUB) == (64, 16) and CHUNK % SUB == 0
    assert wk.body_for(1, 64) == "serial"
    assert wk.body_for(CHUNK, 64) == "serial"
    for S in (CHUNK + 1, 128, 777, 1024):
        assert wk.body_for(S, 64) == "chunked"
        assert wk.body_for(S, 32) == "serial"
    assert set(wk.LAUNCHES) == {"wkv6", "wkv6_serial", "wkv6_chunked"}
    assert wk.BODIES == {"serial": 0, "chunked": 1}


def test_chunked_and_serial_agree_across_a_split_sequence():
    """Two chunked calls with the state carried equal one call: what
    decode after a chunked prefill relies on."""
    r, k, v, w, u, s0 = (_t(a) for a in _inputs(1, 203, 2, 32, seed=17))
    y, s = wkv6_chunked_ref(r, k, v, w, u, s0)
    y1, s1 = wkv6_chunked_ref(r[:, :130], k[:, :130], v[:, :130],
                              w[:, :130], u, s0)
    y2, s2 = wkv6_ref(r[:, 130:], k[:, 130:], v[:, 130:], w[:, 130:], u, s1)
    _assert_close(np_of(torch.cat([y1, y2], dim=1)), np_of(y))
    _assert_close(np_of(s2), np_of(s))
