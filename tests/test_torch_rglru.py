"""The port's RG-LRU (kernel row 6 and ``models/rglru.py``), its
sliding-window decode attention and flash attention at recurrentgemma's
head_dim 256, against the JAX package on the same numpy inputs: the
plain ``rglru_scan`` against ``rglru_scan_tpu`` in interpret mode and
``rglru_scan_ref``; the RG-LRU block's functions against
``repro/models/rglru.py``; ``decode_attention(window=...)`` over a ring
cache; the flash-attention contract at hd 256 (MQA, windowed) against
``flash_attention_tpu`` in interpret mode.

Tolerances, with their reasons: the scan 1e-5 (the reference kernel
tests' figure: the same float32 recurrence, the TPU kernel's log-depth
chunk scan summing in another order); the block's functions in float32
rtol 1e-4 / atol 1e-5 (XLA's and ATen's exp, log, sigmoid and tanh
differ by ulps, and the products sum in another order); attention 2e-5
(the reference kernel tests' figure) and decode attention 1e-5."""
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import get_config as j_get_config                 # noqa
from repro.configs import reduced as j_reduced                       # noqa
from repro.kernels.flash_attention.kernel import flash_attention_tpu  # noqa
from repro.kernels.rglru import rglru_scan_ref as j_scan_ref         # noqa
from repro.kernels.rglru import rglru_scan_tpu                       # noqa
from repro.models import attention as jattn                          # noqa
from repro.models import rglru as jrglru                             # noqa
from repro.runtime.meshenv import CPU_ENV                            # noqa
from repro_torch.configs import get_config, reduced                  # noqa
from repro_torch.kernels import rglru as tscan                       # noqa
from repro_torch.kernels.flash_attention import ops as tflash        # noqa
from repro_torch.models import attention as tattn                    # noqa
from repro_torch.models import rglru as trglru                       # noqa
from repro_torch.models import transformer as ttfm                   # noqa

from torch_diff import np_of                                         # noqa

RTOL, ATOL = 1e-4, 1e-5
ARCH = "recurrentgemma-9b"


def _close(a, b, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(np_of(a), np.asarray(b), rtol=rtol,
                               atol=atol)


def _t(a):
    return torch.from_numpy(np.asarray(a, np.float32))


# ---------------------------------------------------------------------------
# the scan (row 6)
# ---------------------------------------------------------------------------
def _scan_inputs(seed, B, S, C):
    rng = np.random.default_rng(seed)
    a = rng.uniform(0.5, 0.999, (B, S, C)).astype(np.float32)
    b = rng.standard_normal((B, S, C)).astype(np.float32) * 0.3
    return a, b


@pytest.mark.parametrize("B,S,C", [
    (2, 40, 256),       # S not a multiple of the 16-step chunk
    (1, 64, 200),       # ragged C against a 128-channel block
    (3, 5, 7),          # S below one chunk, C below one block
])
def test_rglru_scan_matches_pallas_interpret_and_ref(B, S, C):
    a, b = _scan_inputs(B * S + C, B, S, C)
    h = tscan.rglru_scan(_t(a), _t(b))
    assert h.dtype == torch.float32 and tuple(h.shape) == (B, S, C)
    pal = rglru_scan_tpu(jnp.asarray(a), jnp.asarray(b), chunk=16,
                         channel_block=128, interpret=True)
    _close(h, pal, rtol=1e-5, atol=1e-5)
    _close(h, j_scan_ref(jnp.asarray(a), jnp.asarray(b)), rtol=1e-5,
           atol=1e-5)
    # h_t = a_t h_{t-1} + b_t from zero, so h_0 = b_0
    np.testing.assert_array_equal(np_of(h[:, 0]), b[:, 0])


def test_rglru_scan_refuses_what_it_does_not_take():
    """Mismatched shapes on either path; a CPU tensor at the CUDA
    wrapper, before any build, and without counting a launch."""
    a = torch.zeros((2, 3, 4))
    before = tscan.LAUNCHES["rglru_scan"]
    with pytest.raises(ValueError, match="rglru_scan"):
        tscan.rglru_scan(a, torch.zeros((2, 3, 5)))
    with pytest.raises(ValueError, match="CUDA"):
        tscan.rglru_scan_cuda(a, a)
    assert tscan.LAUNCHES["rglru_scan"] == before


# ---------------------------------------------------------------------------
# the RG-LRU block's functions (models/rglru.py), float32
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def block():
    """(reference cfg, port cfg, the same block parameters in both)."""
    import dataclasses
    import jax
    jcfg = dataclasses.replace(j_reduced(j_get_config(ARCH), layers=3),
                               dtype="float32")
    tcfg = dataclasses.replace(reduced(get_config(ARCH), layers=3),
                               dtype="float32")
    jp, _ = jrglru.init_rglru(jcfg, jax.random.PRNGKey(3), CPU_ENV)
    rng = np.random.default_rng(4)
    npp = {k: np.asarray(v) for k, v in jp.items()}
    # a wider spread of Λ than the init's, so r_gate moves log a
    npp["a_param"] = rng.standard_normal(npp["a_param"].shape).astype(
        np.float32)
    return (jcfg, {k: jnp.asarray(v) for k, v in npp.items()}, tcfg,
            {k: torch.from_numpy(v.copy()) for k, v in npp.items()})


def _state(seed, cfg, B):
    rng = np.random.default_rng(seed)
    return {"h": rng.standard_normal((B, cfg.d_rnn)).astype(np.float32),
            "conv": rng.standard_normal((B, cfg.conv_width - 1, cfg.d_rnn))
            .astype(np.float32)}


def test_init_rglru_matches_reference_layout():
    import jax
    jcfg = j_reduced(j_get_config(ARCH), layers=3)
    tcfg = reduced(get_config(ARCH), layers=3)
    jp, _ = jrglru.init_rglru(jcfg, jax.random.PRNGKey(0), CPU_ENV)
    tp = trglru.init_rglru(tcfg, torch.Generator().manual_seed(0), "cpu")
    assert set(tp) == set(jp)
    for k in jp:
        assert tuple(tp[k].shape) == tuple(jp[k].shape), k
        assert str(tp[k].dtype).split(".")[-1] == str(jp[k].dtype), k
    # float32 log and expm1 of XLA and ATen differ by a few ulps
    _close(tp["a_param"], jp["a_param"], rtol=1e-5, atol=0)
    st = trglru.init_rglru_state(tcfg, 2, "cpu")
    jst = jrglru.init_rglru_state(jcfg, 2)
    for k in jst:
        assert tuple(st[k].shape) == tuple(jst[k].shape)
        assert str(st[k].dtype).split(".")[-1] == str(jst[k].dtype)


def test_gates_and_model_scan_match_reference(block):
    jcfg, jp, tcfg, tp = block
    rng = np.random.default_rng(5)
    xc = rng.standard_normal((2, 9, tcfg.d_rnn)).astype(np.float32)
    la, gx = trglru._gates(tp, tcfg.num_heads, _t(xc))
    jla, jgx = jrglru._gates(jp, jcfg.num_heads, jnp.asarray(xc))
    _close(la, jla)
    _close(gx, jgx)
    h0 = rng.standard_normal((2, tcfg.d_rnn)).astype(np.float32)
    for h0_t, h0_j in ((None, None), (_t(h0), jnp.asarray(h0))):
        h = trglru.rglru_scan(la.clone(), gx.clone(), h0_t)
        _close(h, jrglru.rglru_scan(jla, jgx, h0_j))


@pytest.mark.parametrize("S", [1, 2, 9])         # 1, 2 < K - 1 = 3
@pytest.mark.parametrize("with_state", [False, True])
def test_causal_conv_matches_reference(block, S, with_state):
    jcfg, jp, tcfg, tp = block
    rng = np.random.default_rng(S)
    x = rng.standard_normal((2, S, tcfg.d_rnn)).astype(np.float32)
    st = _state(6, tcfg, 2)["conv"] if with_state else None
    out = trglru._causal_conv(tp["conv_w"], _t(x),
                              None if st is None else _t(st))
    ref = jrglru._causal_conv(jp["conv_w"], jnp.asarray(x),
                              None if st is None else jnp.asarray(st))
    _close(out, ref, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("S", [1, 2, 11])
@pytest.mark.parametrize("with_state", [False, True])
def test_apply_rglru_seq_matches_reference(block, S, with_state):
    jcfg, jp, tcfg, tp = block
    x = np.random.default_rng(10 + S).standard_normal(
        (2, S, tcfg.d_model)).astype(np.float32)
    st = _state(7, tcfg, 2) if with_state else None
    out, new = trglru.apply_rglru_seq(
        tcfg, tp, _t(x), None if st is None else
        {k: _t(v) for k, v in st.items()})
    jout, jnew = jrglru.apply_rglru_seq(
        jcfg, jp, CPU_ENV, jnp.asarray(x), None if st is None else
        {k: jnp.asarray(v) for k, v in st.items()})
    _close(out, jout)
    for k in ("h", "conv"):
        assert tuple(new[k].shape) == tuple(jnew[k].shape)
        _close(new[k], jnew[k])


def test_apply_rglru_decode_matches_reference_in_place(block):
    jcfg, jp, tcfg, tp = block
    rng = np.random.default_rng(12)
    st = _state(8, tcfg, 3)
    # copies: the port writes its state in place, and jnp.asarray may
    # share a numpy buffer on the CPU
    tst = {k: torch.from_numpy(v.copy()) for k, v in st.items()}
    jst = {k: jnp.asarray(v.copy()) for k, v in st.items()}
    for step in range(3):
        x = rng.standard_normal((3, 1, tcfg.d_model)).astype(np.float32)
        out, new = trglru.apply_rglru_decode(tcfg, tp, _t(x), tst)
        jout, jst = jrglru.apply_rglru_decode(jcfg, jp, CPU_ENV,
                                              jnp.asarray(x), jst)
        assert new is tst                        # decode updates in place
        _close(out, jout)
        for k in ("h", "conv"):
            _close(tst[k], jst[k])


def test_decode_continues_the_sequence(block):
    """Sequence mode over S tokens equals sequence mode over S-1 tokens
    then one decode step from its state (the conv window flip)."""
    _, _, tcfg, tp = block
    x = _t(np.random.default_rng(13).standard_normal((2, 7, tcfg.d_model)))
    full, st_full = trglru.apply_rglru_seq(tcfg, tp, x)
    _, st = trglru.apply_rglru_seq(tcfg, tp, x[:, :-1])
    last, st = trglru.apply_rglru_decode(tcfg, tp, x[:, -1:], st)
    _close(last, np_of(full[:, -1:]))
    for k in ("h", "conv"):
        _close(st[k], np_of(st_full[k]))


# ---------------------------------------------------------------------------
# sliding-window decode attention over a ring cache
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("L,window,pos", [
    (8, 8, 5),                      # ring not yet full
    (8, 8, 21),                     # ring wrapped
    (8, 8, [3, 8, 30]),             # per-sequence positions
    (5, 8, [0, 2, 4]),              # ring shorter than the window
    (8, 4, [6, 13, 2]),             # window shorter than the ring
])
def test_decode_attention_window_matches_reference(L, window, pos):
    rng = np.random.default_rng(L + window)
    B = 3
    q, k, v = (rng.standard_normal(s).astype(np.float32) for s in
               ((B, 1, 4, 16), (B, L, 1, 16), (B, L, 1, 16)))
    p = np.asarray(pos)
    out = tattn.decode_attention(_t(q), _t(k), _t(v), torch.as_tensor(p),
                                 window=window)
    ref = jattn.decode_attention(jnp.asarray(q), jnp.asarray(k),
                                 jnp.asarray(v), jnp.asarray(p),
                                 window=window)
    _close(out, ref, rtol=1e-5, atol=1e-5)


def test_ring_layout_matches_reference():
    from repro.models.transformer import _to_ring as j_to_ring
    x = np.arange(2 * 13 * 3, dtype=np.float32).reshape(2, 13, 3)
    for L in (4, 8, 13, 16):
        np.testing.assert_array_equal(
            np_of(ttfm._to_ring(_t(x), L)),
            np.asarray(j_to_ring(jnp.asarray(x), L)))


# ---------------------------------------------------------------------------
# flash attention at head_dim 256 (recurrentgemma: MQA, windowed)
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("S,window", [(96, 32), (80, 0)])
def test_flash_attention_hd256_mqa_matches_pallas_interpret(S, window):
    rng = np.random.default_rng(S + window)
    q = rng.standard_normal((1, 4, S, 256)).astype(np.float32)
    k, v = (rng.standard_normal((1, 1, S, 256)).astype(np.float32)
            for _ in range(2))
    pal = flash_attention_tpu(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                              causal=True, window=window, q_block=32,
                              kv_block=32, interpret=True)
    out = tflash.flash_attention(*(_t(a).transpose(1, 2).contiguous()
                                   for a in (q, k, v)),
                                 causal=True, window=window)
    _close(out.transpose(1, 2), pal, rtol=2e-5, atol=2e-5)
