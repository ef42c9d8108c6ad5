"""The port's int8 KV cache against the JAX package's: ``quantize_kv``,
decode attention with the scales folded in, and prefill caches and
decode logits for a global architecture (starcoder2-3b, reduced) and for
gemma3's sliding-window ring (reduced: window 8, prompts of 13 tokens, so
the ring wraps, at cache lengths at or above the window), at a scalar
position and at per-sequence (B,) positions.  Every cache has room for
the decoded row: at a scalar position past a full global cache the
reference's ``dynamic_update_slice`` clamps the write onto the last row,
while its (B,) scatter and the port drop it (ROADMAP §3).

The same numpy inputs and weights go through both packages.  Tolerances:

* ``quantize_kv`` on the same input: codes and scales equal, bit for
  bit (one float32 division and round-half-to-even each).
* prefill caches: codes within ±1 on at most 0.1% of elements (a k or v
  that differs by an ulp between the packages may cross a rounding
  tie), scales to rtol 1e-5.
* decode logits from the same int8 caches (the reference's, carried
  across): rtol 1e-4 / atol 1e-5, as for the float32 model; greedy
  tokens equal.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.models import attention as jattn                         # noqa
from repro.models import transformer as jtfm                        # noqa
from repro.runtime.meshenv import CPU_ENV                           # noqa
from repro_torch import interop                                     # noqa
from repro_torch.models import attention as tattn                   # noqa
from repro_torch.models import transformer as ttfm                  # noqa

from torch_diff import model_pair, np_of                            # noqa

B, S = 2, 13


def _bf16(a):
    return torch.from_numpy(np.asarray(a, np.float32)).to(torch.bfloat16)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantize_kv_matches_reference(dtype):
    """Random rows, an all-zero row (the 1e-8 floor) and rows built to
    put codes on exact .5 ties, which both round half to even."""
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 5, 3, 16)).astype(np.float32) * 3.0
    x[0, 0, 0] = 0.0
    x[1, 2, 1] = np.arange(16) - 7.5          # max 7.5: codes at k + .5
    x[1, 3, 2, :4] = [127.0, 0.5, 1.5, -2.5]  # scale 1: ties at 0, 2, -2
    x[1, 3, 2, 4:] = 0.0
    if dtype == "bfloat16":
        xt = _bf16(x)
        xj = jnp.asarray(x, jnp.bfloat16)
    else:
        xt, xj = torch.from_numpy(x), jnp.asarray(x)
    qt, st = tattn.quantize_kv(xt)
    qj, sj = jattn.quantize_kv(xj)
    assert qt.dtype == torch.int8 and st.dtype == torch.float32
    np.testing.assert_array_equal(qt.numpy(), np.asarray(qj))
    np.testing.assert_array_equal(st.numpy(), np.asarray(sj))
    assert st[0, 0, 0].item() == np.float32(1e-8)
    assert qt[1, 3, 2, :4].tolist() == [127, 0, 2, -2]


@pytest.mark.parametrize("q_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("window", [0, 6])
def test_decode_attention_with_scales_matches_reference(q_dtype, window):
    """The same int8 codes and scales, per-sequence positions past the
    ring (window 6 over 8 slots): the scales fold into scores and
    probabilities."""
    rng = np.random.default_rng(1)
    Bq, Lc, Hkv, rep, hd = 2, 8, 2, 3, 16
    q = rng.standard_normal((Bq, 1, Hkv * rep, hd)).astype(np.float32)
    kv = rng.standard_normal((2, Bq, Lc, Hkv, hd)).astype(np.float32)
    (kc, ks), (vc, vs) = (jattn.quantize_kv(jnp.asarray(t)) for t in kv)
    pos = np.array([5, 11])
    jq = jnp.asarray(q, jnp.bfloat16 if q_dtype == "bfloat16" else
                     jnp.float32)
    want = jattn.decode_attention(jq, kc, vc, jnp.asarray(pos),
                                  window=window, k_scale=ks, v_scale=vs)
    tq = _bf16(q) if q_dtype == "bfloat16" else torch.from_numpy(q)
    t = lambda a: torch.from_numpy(np.array(a))             # noqa: E731
    got = tattn.decode_attention(tq, t(kc), t(vc), torch.from_numpy(pos),
                                 window=window, k_scale=t(ks),
                                 v_scale=t(vs))
    assert got.dtype == tq.dtype
    tol = 1e-2 if q_dtype == "bfloat16" else 1e-5
    np.testing.assert_allclose(np_of(got.float()),
                               np.asarray(want, np.float32), rtol=tol,
                               atol=tol)


def _assert_caches_close(tc, ref):
    for i, (c, r) in enumerate(zip(tc, ref)):
        assert set(c) == set(r) == {"k", "v", "k_scale", "v_scale"}
        for name in ("k", "v"):
            assert c[name].dtype == torch.int8
            assert tuple(c[name].shape) == tuple(r[name].shape)
            d = np.abs(c[name].numpy().astype(np.int32)
                       - r[name].numpy().astype(np.int32))
            assert d.max() <= 1 and np.mean(d > 0) <= 1e-3, (
                f"block {i} {name}: {int((d > 0).sum())} codes differ")
        for name in ("k_scale", "v_scale"):
            np.testing.assert_allclose(c[name].numpy(), r[name].numpy(),
                                       rtol=1e-5,
                                       err_msg=f"block {i} {name}")


@pytest.mark.parametrize("arch, cache_len", [("starcoder2-3b", 20),
                                             ("gemma3-27b", S + 1),
                                             ("gemma3-27b", 24)])
@pytest.mark.parametrize("positions", ["scalar", "vector"])
def test_prefill_caches_and_decode_logits_match_reference(arch, cache_len,
                                                          positions):
    jcfg, jp, tcfg, tp = model_pair(arch, layers=2)
    rng = np.random.default_rng(2)
    tok = rng.integers(0, tcfg.vocab_size, (B, S + 1))
    jl, jc = jtfm.prefill(jcfg, jp, CPU_ENV, {"tokens": jnp.asarray(tok[:, :S])},
                          cache_len=cache_len, kv_quant=True)
    tl, tc = ttfm.prefill(tcfg, tp, {"tokens": torch.from_numpy(tok[:, :S])},
                          cache_len=cache_len, kv_quant=True)
    np.testing.assert_allclose(np_of(tl), np.asarray(jl), rtol=1e-4,
                               atol=1e-5)
    ref = interop.lm_caches_from_numpy(tcfg, jax.tree.map(np.asarray, jc))
    _assert_caches_close(tc, ref)
    if tcfg.window_size:                    # every local block is a ring
        rings = [c["k"].shape[1] for c, lt in zip(tc, tcfg.layer_types())
                 if lt == "local"]
        assert set(rings) == {tcfg.window_size} and S > tcfg.window_size

    pos = (np.int32(S) if positions == "scalar"
           else np.array([S, S - 4], np.int32))
    jd, jn, jc2 = jtfm.decode_step(jcfg, jp, CPU_ENV,
                                   jnp.asarray(tok[:, S:S + 1]),
                                   jnp.asarray(pos), jc)
    tpos = (int(pos) if positions == "scalar"
            else torch.from_numpy(pos.astype(np.int64)))
    td, tn, ref = ttfm.decode_step(tcfg, tp, torch.from_numpy(tok[:, S:S + 1]),
                                   tpos, ref)
    np.testing.assert_allclose(np_of(td), np.asarray(jd), rtol=1e-4,
                               atol=1e-5)
    np.testing.assert_array_equal(np_of(tn), np.asarray(jn))
    # the decode wrote its row's codes and scales where the reference did
    _assert_caches_close(ref, interop.lm_caches_from_numpy(
        tcfg, jax.tree.map(np.asarray, jc2)))


def test_int8_cache_halves_the_bytes():
    """Codes are one byte an element beside bf16's two; the scales add 4
    bytes a row of head_dim."""
    from repro_torch.configs import get_config, reduced
    cfg = reduced(get_config("starcoder2-3b"), layers=2)

    def nbytes(caches):
        return sum(t.numel() * t.element_size() for c in caches
                   for t in c.values())

    q = nbytes(ttfm.init_caches(cfg, 2, 64, "cpu", kv_quant=True))
    f = nbytes(ttfm.init_caches(cfg, 2, 64, "cpu"))
    scales = cfg.num_layers * 2 * (2 * 64 * cfg.num_kv_heads) * 4
    assert q == f // 2 + scales
