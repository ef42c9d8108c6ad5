"""The port's encoder-decoder stack (seamless-m4t-large-v2, reduced)
against the JAX package's on the same weights and the same numpy frame
embeddings, and the frontend stubs.

Weights come from the reference's ``init_lm`` (numpy leaves, every norm
weight randomised, ``ln_cross`` and ``enc_norm`` included) through
``interop.lm_params_from_numpy``.  Tolerances:

* float32: prefill and decode logits to rtol 1e-4 / atol 1e-5, the
  caches (self and cross k/v) to rtol 1e-4 / atol 1e-5 (sums in another
  order, XLA's and ATen's sin/cos/pow differ by ulps); greedy tokens
  exactly.
* bfloat16: logits to atol 0.08 / rtol 0.02, the reference's own bound
  for one model computed in two orders (tests/test_split_serving.py).
* decode against teacher-forced prefill: atol = rtol = 2e-2, the
  reference's own figure (tests/test_models.py).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.models import transformer as jtfm                        # noqa
from repro.runtime.meshenv import CPU_ENV                           # noqa
from repro_torch import interop                                     # noqa
from repro_torch.configs import get_config, reduced                 # noqa
from repro_torch.models import frontend                             # noqa
from repro_torch.models import transformer as ttfm                  # noqa
from repro_torch.serving import InferenceEngine, SplitServer        # noqa

from torch_diff import model_pair, np_of                            # noqa

ARCH = "seamless-m4t-large-v2"
B, S, SS, L = 2, 7, 11, 16


def _inputs(cfg, seed=0):
    rng = np.random.default_rng(seed)
    tok = rng.integers(0, cfg.vocab_size, (B, S + 1))
    src = rng.standard_normal((B, SS, cfg.d_model)).astype(np.float32)
    return tok, src


def _j_prefill(cfg, params, tok, src, cache_len=L):
    return jtfm.prefill(cfg, params, CPU_ENV,
                        {"tokens": jnp.asarray(tok),
                         "src_embeds": jnp.asarray(src)},
                        cache_len=cache_len)


def _t_prefill(cfg, params, tok, src, cache_len=L):
    return ttfm.prefill(cfg, params, {"tokens": torch.from_numpy(tok),
                                      "src_embeds": torch.from_numpy(src)},
                        cache_len=cache_len)


def _close(got, want, rtol=1e-4, atol=1e-5, name=""):
    np.testing.assert_allclose(np_of(got).astype(np.float32),
                               np.asarray(want, np.float32), rtol=rtol,
                               atol=atol, err_msg=name)


# ---------------------------------------------------------------------------
# frontend stubs
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch, fn", [("internvl2-1b", "vit"),
                                      ("seamless-m4t-large-v2", "audio")])
def test_frontend_stub_shapes_and_dtypes(arch, fn):
    """Shapes and dtypes of the reference's stubs (JAX's draws cannot be
    matched), one draw per seed, and a refusal of the other modality."""
    from repro.configs import get_config as j_get_config
    from repro.models import frontend as jfront
    cfg, jcfg = get_config(arch), j_get_config(arch)

    def draw(seed):
        gen = torch.Generator().manual_seed(seed)
        if fn == "vit":
            return frontend.vit_patch_embeds(cfg, gen, 2, device="cpu")
        return frontend.audio_frame_embeds(cfg, gen, 2, 13, device="cpu")

    x = draw(0)
    if fn == "vit":
        want = jfront.vit_patch_embeds(jcfg, jax.random.PRNGKey(0), 2)
        with pytest.raises(ValueError, match="audio"):
            frontend.audio_frame_embeds(cfg, torch.Generator(), 2, 4, "cpu")
    else:
        want = jfront.audio_frame_embeds(jcfg, jax.random.PRNGKey(0), 2, 13)
        with pytest.raises(ValueError, match="vit"):
            frontend.vit_patch_embeds(cfg, torch.Generator(), 2, "cpu")
    assert tuple(x.shape) == want.shape
    assert x.dtype == torch.bfloat16 and want.dtype.name == "bfloat16"
    assert torch.equal(x, draw(0)) and not torch.equal(x, draw(1))
    assert abs(x.float().std().item() - 1.0) < 0.1


# ---------------------------------------------------------------------------
# the stack against the reference
# ---------------------------------------------------------------------------
def test_prefill_logits_and_caches_match_reference():
    jcfg, jp, tcfg, tp = model_pair(ARCH, layers=2)
    tok, src = _inputs(tcfg)
    jl, jc = _j_prefill(jcfg, jp, tok[:, :S], src)
    tl, tc = _t_prefill(tcfg, tp, tok[:, :S], src)
    _close(tl, jl, name="prefill logits")
    ref = interop.lm_caches_from_numpy(tcfg, jax.tree.map(np.asarray, jc))
    assert len(tc) == len(ref) == tcfg.num_layers
    for i, (c, r) in enumerate(zip(tc, ref)):
        assert set(c) == set(r) == {"k", "v", "cross"}
        for name in ("k", "v"):
            _close(c[name], r[name], name=f"block {i} {name}")
            assert tuple(c["cross"][name].shape) == (
                B, SS, tcfg.num_kv_heads, tcfg.head_dim)
            _close(c["cross"][name], r["cross"][name],
                   name=f"block {i} cross {name}")


@pytest.mark.parametrize("positions", ["scalar", "vector"])
def test_decode_step_matches_reference(positions):
    """One decode step from the reference's own prefill caches carried
    across, at a scalar position or per-sequence (B,) positions; the
    cross caches come back unchanged."""
    jcfg, jp, tcfg, tp = model_pair(ARCH, layers=2, seed=1)
    tok, src = _inputs(tcfg, seed=1)
    _, jc = _j_prefill(jcfg, jp, tok[:, :S], src)
    tc = interop.lm_caches_from_numpy(tcfg, jax.tree.map(np.asarray, jc))
    cross0 = [c["cross"]["k"].clone() for c in tc]
    pos = (np.int32(S) if positions == "scalar"
           else np.array([S, S - 3], np.int32))
    jl, jn, _ = jtfm.decode_step(jcfg, jp, CPU_ENV,
                                 jnp.asarray(tok[:, S:S + 1]),
                                 jnp.asarray(pos), jc)
    tl, tn, tc = ttfm.decode_step(tcfg, tp, torch.from_numpy(tok[:, S:S + 1]),
                                  int(pos) if positions == "scalar"
                                  else torch.from_numpy(pos.astype(np.int64)),
                                  tc)
    _close(tl, jl, name="decode logits")
    np.testing.assert_array_equal(np_of(tn), np.asarray(jn))
    for c, k0 in zip(tc, cross0):
        assert torch.equal(c["cross"]["k"], k0)


def test_greedy_tokens_match_reference():
    """Six greedy tokens through prefill + decode_step, float32: equal."""
    jcfg, jp, tcfg, tp = model_pair(ARCH, layers=2, seed=2)
    tok, src = _inputs(tcfg, seed=2)
    new = 6
    jl, jc = _j_prefill(jcfg, jp, tok[:, :S], src, cache_len=S + new)
    tl, tc = _t_prefill(tcfg, tp, tok[:, :S], src, cache_len=S + new)
    jcur = jnp.argmax(jl[:, :jcfg.vocab_size], -1).astype(jnp.int32)
    tcur = torch.argmax(tl[:, :tcfg.vocab_size], -1)
    jout, tout = [np.asarray(jcur)], [np_of(tcur)]
    for i in range(new - 1):
        _, jcur, jc = jtfm.decode_step(jcfg, jp, CPU_ENV, jcur[:, None],
                                       jnp.asarray(S + i, jnp.int32), jc)
        _, tcur, tc = ttfm.decode_step(tcfg, tp, tcur[:, None], S + i, tc)
        jout.append(np.asarray(jcur))
        tout.append(np_of(tcur))
    np.testing.assert_array_equal(np.stack(tout, 1), np.stack(jout, 1))


def test_decode_matches_teacher_forced_prefill():
    """prefill(S) + decode_step(token S) == prefill(S + 1)'s last logits,
    at tests/test_models.py's 2e-2, in the port (reduced seamless, its
    own bf16 weights)."""
    cfg = reduced(get_config(ARCH), layers=2)
    params = ttfm.init_lm(cfg, torch.Generator().manual_seed(4))
    tok, src = _inputs(cfg, seed=4)
    src = src.astype(np.float32)
    _, caches = _t_prefill(cfg, params, tok[:, :S], src)
    ld, _, _ = ttfm.decode_step(cfg, params,
                                torch.from_numpy(tok[:, S:S + 1]), S, caches)
    lr, _ = _t_prefill(cfg, params, tok, src)
    np.testing.assert_allclose(np_of(ld.float()), np_of(lr.float()),
                               atol=2e-2, rtol=2e-2)


def test_bf16_prefill_matches_reference():
    jcfg, jp, tcfg, tp = model_pair(ARCH, layers=2, dtype="bfloat16",
                                    seed=5)
    tok, src = _inputs(tcfg, seed=5)
    jl, _ = _j_prefill(jcfg, jp, tok[:, :S], src)
    tl, tc = _t_prefill(tcfg, tp, tok[:, :S], src)
    assert tc[0]["cross"]["k"].dtype == torch.bfloat16
    _close(tl.float(), np.asarray(jl, np.float32), rtol=0.02, atol=0.08,
           name="bf16 prefill logits")


def test_serving_refuses_the_encoder_decoder():
    """SplitServer and InferenceEngine prefill tokens only, as the
    reference's do, so they refuse a stack that needs source frames."""
    cfg = reduced(get_config(ARCH), layers=2)
    params = ttfm.init_lm(cfg, torch.Generator().manual_seed(0))
    with pytest.raises(ValueError, match="decoder-only"):
        SplitServer(cfg, params, device="cpu")
    with pytest.raises(ValueError, match="decoder-only"):
        InferenceEngine(cfg, params, device="cpu")
