"""Whole models with sliding-window attention and RG-LRU blocks against
the JAX package on the same weights: reduced recurrentgemma-9b (two tail
RG-LRU blocks, then one (R, R, A) superblock, window 8) and reduced
gemma3-27b (five local layers and one global, qk-norm, RoPE bases 1e4
local and 1e6 global), through ``prefill``/``decode_step``,
``SplitServer`` and ``InferenceEngine``; the ring caches carried across
from the reference; the engine's cache migration after the ring has
wrapped; and the reference's engine fault below the window.

Weights come from the reference's ``init_lm`` (numpy leaves, norm
weights randomised) through ``interop.lm_params_from_numpy``; prompts
are drawn with numpy from a seed and are longer than the window, so the
ring wraps at prefill and at decode.  Tolerances: float32 logits rtol
1e-4 (atol 1e-5 near zero), as for the other families; greedy tokens,
split against unsplit and the engine against the reference engine
exact."""
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.models import transformer as jtfm                         # noqa
from repro.runtime.meshenv import CPU_ENV                            # noqa
from repro.serving import engine as jeng                             # noqa
from repro.serving import split as jsplit                            # noqa
from repro_torch import interop                                      # noqa
from repro_torch.configs import get_config, reduced                  # noqa
from repro_torch.models import transformer as ttfm                   # noqa
from repro_torch.serving import engine as teng                       # noqa
from repro_torch.serving import split as tsplit                      # noqa

from torch_diff import j_greedy, model_pair, np_of, t_greedy        # noqa

RG = "recurrentgemma-9b"
GEMMA = "gemma3-27b"
RTOL, ATOL = 1e-4, 1e-5


@pytest.fixture(scope="module")
def rg_pair():
    return model_pair(RG, layers=5, seed=1)


@pytest.fixture(scope="module")
def gemma_pair():
    return model_pair(GEMMA, layers=6, seed=2)


def _tokens(seed, B, S, V=257):
    return np.random.default_rng(seed).integers(0, V, (B, S))


def _close(a, b, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(np_of(a), np.asarray(b), rtol=rtol,
                               atol=atol)


def _caches_np(caches):
    import jax
    return jax.tree.map(np.asarray, caches)


# ---------------------------------------------------------------------------
# configurations
# ---------------------------------------------------------------------------
def test_full_size_recurrentgemma_configuration():
    cfg = get_config(RG)
    types = cfg.layer_types()
    assert (cfg.num_layers, cfg.d_model, cfg.num_heads, cfg.num_kv_heads,
            cfg.head_dim, cfg.window_size, cfg.d_rnn, cfg.conv_width,
            cfg.d_ff, cfg.vocab_size, cfg.tie_embeddings, cfg.dtype) == (
        38, 4096, 16, 1, 256, 2048, 4096, 4, 12288, 256000, True,
        "bfloat16")
    assert types.count("rglru") == 26 and types.count("local") == 12
    assert types[:2] == ("rglru", "rglru")
    assert abs(cfg.num_params() / 1e9 - 8.58) < 0.01
    small = reduced(cfg, layers=5)
    assert small.layer_types() == ("rglru",) * 4 + ("local",)
    assert small.window_size == 8 and small.num_kv_heads == 1


def test_reduced_models_carry_the_reference_stacking(rg_pair, gemma_pair):
    """Block i of the port holds the reference's tail block i, then
    superblock (i - rem) // period of scan[(i - rem) % period]."""
    for jcfg, jp, tcfg, tp in (rg_pair, gemma_pair):
        for i, lt in enumerate(tcfg.layer_types()):
            ref = jsplit.layer_params(jcfg, jp["stack"], i)
            for k, v in ref["mix"].items():
                np.testing.assert_array_equal(np_of(tp["layers"][i]["mix"][k]),
                                              np.asarray(v))
            assert ("gate_a" in tp["layers"][i]["mix"]) == (lt == "rglru")


# ---------------------------------------------------------------------------
# prefill and decode
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch", [RG, GEMMA])
def test_prefill_and_greedy_decode_match_reference_f32(arch, rg_pair,
                                                       gemma_pair):
    """Prompts of 13 tokens against a window of 8, 16 new tokens: the
    ring wraps at prefill and again during decode.  gemma3's local layers
    must use their own RoPE base (1e4, the global layer 1e6)."""
    jcfg, jp, tcfg, tp = rg_pair if arch == RG else gemma_pair
    assert tcfg.window_size == 8
    tokens = _tokens(1, 2, 13)
    j_tok, j_logits = j_greedy(jcfg, jp, tokens, 16)
    t_tok, t_logits = t_greedy(tcfg, tp, tokens, 16)
    np.testing.assert_allclose(t_logits, j_logits, rtol=RTOL, atol=ATOL)
    np.testing.assert_array_equal(t_tok, j_tok)


def test_local_layers_use_the_local_rope_base(gemma_pair):
    _, _, tcfg, tp = gemma_pair
    assert tcfg.rope_theta != tcfg.rope_theta_local
    x = torch.from_numpy(np.random.default_rng(3).standard_normal(
        (1, 5, tcfg.d_model)).astype(np.float32))
    pos = torch.arange(5)[None]
    q_loc = ttfm._project_qkv(tcfg, tp["layers"][0]["mix"], x, pos,
                              "local")[0]
    q_glo = ttfm._project_qkv(tcfg, tp["layers"][0]["mix"], x, pos,
                              "global")[0]
    assert torch.equal(q_loc[:, 0], q_glo[:, 0])        # position 0
    assert not torch.allclose(q_loc[:, 1:], q_glo[:, 1:])


def test_reference_prefill_caches_carry_to_port_decode(rg_pair):
    """The reference's prefill caches (a wrapped ring, RG-LRU state),
    carried by ``interop.lm_caches_from_numpy``, continue in the port's
    decode_step exactly as in the reference's."""
    jcfg, jp, tcfg, tp = rg_pair
    tokens = _tokens(2, 2, 11)
    S = tokens.shape[1]
    logits, jc = jtfm.prefill(jcfg, jp, CPU_ENV,
                              {"tokens": jnp.asarray(tokens)},
                              cache_len=S + 6)
    tc = interop.lm_caches_from_numpy(tcfg, _caches_np(jc))
    assert tuple(tc[-1]["k"].shape) == (2, 8, 1, tcfg.head_dim)
    assert tuple(tc[0]["mix"]["h"].shape) == (2, tcfg.d_rnn)
    cur = jnp.argmax(logits[:, :jcfg.vocab_size], -1).astype(jnp.int32)
    tcur = torch.from_numpy(np.asarray(cur, np.int64))
    for i in range(5):
        lj, cur, jc = jtfm.decode_step(jcfg, jp, CPU_ENV, cur[:, None],
                                       jnp.asarray(S + i, jnp.int32), jc)
        lt, tcur, _ = ttfm.decode_step(tcfg, tp, tcur[:, None], S + i, tc)
        _close(lt, lj)
        np.testing.assert_array_equal(np_of(tcur), np.asarray(cur))
    want = interop.lm_caches_from_numpy(tcfg, _caches_np(jc))
    for got, ref in zip(tc, want):
        leaves = got["mix"] if "mix" in got else got
        refs = ref["mix"] if "mix" in ref else ref
        for k in leaves:
            _close(leaves[k], np_of(refs[k]))


def test_decode_step_vector_positions_match_reference(rg_pair):
    """Continuous batching: per-row positions, some past the window."""
    jcfg, jp, tcfg, tp = rg_pair
    rng = np.random.default_rng(4)
    cj, _ = jtfm.init_caches(jcfg, CPU_ENV, 3, 32)
    ct = ttfm.init_caches(tcfg, 3, 32, "cpu")
    for step in range(3):
        tok = rng.integers(0, 257, (3, 1))
        pos = np.asarray([2, 9, 25]) + step
        lj, nj, cj = jtfm.decode_step(jcfg, jp, CPU_ENV, jnp.asarray(tok),
                                      jnp.asarray(pos, jnp.int32), cj)
        lt, nt, _ = ttfm.decode_step(tcfg, tp, torch.from_numpy(tok),
                                     torch.from_numpy(pos), ct)
        _close(lt, lj)
        np.testing.assert_array_equal(np_of(nt), np.asarray(nj))
    _close(ct[-1]["k"], cj["scan"][2]["mix"]["k"][0])
    _close(ct[0]["mix"]["h"], cj["tail"][0]["mix"]["h"])


# ---------------------------------------------------------------------------
# SplitServer
# ---------------------------------------------------------------------------
def test_split_generation_equals_unsplit_at_every_split(rg_pair):
    jcfg, jp, tcfg, tp = rg_pair
    tok = _tokens(5, 2, 12)
    server = tsplit.SplitServer(tcfg, tp, device="cpu")
    unsplit, _ = t_greedy(tcfg, tp, tok, 6)
    for split in range(tcfg.num_layers + 1):
        out = server.generate(torch.from_numpy(tok), split, max_new=6)
        np.testing.assert_array_equal(np_of(out), unsplit)
    ref = jsplit.SplitServer(jcfg, jp, CPU_ENV).generate(
        jnp.asarray(tok), 3, max_new=6)
    np.testing.assert_array_equal(unsplit, np.asarray(ref))


# ---------------------------------------------------------------------------
# InferenceEngine
# ---------------------------------------------------------------------------
def _engines(model, **kw):
    jcfg, jp, tcfg, tp = model
    return (teng.InferenceEngine(tcfg, tp, device="cpu", **kw),
            jeng.InferenceEngine(jcfg, jp, env=CPU_ENV, **kw))


@pytest.mark.parametrize("cache_len,lens,new", [
    (8, (3, 5, 3, 5), 4),            # cache as long as the window
    (32, (12, 6, 12, 6, 12), 9),     # above it: rings wrap
])
def test_engine_matches_reference(rg_pair, cache_len, lens, new):
    t, j = _engines(rg_pair, slots=2, cache_len=cache_len)
    prompts = [_tokens(10 + i, 1, n)[0] for i, n in enumerate(lens)]
    rids = [(t.submit(p, new), j.submit(p, new)) for p in prompts]
    tout, jout = t.run_to_completion(), j.run_to_completion()
    assert len(tout) == len(prompts)
    for rt, rj in rids:
        assert tout[rt] == jout[rj]


def test_engine_export_import_after_the_ring_wrapped(rg_pair):
    """A stream whose position passed the window ships its ring whole
    (and its RG-LRU state) and continues in another engine as if
    uninterrupted."""
    _, _, tcfg, tp = rg_pair
    p = _tokens(20, 1, 10)[0]
    want, _ = t_greedy(tcfg, tp, p[None], 12)
    src = teng.InferenceEngine(tcfg, tp, device="cpu", slots=2,
                               cache_len=48)
    dst = teng.InferenceEngine(tcfg, tp, device="cpu", slots=2,
                               cache_len=24)
    rid = src.submit(p, max_new=12)
    src.admit()
    for _ in range(3):
        src.step()
    leaves, pos = src.export_cache(rid)
    assert pos == len(p) + 3 > tcfg.window_size
    assert tuple(leaves[-1]["k"].shape) == (1, 8, 1, tcfg.head_dim)
    assert tuple(leaves[0]["mix"]["conv"].shape) == (1, 3, tcfg.d_rnn)
    produced = list(src.requests[rid].out)
    ctx = np.concatenate([p, np.asarray(produced, np.int64)])
    rid2 = dst.import_cache(ctx, 12 - len(produced), leaves, pos)
    assert produced + dst.run_to_completion()[rid2] == want[0].tolist()


def test_reference_engine_cannot_serve_below_the_window_the_port_can():
    """The reference sizes a local pool at min(window, cache_len) but its
    prefill returns a ring of ``window`` rows, so every admission raises
    at cache_len < window; the port's prefill ring is the pool's size and
    its requests equal their own one-request generation."""
    pair = model_pair(RG, layers=3, seed=6)
    t, j = _engines(pair, slots=2, cache_len=4)
    prompts = [_tokens(30 + i, 1, 2)[0] for i in range(3)]
    j.submit(prompts[0], 3)
    with pytest.raises(jeng.CacheOverflowError, match="exceeds pool slot"):
        j.run_to_completion()
    rids = [t.submit(q, 3) for q in prompts]
    out = t.run_to_completion()
    _, _, tcfg, tp = pair
    for rid, q in zip(rids, prompts):
        assert out[rid] == t_greedy(tcfg, tp, q[None], 3)[0][0].tolist()


def test_engine_refuses_a_request_longer_than_its_cache(rg_pair):
    t, _ = _engines(rg_pair, slots=1, cache_len=8)
    with pytest.raises(teng.CacheOverflowError, match="cache_len=8"):
        t.submit(np.arange(5), max_new=5)
    t.submit(np.arange(5), max_new=4)                  # exactly fills
    assert len(t.run_to_completion()) == 1
