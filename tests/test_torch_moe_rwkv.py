"""The port's MoE (granite-moe-1b-a400m) and RWKV-6 (rwkv6-3b) families
against the JAX package's on the same weights: the MoE FFN with capacity
drops, the RWKV-6 time and channel mix with and without state, whole
reduced models through ``prefill``/``decode_step``, ``SplitServer`` and
``InferenceEngine``, and the engine's cache migration for recurrent
state.

Weights come from the reference's ``init_lm`` (numpy leaves, norm
weights randomised) through ``interop.lm_params_from_numpy``; inputs are
drawn with numpy from a seed.  Tolerances, with their reasons:

* float32 layers and logits: rtol 1e-4 (atol 1e-5 near zero), as for the
  dense decoder: sums run in another order and XLA's and ATen's
  transcendentals differ by ulps.  The MoE's aux loss: 1e-6 relative.
* Greedy tokens, split against unsplit, and the engine against the
  reference engine: exact.  Split and unsplit logits of the port: bit
  for bit (the same ops in the same order).
* bfloat16 logits: atol 0.08 / rtol 0.02, the reference's own bound for
  one model computed in two orders (tests/test_split_serving.py).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.models import moe as jmoe                                 # noqa
from repro.models import rwkv as jrwkv                               # noqa
from repro.models import transformer as jtfm                         # noqa
from repro.runtime.meshenv import CPU_ENV                            # noqa
from repro.serving import engine as jeng                             # noqa
from repro.serving import split as jsplit                            # noqa
from repro_torch import interop                                      # noqa
from repro_torch.configs import get_config, reduced                  # noqa
from repro_torch.models import moe as tmoe                           # noqa
from repro_torch.models import rwkv as trwkv                         # noqa
from repro_torch.models import transformer as ttfm                   # noqa
from repro_torch.serving import engine as teng                       # noqa
from repro_torch.serving import split as tsplit                      # noqa

from torch_diff import j_greedy, model_pair, np_of, t_greedy        # noqa

MOE = "granite-moe-1b-a400m"
RWKV = "rwkv6-3b"
RTOL, ATOL = 1e-4, 1e-5


@pytest.fixture(scope="module", params=[MOE, RWKV])
def pair(request):
    return model_pair(request.param, layers=2, seed=3)


@pytest.fixture(scope="module")
def moe_pair():
    return model_pair(MOE, layers=2, seed=4)


@pytest.fixture(scope="module")
def rwkv_pair():
    return model_pair(RWKV, layers=2, seed=5)


def _tokens(seed, B, S, V=257):
    return np.random.default_rng(seed).integers(0, V, (B, S))


def _close(a, b, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(np_of(a), np.asarray(b), rtol=rtol,
                               atol=atol)


# ---------------------------------------------------------------------------
# configurations and parameters
# ---------------------------------------------------------------------------
def test_full_size_configurations():
    g, r = get_config(MOE), get_config(RWKV)
    assert (g.num_layers, g.d_model, g.num_heads, g.num_kv_heads,
            g.head_dim, g.num_experts, g.experts_per_token, g.d_ff,
            g.vocab_size, g.tie_embeddings, g.dtype) == (
        24, 1024, 16, 8, 64, 32, 8, 512, 49155, True, "bfloat16")
    assert round(g.num_params() / 1e9, 2) == 1.33
    assert (r.num_layers, r.d_model, r.rwkv_num_heads, r.rwkv_head_dim,
            r.rwkv_decay_lora, r.d_ff_rwkv, r.vocab_size, r.dtype) == (
        32, 2560, 40, 64, 64, 8960, 65536, "bfloat16")
    assert round(r.num_params() / 1e9, 2) == 3.07


@pytest.mark.parametrize("arch", [MOE, RWKV])
def test_float32_leaves_stay_float32_in_a_bf16_model(arch):
    """The router and the RWKV decay LoRA, bonus and group-norm weights
    are float32 in the reference even when the model is bfloat16; both
    the port's own init and the weight conversion keep them so."""
    f32 = {"router", "w0", "wA", "wB", "u", "ln_x"}
    cfg = reduced(get_config(arch), layers=2)
    own = ttfm.init_lm(cfg, torch.Generator().manual_seed(0))
    _, _, _, conv = model_pair(arch, layers=2, dtype="bfloat16")
    for params in (own, conv):
        blk = params["layers"][1]
        for part in ("mix", "ffn"):
            for name, t in blk[part].items():
                want = torch.float32 if name in f32 else torch.bfloat16
                assert t.dtype == want, (part, name, t.dtype)
    assert set(own["layers"][0]["mix"]) == set(conv["layers"][0]["mix"])
    assert set(own["layers"][0]["ffn"]) == set(conv["layers"][0]["ffn"])


@pytest.mark.parametrize("tokens", [1, 4, 8, 22, 4096])
@pytest.mark.parametrize("factor", [1.25, 2.0])
def test_capacity_for_matches_reference(tokens, factor):
    from repro.configs import get_config as j_get_config
    assert (tmoe.capacity_for(tokens, get_config(MOE), factor)
            == jmoe.capacity_for(tokens, j_get_config(MOE), factor))


# ---------------------------------------------------------------------------
# the MoE FFN
# ---------------------------------------------------------------------------
def _moe_case(seed, T=24, d=16, ff=32, E=4, k=2):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((T, d)).astype(np.float32)
    p = {"router": rng.standard_normal((d, E)).astype(np.float32),
         "wg": rng.standard_normal((E, d, ff)).astype(np.float32) * 0.2,
         "wu": rng.standard_normal((E, d, ff)).astype(np.float32) * 0.2,
         "wd": rng.standard_normal((E, ff, d)).astype(np.float32) * 0.2}
    return x, p, E, k


def _dropped_tokens(x, router, k, E, cap):
    """Tokens that lose an assignment under the reference's dispatch,
    recomputed in numpy from the reference router's top-k."""
    gates = jax.nn.softmax(jnp.asarray(x) @ jnp.asarray(router), axis=-1)
    idx = np.asarray(jax.lax.top_k(gates, k)[1]).reshape(-1)
    order = np.argsort(idx, kind="stable")
    counts = np.bincount(idx, minlength=E)
    rank = np.arange(len(idx)) - (np.cumsum(counts) - counts)[idx[order]]
    return set((order[rank >= cap] // k).tolist())


def test_apply_moe_matches_reference_with_capacity_drops():
    x, p, E, k = _moe_case(0)
    T = x.shape[0]
    cap = 4                                     # 12 a expert on average
    tp = {n: torch.from_numpy(a) for n, a in p.items()}
    y, aux = tmoe._moe_local(torch.from_numpy(x), *(tp[n] for n in (
        "router", "wg", "wu", "wd")), num_experts=E, top_k=k, capacity=cap)
    jy, jaux = jmoe._moe_local(jnp.asarray(x), *(jnp.asarray(p[n]) for n in (
        "router", "wg", "wu", "wd")), e0=0, num_experts=E, top_k=k,
        capacity=cap)
    _close(y, jy)
    np.testing.assert_allclose(np_of(aux), np.asarray(jaux), rtol=1e-6)
    # the same tokens drop: exactly the rows that change when nothing does
    y_all, _ = tmoe._moe_local(torch.from_numpy(x), *(tp[n] for n in (
        "router", "wg", "wu", "wd")), num_experts=E, top_k=k, capacity=T)
    changed = set(np.nonzero(np.any(np_of(y) != np_of(y_all), axis=1))[0]
                  .tolist())
    dropped = _dropped_tokens(x, p["router"], k, E, cap)
    assert dropped and changed == dropped


@pytest.mark.parametrize("factor", [1.25, 2.0, 0.5])
def test_apply_moe_layer_matches_reference(moe_pair, factor):
    jcfg, jp, tcfg, tp = moe_pair
    x = np.random.default_rng(8).standard_normal((2, 7, tcfg.d_model)) \
        .astype(np.float32)
    blk_t = tp["layers"][0]["ffn"]
    blk_j = jsplit.layer_params(jcfg, jp["stack"], 0)["ffn"]
    y, aux = tmoe.apply_moe(tcfg, blk_t, torch.from_numpy(x),
                            capacity_factor=factor)
    jy, jaux = jmoe.apply_moe(jcfg, blk_j, CPU_ENV, jnp.asarray(x),
                              capacity_factor=factor)
    assert tuple(y.shape) == x.shape and tuple(aux.shape) == (2, 7)
    _close(y, jy)
    np.testing.assert_allclose(np_of(aux), np.asarray(jaux), rtol=1e-6)


# ---------------------------------------------------------------------------
# the RWKV-6 time and channel mix
# ---------------------------------------------------------------------------
def _j_state(st):
    return None if st is None else {k: jnp.asarray(np_of(v))
                                    for k, v in st.items()}


@pytest.mark.parametrize("S,with_state", [(6, False), (6, True),
                                          (1, True), (1, False)])
def test_time_and_channel_mix_match_reference(rwkv_pair, S, with_state):
    jcfg, jp, tcfg, tp = rwkv_pair
    rng = np.random.default_rng(9 + S)
    x = rng.standard_normal((2, S, tcfg.d_model)).astype(np.float32)
    blk_t = tp["layers"][1]
    blk_j = jsplit.layer_params(jcfg, jp["stack"], 1)
    st = None
    if with_state:
        H, n, d = tcfg.rwkv_num_heads, tcfg.rwkv_head_dim, tcfg.d_model
        st = {"s": torch.from_numpy(rng.standard_normal((2, H, n, n))
                                    .astype(np.float32) * 0.3),
              "tm": torch.from_numpy(rng.standard_normal((2, d))
                                     .astype(np.float32)),
              "cm": torch.from_numpy(rng.standard_normal((2, d))
                                     .astype(np.float32))}
    tm = None if st is None else {"s": st["s"].clone(),
                                  "tm": st["tm"].clone()}
    jout, jnew = jrwkv.apply_time_mix(jcfg, blk_j["mix"], CPU_ENV,
                                      jnp.asarray(x), _j_state(tm))
    out, new = trwkv.apply_time_mix(tcfg, blk_t["mix"], torch.from_numpy(x),
                                    tm)
    _close(out, jout)
    for name in ("s", "tm"):
        _close(new[name], jnew[name])
    if tm is not None:
        assert new is tm                    # decode updates in place
    cm = None if st is None else {"cm": st["cm"].clone()}
    out, new = trwkv.apply_channel_mix(tcfg, blk_t["ffn"],
                                       torch.from_numpy(x), cm)
    jout, jnew = jrwkv.apply_channel_mix(
        jcfg, blk_j["ffn"], CPU_ENV, jnp.asarray(x),
        None if st is None else {"cm": jnp.asarray(np_of(st["cm"]))})
    _close(out, jout)
    _close(new["cm"], jnew["cm"])


# ---------------------------------------------------------------------------
# whole models
# ---------------------------------------------------------------------------
def test_prefill_and_greedy_decode_match_reference_f32(pair):
    jcfg, jp, tcfg, tp = pair
    tokens = _tokens(1, 2, 11)
    j_tok, j_logits = j_greedy(jcfg, jp, tokens, 6)
    t_tok, t_logits = t_greedy(tcfg, tp, tokens, 6)
    np.testing.assert_allclose(t_logits, j_logits, rtol=RTOL, atol=ATOL)
    np.testing.assert_array_equal(t_tok, j_tok)


@pytest.mark.parametrize("arch", [MOE, RWKV])
def test_prefill_logits_match_reference_bf16(arch):
    jcfg, jp, tcfg, tp = model_pair(arch, layers=2, dtype="bfloat16")
    tokens = _tokens(2, 2, 9)
    lj, _ = jtfm.prefill(jcfg, jp, CPU_ENV, {"tokens": jnp.asarray(tokens)},
                         cache_len=16)
    lt, _ = ttfm.prefill(tcfg, tp, {"tokens": torch.from_numpy(tokens)},
                         cache_len=16)
    assert lt.dtype == torch.bfloat16
    np.testing.assert_allclose(np_of(lt.float()), np.asarray(lj, np.float32),
                               atol=0.08, rtol=0.02)


def test_decode_step_vector_positions_and_state_match_reference(pair):
    """Continuous batching: per-row positions; RWKV state or MoE drops
    across rows, each updated in place."""
    jcfg, jp, tcfg, tp = pair
    rng = np.random.default_rng(3)
    cj, _ = jtfm.init_caches(jcfg, CPU_ENV, 3, 16)
    ct = ttfm.init_caches(tcfg, 3, 16, "cpu")
    for step in range(3):
        tok = rng.integers(0, 257, (3, 1))
        pos = np.asarray([2, 7, 15]) - 2 + step
        lj, nj, cj = jtfm.decode_step(jcfg, jp, CPU_ENV, jnp.asarray(tok),
                                      jnp.asarray(pos, jnp.int32), cj)
        lt, nt, ct2 = ttfm.decode_step(tcfg, tp, torch.from_numpy(tok),
                                       torch.from_numpy(pos), ct)
        _close(lt, lj)
        np.testing.assert_array_equal(np_of(nt), np.asarray(nj))
    if tcfg.layer_types()[0] == "rwkv6":
        _close(ct[1]["mix"]["s"], cj["scan"][0]["mix"]["s"][1])
        _close(ct[1]["ffn"]["cm"], cj["scan"][0]["ffn"]["cm"][1])
    else:
        _close(ct[1]["k"], cj["scan"][0]["mix"]["k"][1])


# ---------------------------------------------------------------------------
# SplitServer
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("split", [0, 1, 2])
def test_split_generation_equals_unsplit_and_reference(pair, split):
    jcfg, jp, tcfg, tp = pair
    tok = _tokens(4, 2, 7)
    server = tsplit.SplitServer(tcfg, tp, device="cpu")
    logits, _, (dev_c, edge_c) = server.prefill(tok, split, cache_len=16)
    ref_logits, _ = ttfm.prefill(tcfg, tp, {"tokens": torch.from_numpy(tok)},
                                 cache_len=16)
    assert len(dev_c) == split and len(edge_c) == tcfg.num_layers - split
    assert torch.equal(logits, ref_logits)
    out = server.generate(torch.from_numpy(tok), split, max_new=5)
    unsplit, _ = t_greedy(tcfg, tp, tok, 5)
    ref = jsplit.SplitServer(jcfg, jp, CPU_ENV).generate(
        jnp.asarray(tok), split, max_new=5)
    np.testing.assert_array_equal(np_of(out), np.asarray(ref))
    if tcfg.num_experts:
        # split decode runs at capacity 1.25, unsplit at 2.0 (both as the
        # reference); at B=2 with E=4, k=2 the capacities agree
        assert (tmoe.capacity_for(2, tcfg, 1.25)
                == tmoe.capacity_for(2, tcfg, 2.0))
    np.testing.assert_array_equal(np_of(out), unsplit)


def test_split_failover_carries_rwkv_state(rwkv_pair):
    _, _, tcfg, tp = rwkv_pair
    tok = _tokens(5, 1, 6)
    clean = tsplit.SplitServer(tcfg, tp, device="cpu").generate(
        torch.from_numpy(tok), 1, max_new=5)
    primary = tsplit.SplitServer(tcfg, tp, device="cpu", name="edge-0")
    fallback = tsplit.SplitServer(tcfg, tp, device="cpu", name="edge-1")
    primary.fail(after_calls=3)
    out, report = primary.generate_with_failover(
        torch.from_numpy(tok), 1, max_new=5, fallbacks=[fallback])
    assert report.retries == 1
    np.testing.assert_array_equal(np_of(out), np_of(clean))


# ---------------------------------------------------------------------------
# InferenceEngine
# ---------------------------------------------------------------------------
def _engines(model, **kw):
    jcfg, jp, tcfg, tp = model
    return (teng.InferenceEngine(tcfg, tp, device="cpu", **kw),
            jeng.InferenceEngine(jcfg, jp, env=CPU_ENV, **kw))


def test_engine_matches_reference_more_requests_than_slots(pair):
    """Inactive slots take part in every batched decode (and, for MoE,
    take capacity), as in the reference engine."""
    t, j = _engines(pair, slots=2, cache_len=64)
    prompts = [_tokens(10 + i, 1, 3 + 2 * i)[0] for i in range(5)]
    rids = [(t.submit(p, 6), j.submit(p, 6)) for p in prompts]
    tout, jout = t.run_to_completion(), j.run_to_completion()
    assert len(tout) == 5
    for rt, rj in rids:
        assert tout[rt] == jout[rj]


def test_rwkv_engine_requests_equal_their_own_generation(rwkv_pair):
    _, _, tcfg, tp = rwkv_pair
    t, _ = _engines(rwkv_pair, slots=3, cache_len=64)
    prompts = [_tokens(20 + i, 1, 4 + 3 * i)[0] for i in range(4)]
    rids = [t.submit(p, 5) for p in prompts]
    out = t.run_to_completion()
    for rid, p in zip(rids, prompts):
        assert out[rid] == list(t_greedy(tcfg, tp, p[None], 5)[0][0])


@pytest.mark.parametrize("dst_len", [48, 16])
def test_rwkv_engine_export_import_matches_reference(rwkv_pair, dst_len):
    """Export a running RWKV stream mid-decode and import it elsewhere:
    the state ships whole, and the continued stream equals the
    uninterrupted one and the reference engine's.  The cache lengths
    avoid n = 32 and d_model = 64, where the reference crops state."""
    _, _, tcfg, tp = rwkv_pair
    p = np.asarray([5, 9, 2, 7], np.int32)
    want = list(t_greedy(tcfg, tp, p[None], 8)[0][0])
    for src, dst in zip(_engines(rwkv_pair, slots=2, cache_len=48),
                        _engines(rwkv_pair, slots=2, cache_len=dst_len)):
        rid = src.submit(p, max_new=8)
        src.admit()
        src.step()
        src.step()
        produced = list(src.requests[rid].out)
        leaves, pos = src.export_cache(rid)
        ctx = np.concatenate([p, np.asarray(produced, np.int32)])
        rid2 = dst.import_cache(ctx, 8 - len(produced), leaves, pos)
        assert produced + dst.run_to_completion()[rid2] == want


def test_rwkv_export_at_cache_len_equal_head_size_keeps_the_state(rwkv_pair):
    """At cache_len == n the reference's size-based axis search crops the
    state's k axis to ``pos`` rows; the port picks the cache-length axis
    by leaf name, ships the state whole, and the stream continues
    exactly.  (Not compared with the reference, which corrupts it.)"""
    _, _, tcfg, tp = rwkv_pair
    n, H = tcfg.rwkv_head_dim, tcfg.rwkv_num_heads
    p = np.asarray([3, 1, 4, 1, 5, 9], np.int32)
    want = list(t_greedy(tcfg, tp, p[None], 10)[0][0])
    src, _ = _engines(rwkv_pair, slots=2, cache_len=n)
    dst, _ = _engines(rwkv_pair, slots=2, cache_len=n)
    rid = src.submit(p, max_new=10)
    src.admit()
    for _ in range(3):
        src.step()
    leaves, pos = src.export_cache(rid)
    assert pos < n
    assert tuple(leaves[0]["mix"]["s"].shape) == (1, H, n, n)
    assert tuple(leaves[0]["mix"]["tm"].shape) == (1, tcfg.d_model)
    produced = list(src.requests[rid].out)
    ctx = np.concatenate([p, np.asarray(produced, np.int32)])
    rid2 = dst.import_cache(ctx, 10 - len(produced), leaves, pos)
    assert produced + dst.run_to_completion()[rid2] == want


def test_kv_leaves_are_still_cropped_by_name(moe_pair):
    t, _ = _engines(moe_pair, slots=2, cache_len=32)
    rid = t.submit(np.asarray([1, 2, 3], np.int32), max_new=6)
    t.admit()
    t.step()
    leaves, pos = t.export_cache(rid)
    assert pos == 4
    assert tuple(leaves[1]["k"].shape)[:2] == (1, 4)


@pytest.mark.parametrize("arch", [MOE, RWKV])
def test_engine_import_overflow_raises_for_every_family(arch):
    jcfg, jp, tcfg, tp = model_pair(arch, layers=2, seed=6)
    t = teng.InferenceEngine(tcfg, tp, device="cpu", slots=1, cache_len=64)
    rid = t.submit(np.asarray([5, 9, 2, 7], np.int32), max_new=8)
    t.admit()
    t.step()
    leaves, pos = t.export_cache(rid)
    dst = teng.InferenceEngine(tcfg, tp, device="cpu", slots=1, cache_len=8)
    with pytest.raises(teng.CacheOverflowError, match="cache_len=8"):
        dst.import_cache(np.arange(pos + 1), 4, leaves, pos)


def test_engine_under_reference_capacity_factors(moe_pair):
    """The engine's prefill runs at 1.25 and its decode at 2.0, the
    split path at 1.25 in both, as in the reference."""
    _, _, tcfg, tp = moe_pair
    seen = []
    orig = tmoe.apply_moe

    def spy(cfg, p, x, *, capacity_factor=1.25, **kw):
        seen.append((x.shape[1], capacity_factor))
        return orig(cfg, p, x, capacity_factor=capacity_factor, **kw)

    mp = pytest.MonkeyPatch()
    mp.setattr(ttfm, "apply_moe", spy)
    try:
        eng = teng.InferenceEngine(tcfg, tp, device="cpu", slots=2,
                                   cache_len=32)
        eng.submit(np.asarray([1, 2, 3], np.int32), max_new=2)
        eng.run_to_completion()
        eng_seen = set(seen)
        seen.clear()
        tsplit.SplitServer(tcfg, tp, device="cpu").generate(
            torch.from_numpy(_tokens(1, 1, 3)), 1, max_new=2)
        split_seen = set(seen)
    finally:
        mp.undo()
    assert eng_seen == {(3, 1.25), (1, 2.0)}
    assert split_seen == {(3, 1.25), (1, 1.25)}
