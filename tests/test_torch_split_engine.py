"""The port's serving layer against the JAX package's on the same weights:
``SplitServer`` (split == unsplit at every split, tokens and failover
accounting equal to the reference's), ``InferenceEngine`` (the cases of
``tests/test_engine.py``, each against the reference engine), the
failover prices, and the Li-GD split choice on a transformer profile.

Models: reduced starcoder2-3b in float32 with randomised norm weights
(``torch_diff.model_pair``).  Greedy tokens must be equal; logits of the
split and unsplit port are equal bit for bit (the same ops in the same
order), and within rtol 1e-4 of the reference's."""
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import costs as jcosts                               # noqa
from repro.core.ligd import LiGDConfig as JCfg                       # noqa
from repro.core.ligd import solve_ligd_batch_jit                     # noqa
from repro.core.profile import profile_transformer as j_profile_tf   # noqa
from repro.configs import get_config as j_get_config                 # noqa
from repro.runtime.meshenv import CPU_ENV                            # noqa
from repro.serving import engine as jeng                             # noqa
from repro.serving import failover as jfail                          # noqa
from repro.serving import split as jsplit                            # noqa
from repro_torch.configs import get_config                           # noqa
from repro_torch.core import costs as tcosts                         # noqa
from repro_torch.core.ligd import LiGDConfig as TCfg                 # noqa
from repro_torch.core.ligd import solve_ligd_batch                   # noqa
from repro_torch.core.profile import profile_transformer             # noqa
from repro_torch.launch import serve_split                           # noqa
from repro_torch.models import transformer as ttfm                   # noqa
from repro_torch.serving import engine as teng                       # noqa
from repro_torch.serving import failover as tfail                    # noqa
from repro_torch.serving import split as tsplit                      # noqa

from torch_diff import (assert_discrete, model_pair, near_ties,      # noqa
                        np_of, t_greedy)


@pytest.fixture(scope="module")
def split_model():
    return model_pair("starcoder2-3b", layers=4, seed=1)


@pytest.fixture(scope="module")
def engine_model():
    return model_pair("starcoder2-3b", layers=2, seed=2)


def _tokens(seed, B, S, V=257):
    return np.random.default_rng(seed).integers(0, V, (B, S))


# ---------------------------------------------------------------------------
# SplitServer
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("split", [0, 1, 2, 3, 4])
def test_split_prefill_matches_unsplit(split_model, split):
    jcfg, jp, tcfg, tp = split_model
    tok = _tokens(1, 2, 8)
    ref_logits, _ = ttfm.prefill(tcfg, tp, {"tokens": torch.from_numpy(tok)},
                                 cache_len=16)
    server = tsplit.SplitServer(tcfg, tp, device="cpu")
    logits, nxt, (dev_c, edge_c) = server.prefill(tok, split, cache_len=16)
    assert len(dev_c) == split and len(edge_c) == tcfg.num_layers - split
    assert torch.equal(logits, ref_logits)
    j_logits, _, _ = jsplit.SplitServer(jcfg, jp, CPU_ENV).prefill(
        jnp.asarray(tok), split, cache_len=16)
    np.testing.assert_allclose(np_of(logits), np.asarray(j_logits),
                               rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("split", [1, 3])
def test_split_generation_matches_unsplit_and_reference(split_model, split):
    jcfg, jp, tcfg, tp = split_model
    tok = _tokens(2, 1, 6)
    out = tsplit.SplitServer(tcfg, tp, device="cpu").generate(
        torch.from_numpy(tok), split, max_new=5)
    unsplit, _ = t_greedy(tcfg, tp, tok, 5)
    ref = jsplit.SplitServer(jcfg, jp, CPU_ENV).generate(
        jnp.asarray(tok), split, max_new=5)
    np.testing.assert_array_equal(np_of(out), unsplit)
    np.testing.assert_array_equal(np_of(out), np.asarray(ref))


def test_layer_params_match_reference(split_model):
    jcfg, jp, tcfg, tp = split_model
    seen = set()
    for i in range(tcfg.num_layers):
        t = tsplit.layer_params(tcfg, tp, i)
        j = jsplit.layer_params(jcfg, jp["stack"], i)
        np.testing.assert_array_equal(np_of(t["mix"]["wq"]),
                                      np.asarray(j["mix"]["wq"]))
        seen.add(round(float(t["mix"]["wq"].abs().sum()), 3))
    assert len(seen) == tcfg.num_layers
    with pytest.raises(IndexError):
        tsplit.layer_params(tcfg, tp, tcfg.num_layers)


def test_same_activation_payload_as_planner_prices(split_model):
    jcfg, jp, tcfg, tp = split_model
    tok = torch.from_numpy(_tokens(3, 2, 8))
    h, caches = tsplit.device_prefix(tcfg, tp, tok, 2, cache_len=16)
    assert tuple(h.shape) == (2, 8, tcfg.d_model) and len(caches) == 2
    assert (tsplit.activation_bits(tcfg, 2, 8)
            == jsplit.activation_bits(jcfg, 2, 8) == 2 * 8 * 64 * 16)


def test_server_loss_raises_typed_error(split_model):
    _, _, tcfg, tp = split_model
    tok = _tokens(5, 1, 6)
    server = tsplit.SplitServer(tcfg, tp, device="cpu", name="edge-0")
    server.fail()
    with pytest.raises(tsplit.ServerLostError) as exc:
        server.prefill(tok, 2, cache_len=16)
    assert exc.value.server == "edge-0"
    server.restore()
    server.prefill(tok, 2, cache_len=16)
    with pytest.raises(ValueError, match="split"):
        server.prefill(tok, tcfg.num_layers + 1, cache_len=16)


def test_failover_matches_reference(split_model):
    """Losing the edge server after prefill + 2 decodes: the same tokens
    as an uninterrupted run, and the same relay accounting as the
    reference's FailoverReport."""
    jcfg, jp, tcfg, tp = split_model
    tok = _tokens(2, 1, 6)
    clean = tsplit.SplitServer(tcfg, tp, device="cpu").generate(
        torch.from_numpy(tok), 2, max_new=5)
    reports = []
    for mod, cfg, params, kw, t in (
            (tsplit, tcfg, tp, {"device": "cpu"}, tok),
            (jsplit, jcfg, jp, {"env": CPU_ENV}, jnp.asarray(tok))):
        primary = mod.SplitServer(cfg, params, name="edge-0", **kw)
        fallback = mod.SplitServer(cfg, params, name="edge-1", **kw)
        primary.fail(after_calls=3)
        out, report = primary.generate_with_failover(
            t, 2, max_new=5, fallbacks=[fallback], hops_back=2.0,
            bandwidth_hz=20e6)
        np.testing.assert_array_equal(np_of(out), np_of(clean))
        reports.append(report)
    t_rep, j_rep = reports
    assert t_rep.retries == j_rep.retries == 1
    te, je = t_rep.events[0], j_rep.events[0]
    assert (te.lost, te.tokens_done, te.relay_bits, te.mode) == (
        je.lost, je.tokens_done, je.relay_bits, je.mode)
    assert te.relay_s == je.relay_s and t_rep.relay_s == j_rep.relay_s
    assert t_rep.by_mode == j_rep.by_mode
    assert t_rep.tokens_preserved == j_rep.tokens_preserved == 3


def test_failover_exhausted_reraises(split_model):
    _, _, tcfg, tp = split_model
    primary = tsplit.SplitServer(tcfg, tp, device="cpu", name="edge-0")
    fallback = tsplit.SplitServer(tcfg, tp, device="cpu", name="edge-1")
    primary.fail()
    fallback.fail()
    with pytest.raises(tsplit.ServerLostError) as exc:
        primary.generate_with_failover(_tokens(6, 1, 6), 2, max_new=3,
                                       fallbacks=[fallback])
    assert exc.value.server == "edge-1"


def test_failover_prices_match_reference():
    rng = np.random.default_rng(0)
    leaves = [{"k": rng.standard_normal((1, 5, 2, 8)).astype(np.float32),
               "v": rng.standard_normal((1, 5, 2, 8)).astype(np.float32)}]
    tleaves = [{k: torch.from_numpy(v) for k, v in d.items()}
               for d in leaves]
    bits = jfail.leaf_bits(leaves)
    assert tfail.leaf_bits(leaves) == tfail.leaf_bits(tleaves) == bits
    assert (tfail.migration_price(bits, 3, 2e7)
            == jfail.migration_price(bits, 3, 2e7))
    assert (tfail.reprefill_price(40, 1024.0, 2, 2e7, 1e-3)
            == jfail.reprefill_price(40, 1024.0, 2, 2e7, 1e-3))


# ---------------------------------------------------------------------------
# InferenceEngine, case for case with tests/test_engine.py
# ---------------------------------------------------------------------------
def _engines(model, **kw):
    jcfg, jp, tcfg, tp = model
    return (teng.InferenceEngine(tcfg, tp, device="cpu", **kw),
            jeng.InferenceEngine(jcfg, jp, env=CPU_ENV, **kw))


def _run_both(model, prompts, max_new, **kw):
    t, j = _engines(model, **kw)
    rids = [(t.submit(p, max_new), j.submit(p, max_new)) for p in prompts]
    return rids, t.run_to_completion(), j.run_to_completion()


def _alone(model, prompt, max_new):
    _, _, tcfg, tp = model
    return t_greedy(tcfg, tp, np.asarray(prompt)[None], max_new)[0][0]


def test_engine_single_request(engine_model):
    p = np.asarray([5, 9, 2, 7], np.int32)
    [(rt, rj)], tout, jout = _run_both(engine_model, [p], 6, slots=2,
                                       cache_len=512)
    assert tout[rt] == jout[rj] == list(_alone(engine_model, p, 6))


def test_engine_concurrent_requests_isolated(engine_model):
    prompts = [np.asarray([1, 2, 3], np.int32),
               np.asarray([9, 8, 7, 6, 5], np.int32),
               np.asarray([4, 4], np.int32)]
    rids, tout, jout = _run_both(engine_model, prompts, 5, slots=3,
                                 cache_len=512)
    for (rt, rj), p in zip(rids, prompts):
        assert tout[rt] == jout[rj] == list(_alone(engine_model, p, 5))


def test_engine_more_requests_than_slots(engine_model):
    prompts = [np.asarray([i + 1, i + 2, i + 3], np.int32) for i in range(4)]
    rids, tout, jout = _run_both(engine_model, prompts, 4, slots=2,
                                 cache_len=512)
    assert len(tout) == 4
    for rt, rj in rids:
        assert tout[rt] == jout[rj]


@pytest.mark.parametrize("n", [1, 64, 65, 4096, 4097, 10_000])
def test_bucket_matches_reference(n):
    assert teng._bucket(n) == jeng._bucket(n)


def test_engine_slots_freed_and_reused(engine_model):
    t, _ = _engines(engine_model, slots=2, cache_len=512)
    t.submit(np.asarray([1, 2, 3], np.int32), max_new=2)
    t.submit(np.asarray([4, 5], np.int32), max_new=3)
    assert t.free_slots == 2
    t.admit()
    assert t.free_slots == 0
    t.run_to_completion()
    assert t.free_slots == 2
    p = np.asarray([7, 8, 9], np.int32)
    r3 = t.submit(p, max_new=2)
    assert t.run_to_completion()[r3] == list(_alone(engine_model, p, 2))


def test_engine_admission_is_fifo(engine_model):
    t, j = _engines(engine_model, slots=2, cache_len=512)
    for eng in (t, j):
        rids = [eng.submit(np.asarray([i + 1, i + 2], np.int32), max_new=3)
                for i in range(4)]
        assert eng.admit() == rids[:2]
        assert eng.admit() == []
        eng.run_to_completion()
        assert all(len(eng.requests[r].out) == 3 for r in rids)
    assert ({r: q.out for r, q in t.requests.items()}
            == {r: q.out for r, q in j.requests.items()})


def test_engine_run_to_completion_never_silently_drops(engine_model):
    errs = []
    for eng in _engines(engine_model, slots=1, cache_len=512):
        eng.submit(np.asarray([1, 2], np.int32), max_new=5)
        eng.submit(np.asarray([3, 4], np.int32), max_new=5)
        with pytest.raises(RuntimeError) as ei:
            eng.run_to_completion(max_steps=2)
        errs.append(ei.value)
        done = eng.run_to_completion()
        assert len(done[0]) == len(done[1]) == 5
    te, je = errs
    assert isinstance(te, teng.IncompleteRunError)
    assert (te.queued, te.active, te.partial) == (je.queued, je.active,
                                                  je.partial)


def test_engine_cancel_returns_partial_and_frees_slot(engine_model):
    t, j = _engines(engine_model, slots=1, cache_len=512)
    for eng in (t, j):
        r1 = eng.submit(np.asarray([1, 2, 3], np.int32), max_new=4)
        r2 = eng.submit(np.asarray([6, 7], np.int32), max_new=4)
        eng.step()
        assert eng.free_slots == 0
    assert t.cancel(r1) == j.cancel(r1) and t.free_slots == 1
    with pytest.raises(KeyError):
        t.cancel(r1)
    assert t.cancel(r2) == [] and t.run_to_completion() == {}


def test_engine_export_import_continues_the_stream(engine_model):
    """Export a running stream mid-decode, import it into an engine with
    a smaller cache (the exact-fit boundary), and the continued stream
    equals the uninterrupted one and the reference's."""
    p = np.asarray([5, 9, 2, 7], np.int32)
    want = list(_alone(engine_model, p, 8))
    for src, dst in zip(_engines(engine_model, slots=2, cache_len=512),
                        _engines(engine_model, slots=2, cache_len=16)):
        rid = src.submit(p, max_new=8)
        src.admit()
        src.step()
        src.step()
        produced = list(src.requests[rid].out)
        leaves, pos = src.export_cache(rid)
        assert pos == len(p) + len(produced) - 1
        ctx = np.concatenate([p, np.asarray(produced, np.int32)])
        rid2 = dst.import_cache(ctx, 8 - len(produced), leaves, pos)
        assert produced + dst.run_to_completion()[rid2] == want


def test_engine_import_overflow_raises_typed_error(engine_model):
    t, _ = _engines(engine_model, slots=1, cache_len=512)
    p = np.asarray([5, 9, 2, 7], np.int32)
    rid = t.submit(p, max_new=8)
    t.admit()
    t.step()
    leaves, pos = t.export_cache(rid)
    ctx = np.concatenate([p, np.asarray(t.requests[rid].out, np.int32)])
    dst, _ = _engines(engine_model, slots=1, cache_len=8)
    with pytest.raises(teng.CacheOverflowError, match="cache_len=8"):
        dst.import_cache(ctx, 4, leaves, pos)
    rid2 = dst.import_cache(ctx, 3, leaves, pos)
    assert len(dst.run_to_completion()[rid2]) == 3
    with pytest.raises(ValueError):
        dst.import_cache(ctx, 0, leaves, pos)


def test_engine_slot_write_backstop(engine_model):
    t, _ = _engines(engine_model, slots=1, cache_len=512)
    p = np.asarray([5, 9, 2, 7], np.int32)
    rid = t.submit(p, max_new=30)
    t.admit()
    for _ in range(16):
        t.step()
    leaves, pos = t.export_cache(rid)
    assert pos == 20
    ctx = np.concatenate([p, np.asarray(t.requests[rid].out, np.int32)])
    dst, _ = _engines(engine_model, slots=1, cache_len=16)
    with pytest.raises(teng.CacheOverflowError, match="exceeds pool slot"):
        dst.import_cache(ctx, 1, leaves, pos=10)


def test_engine_max_new_one_completes_at_prefill(engine_model):
    p = np.asarray([5, 6, 7], np.int32)
    outs = []
    for eng in _engines(engine_model, slots=1, cache_len=512):
        rid = eng.submit(p, max_new=1)
        assert eng.admit() == [rid]
        assert eng.free_slots == 1
        outs.append(eng.pop_result(rid))
        assert eng.step() == []
    assert outs[0] == outs[1] == list(_alone(engine_model, p, 1))


# ---------------------------------------------------------------------------
# the split choice on a transformer profile
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("seq", [128, 1024])
def test_split_choice_matches_reference(seq):
    X = 64
    c_dev = np.random.default_rng(seq).uniform(1e9, 60e9, X)
    jp = j_profile_tf(j_get_config("starcoder2-3b"), seq=seq)
    tp = profile_transformer(get_config("starcoder2-3b"), seq=seq)
    jcols = jcosts.DeviceFleet(c_dev=c_dev).arrays
    jd = {k: jnp.asarray(v, jnp.float32) for k, v in jcols.items()}
    je = {k: jnp.asarray(float(getattr(jcosts.EdgeParams(), k)), jnp.float32)
          for k in jcosts.EDGE_FIELDS}
    td = tcosts.rows_to_device(tcosts.DeviceFleet(c_dev=c_dev).arrays,
                               "cpu", X)
    te = tcosts.edge_dict(tcosts.EdgeParams(), "cpu")
    rj = solve_ligd_batch_jit(jp, jd, je, JCfg(max_iters=200))
    rt = solve_ligd_batch(tp, td, te, TCfg(max_iters=200))
    assert_discrete(rt.split.long(), np.asarray(rj.split, np.int64),
                    near_ties(rj.U_per_layer), "split")


def test_launcher_plan_matches_reference():
    """``launch.serve_split.plan_split`` is the reference example's plan
    (one user, c_dev 5e9, default edge) through the batched solve."""
    cfg = get_config("starcoder2-3b")
    plan = serve_split.plan_split(cfg, seq=1024, batch=1, c_dev=5e9,
                                  device="cpu")
    jp = j_profile_tf(j_get_config("starcoder2-3b"), seq=1024)
    jd = {k: jnp.asarray(v, jnp.float32) for k, v in
          jcosts.DeviceFleet(c_dev=np.asarray([5e9])).arrays.items()}
    je = {k: jnp.asarray(float(getattr(jcosts.EdgeParams(), k)), jnp.float32)
          for k in jcosts.EDGE_FIELDS}
    rj = solve_ligd_batch_jit(jp, jd, je, JCfg(max_iters=200))
    assert plan["split"] == int(rj.split[0])
    assert plan["B_hz"] == pytest.approx(float(rj.B[0]), rel=1e-4)


def test_launcher_cpu_run_matches():
    assert serve_split.main(["--device", "cpu", "--layers", "3",
                             "--prompt-len", "8", "--new-tokens", "4"]) == 0
