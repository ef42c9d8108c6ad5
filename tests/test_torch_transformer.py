"""The port's dense decoder (``repro_torch.models.transformer``) against
the JAX package's on the same weights, and the model-side pieces around
it: configs, transformer layer profiles, the refused model families and
the weight conversion.

Weights come from the reference's ``init_lm`` (numpy leaves, norm
weights randomised so that the ``(1 + w)`` convention is exercised)
through ``interop.lm_params_from_numpy``.  Tolerances:

* float32: prefill logits to rtol 1e-4 (atol 1e-5 for logits near zero):
  sums run in another order and XLA's and ATen's sin/cos/pow differ by
  ulps; greedy tokens from ``prefill`` + ``decode_step`` exactly.
* bfloat16: logits to atol 0.08 / rtol 0.02, the reference's own bound
  for the same model computed in two orders (tests/test_split_serving.py).
* Layer profiles: bit for bit (closed-form numpy counts).
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import get_config as j_get_config                # noqa
from repro.configs import reduced as j_reduced                      # noqa
from repro.core.profile import profile_of as j_profile_of           # noqa
from repro.core.profile import profile_transformer as j_profile_tf  # noqa
from repro.models import transformer as jtfm                        # noqa
from repro.runtime.meshenv import CPU_ENV                           # noqa
from repro_torch.configs import ARCH_IDS, get_config, reduced       # noqa
from repro_torch.core.profile import profile_of, profile_transformer  # noqa
from repro_torch.models import transformer as ttfm                  # noqa
from repro_torch.serving import InferenceEngine, SplitServer        # noqa

from torch_diff import j_greedy, model_pair, np_of, t_greedy        # noqa


# ---------------------------------------------------------------------------
# configs and profiles
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_configs_match_reference(arch):
    t, j = get_config(arch), j_get_config(arch)
    assert dataclasses.asdict(t) == dataclasses.asdict(j)
    assert t.num_params() == j.num_params()
    assert t.layer_types() == j.layer_types()
    assert (dataclasses.asdict(reduced(t, layers=3))
            == dataclasses.asdict(j_reduced(j, layers=3)))


@pytest.mark.parametrize("arch", ARCH_IDS)
@pytest.mark.parametrize("mode,seq,batch", [("prefill", 1024, 1),
                                            ("decode", 4096, 8)])
def test_profile_transformer_bit_for_bit(arch, mode, seq, batch):
    t = profile_transformer(get_config(arch), seq=seq, batch=batch,
                            mode=mode)
    j = j_profile_tf(j_get_config(arch), seq=seq, batch=batch, mode=mode)
    assert t.name == j.name
    assert t.flops.dtype == np.float64 and t.out_bits.dtype == np.float64
    np.testing.assert_array_equal(t.flops, j.flops)
    np.testing.assert_array_equal(t.out_bits, j.out_bits)
    assert (t.in_bits, t.result_bits) == (j.in_bits, j.result_bits)
    assert t.fingerprint == j.fingerprint


def test_profile_of_takes_a_model_config():
    t = profile_of(get_config("starcoder2-3b"), seq=512)
    j = j_profile_of(j_get_config("starcoder2-3b"), seq=512)
    assert t.fingerprint == j.fingerprint
    assert t.num_layers == 30


def test_starcoder2_3b_full_size():
    """The configuration the card runs: 30 layers, d_model 3072, 24/2
    heads of 128, d_ff 12288, vocab 49152, bf16; 4.31 B parameters."""
    cfg = get_config("starcoder2-3b")
    assert (cfg.num_layers, cfg.d_model, cfg.num_heads, cfg.num_kv_heads,
            cfg.head_dim, cfg.d_ff, cfg.vocab_size, cfg.dtype) == (
        30, 3072, 24, 2, 128, 12288, 49152, "bfloat16")
    assert round(cfg.num_params() / 1e9, 2) == 4.31


# ---------------------------------------------------------------------------
# the model against the reference
# ---------------------------------------------------------------------------
def test_lm_params_from_numpy_layout():
    jcfg, jp, tcfg, tp = model_pair("starcoder2-3b", layers=3)
    assert len(tp["layers"]) == 3
    blk = tp["layers"][2]
    assert tuple(blk["mix"]["wq"].shape) == (64, 2, 32)
    assert tuple(blk["mix"]["wo"].shape) == (2, 32, 64)
    assert tuple(blk["ffn"]["wd"].shape) == (128, 64)
    assert tuple(tp["embed"].shape) == (384, 64)          # 257 padded
    np.testing.assert_array_equal(
        np_of(blk["mix"]["wk"]),
        np.asarray(jp["stack"]["scan"][0]["mix"]["wk"][2]))
    assert not np.allclose(np_of(blk["ln1"]), 0.0)


@pytest.mark.parametrize("arch", ["starcoder2-3b", "qwen3-8b"])
def test_prefill_and_greedy_decode_match_reference_f32(arch):
    jcfg, jp, tcfg, tp = model_pair(arch, layers=2)
    tokens = np.random.default_rng(1).integers(0, 257, (2, 11))
    j_tok, j_logits = j_greedy(jcfg, jp, tokens, 6)
    t_tok, t_logits = t_greedy(tcfg, tp, tokens, 6)
    np.testing.assert_allclose(t_logits, j_logits, rtol=1e-4, atol=1e-5)
    np.testing.assert_array_equal(t_tok, j_tok)


def test_prefill_logits_match_reference_bf16():
    jcfg, jp, tcfg, tp = model_pair("starcoder2-3b", layers=2,
                                    dtype="bfloat16")
    tokens = np.random.default_rng(2).integers(0, 257, (2, 9))
    logits_j, _ = jtfm.prefill(jcfg, jp, CPU_ENV,
                               {"tokens": jnp.asarray(tokens)}, cache_len=16)
    logits_t, _ = ttfm.prefill(tcfg, tp,
                               {"tokens": torch.from_numpy(tokens)},
                               cache_len=16)
    assert logits_t.dtype == torch.bfloat16
    np.testing.assert_allclose(np_of(logits_t.float()),
                               np.asarray(logits_j, np.float32),
                               atol=0.08, rtol=0.02)


def test_decode_step_vector_positions_match_reference():
    """Continuous batching: per-row positions and per-row cache writes."""
    jcfg, jp, tcfg, tp = model_pair("starcoder2-3b", layers=2)
    rng = np.random.default_rng(3)
    cj, _ = jtfm.init_caches(jcfg, CPU_ENV, 3, 16)
    ct = ttfm.init_caches(tcfg, 3, 16, "cpu")
    for step in range(3):
        tok = rng.integers(0, 257, (3, 1))
        pos = np.asarray([2, 7, 15]) - 2 + step
        lj, nj, cj = jtfm.decode_step(jcfg, jp, CPU_ENV, jnp.asarray(tok),
                                      jnp.asarray(pos, jnp.int32), cj)
        lt, nt, ct = ttfm.decode_step(tcfg, tp, torch.from_numpy(tok),
                                      torch.from_numpy(pos), ct)
        np.testing.assert_allclose(np_of(lt), np.asarray(lj), rtol=1e-4,
                                   atol=1e-5)
        np.testing.assert_array_equal(np_of(nt), np.asarray(nj))
    np.testing.assert_allclose(
        np_of(ct[1]["k"]), np.asarray(cj["scan"][0]["mix"]["k"][1]),
        rtol=1e-4, atol=1e-5)


def test_init_lm_shapes_and_seed():
    cfg = reduced(get_config("starcoder2-3b"), layers=2)
    a = ttfm.init_lm(cfg, torch.Generator().manual_seed(5))
    b = ttfm.init_lm(cfg, torch.Generator().manual_seed(5))
    assert a["embed"].dtype == torch.bfloat16
    assert tuple(a["unembed"].shape) == (64, 384)
    torch.testing.assert_close(a["layers"][1]["ffn"]["wg"],
                               b["layers"][1]["ffn"]["wg"])
    assert float(a["layers"][0]["ln1"].abs().sum()) == 0.0
    std = a["layers"][0]["mix"]["wq"].float().std().item()
    assert abs(std - 64 ** -0.5) < 0.02


@pytest.mark.parametrize("arch, what", [
    ("seamless-m4t-large-v2", "encoder-decoder")])
def test_unported_families_raise(arch, what):
    """The encoder-decoder stack, refused until its port, now builds: an
    encoder of ``num_enc_layers`` blocks and ``enc_norm``, a cross
    attention (no qk-norm) in every decoder block, and one cache tree a
    block, its cross k/v included."""
    cfg = reduced(get_config(arch), layers=2)
    assert what == "encoder-decoder" and cfg.enc_dec
    params = ttfm.init_lm(cfg, torch.Generator().manual_seed(0))
    assert len(params["encoder"]) == cfg.num_enc_layers
    assert tuple(params["enc_norm"].shape) == (cfg.d_model,)
    for blk in params["layers"]:
        assert set(blk) == {"ln1", "mix", "ln_cross", "cross", "ln2", "ffn"}
        assert set(blk["cross"]) == {"wq", "wk", "wv", "wo"}
    assert all("cross" not in blk for blk in params["encoder"])
    caches = ttfm.init_caches(cfg, 2, 16, "cpu", cross_len=9)
    assert len(caches) == cfg.num_layers
    for c in caches:
        assert tuple(c["k"].shape) == (2, 16, cfg.num_kv_heads,
                                       cfg.head_dim)
        assert tuple(c["cross"]["k"].shape) == (2, 9, cfg.num_kv_heads,
                                                cfg.head_dim)
        assert c["cross"]["v"].dtype == torch.bfloat16


@pytest.mark.parametrize("arch, what", [
    ("gemma3-27b", "local"), ("recurrentgemma-9b", "rglru")])
def test_local_and_rglru_families_are_ported(arch, what):
    """Sliding-window attention and RG-LRU blocks, refused before kernel
    row 6 was ported, now build, with one cache tree per block."""
    cfg = reduced(get_config(arch), layers=2)
    assert what in cfg.layer_types()
    params = ttfm.init_lm(cfg, torch.Generator().manual_seed(0))
    caches = ttfm.init_caches(cfg, 2, 16, "cpu")
    for lt, blk, c in zip(cfg.layer_types(), params["layers"], caches):
        if lt == "rglru":
            assert set(blk["mix"]) == {"wx", "wy", "wo", "conv_w", "gate_a",
                                       "gate_i", "a_param"}
            assert set(c["mix"]) == {"h", "conv"}
        else:
            L = cfg.window_size if lt == "local" else 16
            assert tuple(c["k"].shape) == (2, L, cfg.num_kv_heads,
                                           cfg.head_dim)


def test_int8_kv_cache_raises():
    """The int8 KV cache, refused until its port, now builds: int8 codes
    and float32 per-row scales (as tests/test_steps.py holds the
    reference's), with the reference's shapes and dtypes."""
    cfg = reduced(get_config("starcoder2-3b"), layers=2)
    caches = ttfm.init_caches(cfg, 1, 8, "cpu", kv_quant=True)
    jc, _ = jtfm.init_caches(j_reduced(j_get_config("starcoder2-3b"),
                                       layers=2), CPU_ENV, 1, 8,
                             kv_quant=True)
    jmix = jc["scan"][0]["mix"]
    for c in caches:
        assert set(c) == {"k", "v", "k_scale", "v_scale"}
        for name in c:
            assert tuple(c[name].shape) == jmix[name].shape[1:]
            assert str(c[name].dtype).split(".")[1] == jmix[name].dtype.name
    assert {c["k"].dtype for c in caches} == {torch.int8}
    assert {c["k_scale"].dtype for c in caches} == {torch.float32}


@pytest.mark.parametrize("arch, entry", [
    ("starcoder2-3b", "split"), ("starcoder2-3b", "engine"),
    ("starcoder2-3b", "launch"), ("granite-moe-1b-a400m", "split"),
    ("granite-moe-1b-a400m", "engine"), ("rwkv6-3b", "split"),
    ("rwkv6-3b", "engine"), ("recurrentgemma-9b", "split"),
    ("recurrentgemma-9b", "engine")])
def test_device_none_means_cuda(arch, entry, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = reduced(get_config(arch), layers=2)
    params = ttfm.init_lm(cfg, torch.Generator().manual_seed(0))
    with pytest.raises(RuntimeError, match="cuda"):
        if entry == "split":
            SplitServer(cfg, params)
        elif entry == "engine":
            InferenceEngine(cfg, params)
        else:
            from repro_torch.launch import serve_split
            serve_split.main([])
