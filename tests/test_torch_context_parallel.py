"""Context-parallel attention (the reference's ``context_parallel_attn``)
against the JAX package.

* Row 3's plain forward and backward with ``q_offset`` (a sequence
  shard of q against the whole keys) against the reference's
  ``repro.models.attention.flash_attention`` run on the whole sequence
  and cut to the shard's rows, and ``jax.grad`` of it: causal, windowed
  and non-causal, at the first, a middle and the last shard; the masked
  pairs the cost report counts, the dK/dV kernel's q bands and the
  refusals.
* A data 2 x model 2 gloo world's float32 train step under the flag
  against the reference's jitted step on four forced host devices
  (``torch_mesh_family_cases``): the dense decoder, the MoE, the
  hybrid (local window 8 under a 16-token sequence), the
  encoder-decoder (its encoder non-causal, cross attention replicated)
  and the VLM with its patch prefix; loss and grad_norm within 1e-5
  relative, each update within 1e-2 of its RMS.
* Prefill and greedy decode under the flag against the reference's
  jitted mesh prefill and decode (``torch_mesh_serve_cases``): a prompt
  the model axis divides (the sequence shards) and one it does not
  (every head on every rank), over a heads-sharded and a length-sharded
  cache.
"""
import itertools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp                                           # noqa: E402

from repro.models.attention import flash_attention as j_flash     # noqa: E402
from repro_torch.kernels.flash_attention import backward as t_bwd  # noqa: E402
from repro_torch.kernels.flash_attention import ops as t_ops      # noqa: E402

import torch_mesh_family_cases as fam                            # noqa: E402
import torch_mesh_serve_cases as serve                           # noqa: E402

jax.config.update("jax_enable_x64", False)

#: float32 sums in other orders, on outputs and gradients of O(1) (a
#: gradient that is 0 exactly in the reference, a row whose only key
#: takes all its weight, comes out at ~1e-7 from the port's sums)
RTOL, ATOL = 1e-5, 1e-5
B, S, HQ, HKV, HD = 2, 48, 4, 2, 16
SHARD = S // 4
OFFSETS = (0, 2 * SHARD, S - SHARD)          # first, middle, last shard
MASKS = (("causal", True, 0), ("window", True, 10), ("full", False, 0))


def _inputs(seed: int):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, S, HQ, HD)).astype(np.float32)
    k = rng.standard_normal((B, S, HKV, HD)).astype(np.float32)
    v = rng.standard_normal((B, S, HKV, HD)).astype(np.float32)
    dout = rng.standard_normal((B, SHARD, HQ, HD)).astype(np.float32)
    return q, k, v, dout


@pytest.mark.parametrize("offset", OFFSETS)
@pytest.mark.parametrize("mask", MASKS, ids=[m[0] for m in MASKS])
def test_plain_forward_and_backward_at_an_offset_match_the_reference(
        mask, offset):
    _, causal, window = mask
    q, k, v, dout = _inputs(offset + 7 * window + causal)

    def ref_loss(q, k, v):
        out = j_flash(q, k, v, causal=causal, window=window, q_block=16,
                      kv_block=16)[:, offset:offset + SHARD]
        return jnp.sum(out * dout), out

    (_, want), grads = jax.value_and_grad(ref_loss, argnums=(0, 1, 2),
                                          has_aux=True)(q, k, v)
    tq = torch.from_numpy(q[:, offset:offset + SHARD].copy()).requires_grad_()
    tk = torch.from_numpy(k).requires_grad_()
    tv = torch.from_numpy(v).requires_grad_()
    out = t_ops.flash_attention(tq, tk, tv, causal=causal, window=window,
                                q_offset=offset)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want),
                               rtol=RTOL, atol=ATOL)
    dq, dk, dv = torch.autograd.grad(out, (tq, tk, tv),
                                     torch.from_numpy(dout))
    jq, jk, jv = (np.asarray(g) for g in grads)
    np.testing.assert_allclose(dq.numpy(), jq[:, offset:offset + SHARD],
                               rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(dk.numpy(), jk, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(dv.numpy(), jv, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("offset", OFFSETS)
def test_the_lse_forward_at_an_offset_is_the_whole_sequence_s_rows(offset):
    """``flash_attention_lse`` (the serving merge's forward) at an
    offset: the rows' output and log-sum-exp of the whole-sequence
    call."""
    q, k, v, _ = _inputs(offset)
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    whole, lse_whole, _ = t_ops.flash_attention_lse(tq, tk, tv, causal=True,
                                                    window=10)
    rows, lse_rows, _ = t_ops.flash_attention_lse(
        tq[:, offset:offset + SHARD].contiguous(), tk, tv, causal=True,
        window=10, q_offset=offset)
    torch.testing.assert_close(rows, whole[:, offset:offset + SHARD])
    torch.testing.assert_close(lse_rows,
                               lse_whole[..., offset:offset + SHARD])


def _brute_pairs(Sq, Skv, causal, window, off):
    qp = off + np.arange(Sq)[:, None]
    kp = np.arange(Skv)[None, :]
    keep = np.ones((Sq, Skv), bool)
    if causal:
        keep &= qp >= kp
    if window:
        keep &= (qp - kp) < window
    return keep


def test_pairs_count_the_shifted_masks():
    for Sq, Skv, causal, window in itertools.product(
            (1, 5, 16), (16, 40), (True, False), (0, 1, 7, 64)):
        for off in sorted({0, (Skv - Sq) // 2, Skv - Sq}):
            want = int(_brute_pairs(Sq, Skv, causal, window, off).sum())
            assert t_ops.pairs(Sq, Skv, causal, window, off) == want, (
                Sq, Skv, causal, window, off)


def test_the_dkdv_q_bands_follow_the_offset():
    """``band_q_tiles``: for each kv tile, the q tiles the dK/dV kernel
    walks are exactly those holding a kept pair with its keys (the
    causal band's first tile and the window's last, at the shifted
    positions), as a brute-force count over the mask finds them."""
    T = t_bwd.TILE
    for Sq, Skv, causal, window, off in (
            (256, 1024, True, 0, 768), (256, 1024, True, 0, 0),
            (256, 1024, True, 200, 512), (300, 700, True, 64, 400),
            (256, 1024, False, 100, 256), (1024, 1024, True, 0, 0)):
        keep = _brute_pairs(Sq, Skv, causal, window, off)
        want = []
        for kt in range(-(-Skv // T)):
            rows = np.nonzero(keep[:, kt * T:(kt + 1) * T].any(axis=1))[0]
            want.append(0 if rows.size == 0 else
                        rows[-1] // T - rows[0] // T + 1)
        got = t_bwd.band_q_tiles(Sq, Skv, causal, window, off)
        assert got == want, (Sq, Skv, causal, window, off)
    assert t_bwd.group_split(2, 1024, 4096, 24, 2, True, 0, 128, 3072) >= 1


def test_causal_sq_not_skv_needs_an_offset_and_offsets_stay_in_range():
    q, k, v, _ = _inputs(0)
    tq, tk, tv = (torch.from_numpy(a) for a in (q[:, :SHARD], k, v))
    with pytest.raises(ValueError, match="q_offset"):
        t_ops.flash_attention(tq, tk, tv, causal=True)
    for bad in (-1, S - SHARD + 1):
        with pytest.raises(ValueError, match="q_offset"):
            t_ops.flash_attention(tq, tk, tv, causal=True, q_offset=bad)
    # non-causal with no offset keeps q 0 at key 0, as before
    out = t_ops.flash_attention(tq, tk, tv, causal=False)
    torch.testing.assert_close(out, t_ops.flash_attention(
        tq, tk, tv, causal=False, q_offset=0))


# ---------------------------------------------------------------------------
# the CP train step on a mesh
# ---------------------------------------------------------------------------
DENSE = dict(layers=2, d_model=64, heads=4, kv_heads=1, d_ff=64, vocab=300)
TRAIN_CASES = (
    ("dense_cp", "starcoder2-3b", DENSE, (2, 2), ("cp",)),
    ("moe_cp", "granite-moe-1b-a400m",
     dict(layers=2, d_model=32, heads=2, kv_heads=2, d_ff=32, vocab=300),
     (2, 2), ("cp",)),
    ("hybrid_cp", "recurrentgemma-9b",
     dict(layers=3, d_model=32, heads=2, kv_heads=1, d_ff=64, vocab=300),
     (2, 2), ("cp",)),
    ("seamless_cp", "seamless-m4t-large-v2",
     dict(layers=2, d_model=32, heads=2, kv_heads=2, d_ff=64, vocab=300),
     (2, 2), ("cp",)),
    ("internvl2_cp", "internvl2-1b",
     dict(layers=2, d_model=48, heads=3, kv_heads=1, d_ff=64, vocab=300),
     (2, 2), ("cp",)))
TRAIN_IDS = [c[0] for c in TRAIN_CASES]


@pytest.fixture(scope="module")
def train_worlds(tmp_path_factory):
    return fam.run_cases(TRAIN_CASES, tmp_path_factory.mktemp("cp_train"))


@pytest.mark.parametrize("case", TRAIN_CASES, ids=TRAIN_IDS)
@pytest.mark.parametrize("metric", ["loss", "grad_norm"])
def test_the_cp_train_step_metrics_match_the_reference(train_worlds, case,
                                                       metric):
    fam.assert_metrics(*train_worlds, case, metric)


@pytest.mark.parametrize("case", TRAIN_CASES, ids=TRAIN_IDS)
def test_the_cp_train_step_updates_match_the_reference(train_worlds, case):
    fam.assert_updates(*train_worlds, case)


# ---------------------------------------------------------------------------
# CP prefill and decode on a mesh
# ---------------------------------------------------------------------------
SERVE_DENSE = dict(layers=2, d_model=64, heads=4, kv_heads=2, d_ff=64,
                   vocab=300)
SERVE_CASES = (
    ("cp_heads_divides", "qwen3-8b", SERVE_DENSE, (2, 2), ("cp",)),
    ("cp_heads_odd", "qwen3-8b", SERVE_DENSE, (2, 2), ("cp", ("prompt", 13))),
    ("cp_length_divides", "qwen3-8b", SERVE_DENSE, (1, 4),
     ("cp", "positions")),
    ("cp_length_odd", "qwen3-8b", SERVE_DENSE, (1, 4), ("cp", ("prompt", 13))),
    ("cp_hybrid", "recurrentgemma-9b",
     dict(layers=3, d_model=32, heads=2, kv_heads=1, d_ff=64, vocab=300),
     (2, 2), ("cp",)))
SERVE_IDS = [c[0] for c in SERVE_CASES]


@pytest.fixture(scope="module")
def serve_worlds(tmp_path_factory):
    return serve.run_cases(SERVE_CASES, tmp_path_factory.mktemp("cp_serve"))


@pytest.mark.parametrize("case", SERVE_CASES, ids=SERVE_IDS)
def test_cp_prefill_and_decode_match_the_reference(serve_worlds, case):
    serve.assert_case(*serve_worlds, case)
