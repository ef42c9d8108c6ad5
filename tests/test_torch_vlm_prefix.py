"""The VLM patch prefix at prefill: reduced internvl2-1b (``frontend ==
"vit"``) through the JAX package's ``prefill`` and the port's, float32,
with and without ``patch_embeds`` drawn with numpy from a seed.

The reference's ``_assemble_inputs`` prepends the patch embeddings to the
token embeddings (scaled by sqrt(d)) and numbers positions over the
whole sequence; the port's ``prefill`` must do the same.  Tolerances are
those of ``test_prefill_and_greedy_decode_match_reference_f32``
(tests/test_torch_transformer.py): rtol 1e-4, atol 1e-5 on the logits,
and the same greedy next token.
"""
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.models import transformer as jtfm                        # noqa
from repro.runtime.meshenv import CPU_ENV                           # noqa
from repro_torch.models import transformer as ttfm                  # noqa

from torch_diff import model_pair, np_of                            # noqa

ARCH = "internvl2-1b"
RTOL, ATOL = 1e-4, 1e-5


@pytest.fixture(scope="module")
def pair():
    return model_pair(ARCH, layers=2)


def _batch(cfg, B, S, P, seed):
    rng = np.random.default_rng(seed)
    batch = {"tokens": rng.integers(0, 257, (B, S))}
    if P:
        batch["patch_embeds"] = rng.standard_normal(
            (B, P, cfg.d_model)).astype(np.float32)
    return batch


def _both(pair, batch, cache_len):
    jcfg, jp, tcfg, tp = pair
    lj, _ = jtfm.prefill(jcfg, jp, CPU_ENV,
                         {k: jnp.asarray(v) for k, v in batch.items()},
                         cache_len=cache_len)
    lt, caches = ttfm.prefill(tcfg, tp,
                              {k: torch.from_numpy(v)
                               for k, v in batch.items()},
                              cache_len=cache_len)
    return np.asarray(lj), np_of(lt), caches


@pytest.mark.parametrize("P", [0, 5])
def test_prefill_with_and_without_patches_matches_reference_f32(pair, P):
    jcfg, _, tcfg, _ = pair
    assert jcfg.frontend == tcfg.frontend == "vit"
    batch = _batch(tcfg, 2, 7, P, seed=P + 1)
    lj, lt, _ = _both(pair, batch, cache_len=16)
    np.testing.assert_allclose(lt, lj, rtol=RTOL, atol=ATOL)
    V = tcfg.vocab_size
    np.testing.assert_array_equal(np.argmax(lt[:, :V], -1),
                                  np.argmax(lj[:, :V], -1))


def test_patches_change_the_logits_and_fill_the_cache(pair):
    """The prefix is not dropped: the logits move with the patches, and
    the caches hold P + S positions, numbered over the whole sequence."""
    _, _, tcfg, _ = pair
    with_p = _batch(tcfg, 1, 6, 4, seed=9)
    without = {"tokens": with_p["tokens"]}
    lj_p, lt_p, caches = _both(pair, with_p, cache_len=16)
    _, lt_0, _ = _both(pair, without, cache_len=16)
    assert not np.allclose(lt_p, lt_0, rtol=1e-3, atol=1e-3)
    k = caches[0]["k"]
    assert k.shape[1] == 16
    assert torch.count_nonzero(k[0, :10].abs().sum(-1).sum(-1)) == 10
    assert torch.count_nonzero(k[0, 10:]) == 0
    np.testing.assert_allclose(lt_p, lj_p, rtol=RTOL, atol=ATOL)
