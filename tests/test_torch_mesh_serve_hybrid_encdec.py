"""Serving RecurrentGemma and the encoder-decoder on a mesh against the
JAX package's own mesh path (``torch_mesh_serve_cases``: a float32
prefill and three greedy decode steps; logits, tokens, every cache
leaf).

* RecurrentGemma (rglru, rglru, local attention with a window of 8) at
  batch 1 on data 2 x model 2, the long_500k layout: the batch does not
  shard, so each data rank serves the row as a replica; the RG-LRU's
  ``h`` and ``conv`` by channels; the one kv head does not divide tp,
  so the local layer's 8-slot ring shards over ``(data, model)``
  together, two slots a rank.  The 12-token prompt wraps the ring at
  prefill and decode goes on wrapping it (slot ``pos mod 8`` decides the
  owner), at per-sequence (B,) positions.
* seamless-m4t at data 2 x model 2: the encoder on the mesh, the self
  and cross caches by heads; at model 4 with 2 kv heads: both the self
  cache's length and the cross cache's source length shard over the
  model axis, and decode merges the flash forward's log-sum-exp over
  each rank's source rows.
"""
import pytest

torch = pytest.importorskip("torch")

from torch_mesh_serve_cases import assert_case, run_cases        # noqa: E402

CASES = (("recurrentgemma_batch_1", "recurrentgemma-9b",
          dict(layers=3, d_model=32, heads=2, kv_heads=1, d_ff=64,
               vocab=300), (2, 2), (("batch", 1), "positions")),
         ("seamless_heads", "seamless-m4t-large-v2",
          dict(layers=2, d_model=32, heads=2, d_ff=64, vocab=300), (2, 2),
          ()),
         ("seamless_length", "seamless-m4t-large-v2",
          dict(layers=2, d_model=64, heads=4, kv_heads=2, d_ff=64,
               vocab=300), (1, 4), (("source", 16),)))
IDS = [c[0] for c in CASES]


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    return run_cases(CASES, tmp_path_factory.mktemp("mesh_serve_hybrid"))


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_prefill_and_decode_on_a_mesh_match_the_reference(worlds, case):
    assert_case(*worlds, case)
