"""Serving the dense decoder and the VLM on a mesh against the JAX
package's own mesh path (``torch_mesh_serve_cases``: a float32 prefill
into a longer cache and three greedy decode steps, from the same
weights and prompts; logits gathered over the vocab shards, the greedy
tokens, every cache leaf gathered whole, after the prefill and after
the last step), and the port's cache spec trees against the
reference's.

* kv 2 heads at data 2 x model 2: the caches shard by heads; decode
  attends with the local q heads over the local kv heads.
* kv 2 heads at model 4: the heads do not divide tp, so the cache
  length shards over the model axis; decode gathers every q head,
  takes a float32 partial over each rank's slots and merges them (the
  online softmax); each decode row at its own position, so rows write
  slots that different ranks own.  Again with int8 caches (codes and
  their scales sharded alike).
* internvl2 with its patch prefix at data 2 x model 2: 3 q heads padded
  to 4, one kv head: the length over the model axis, the rows over
  ``data``.
"""
import pytest

torch = pytest.importorskip("torch")

from torch_mesh_serve_cases import assert_case, run_cases        # noqa: E402

DENSE = dict(layers=2, d_model=64, heads=4, kv_heads=2, d_ff=64, vocab=300)
CASES = (("dense_heads", "qwen3-8b", DENSE, (2, 2), ()),
         ("dense_length", "qwen3-8b", DENSE, (1, 4), ("positions",)),
         ("dense_length_int8", "qwen3-8b", DENSE, (1, 4), ("kv_quant",)),
         ("internvl2_prefix", "internvl2-1b",
          dict(layers=2, d_model=48, heads=3, kv_heads=1, d_ff=64,
               vocab=300), (2, 2), ()))
IDS = [c[0] for c in CASES]


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    return run_cases(CASES, tmp_path_factory.mktemp("mesh_serve"))


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_prefill_and_decode_on_a_mesh_match_the_reference(worlds, case):
    assert_case(*worlds, case)
