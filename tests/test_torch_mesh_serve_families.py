"""Serving the MoE and RWKV-6 families on a mesh against the JAX
package's own mesh path (``torch_mesh_serve_cases``: a float32 prefill
and three greedy decode steps; logits, tokens, every cache leaf).

* granite-moe (8 experts, top 2, the router scaled so that routing is
  uneven) at data 2 x model 2: expert parallelism, decode's capacity
  factor 2.0 per data shard (one row an expert for a shard's two
  tokens), and at data 2 x model 1: the global capacity rule over the
  eight rows, where a data rank's assignments count after every earlier
  data rank's.  The assignments that decode's capacity drops are
  counted on the ranks, and their sum over the mesh must not be zero.
* RWKV-6 with 2 heads at data 2 x model 2: the time-mix state by heads,
  one a rank, the serial WKV6 step at decode; and with 3 heads, which do
  not divide tp 2: the state and the time mix replicated.
"""
import pytest

torch = pytest.importorskip("torch")

from torch_mesh_serve_cases import (assert_case, members,        # noqa: E402
                                    run_cases)

MOE = dict(layers=2, d_model=32, heads=2, d_ff=32, vocab=300, experts=8)
CASES = (("moe_expert_parallel", "granite-moe-1b-a400m", MOE, (2, 2),
          ("drops",)),
         ("moe_data", "granite-moe-1b-a400m", MOE, (2, 1),
          ("drops", ("batch", 8))),
         ("rwkv_heads_sharded", "rwkv6-3b",
          dict(layers=2, d_model=32, heads=2, d_ff=64, vocab=300), (2, 2),
          ()),
         ("rwkv_heads_replicated", "rwkv6-3b",
          dict(layers=2, d_model=48, heads=3, d_ff=64, vocab=300), (2, 2),
          ()))
IDS = [c[0] for c in CASES]


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    return run_cases(CASES, tmp_path_factory.mktemp("mesh_serve_families"))


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_prefill_and_decode_on_a_mesh_match_the_reference(worlds, case):
    assert_case(*worlds, case)


@pytest.mark.parametrize("case", CASES[:2], ids=IDS[:2])
def test_moe_decode_drops_at_the_decode_capacity(worlds, case):
    _, ranks = worlds
    drops = [out[case[0]]["decode_drops"] for out in members(ranks,
                                                             case[3])]
    assert sum(drops) > 0, drops
