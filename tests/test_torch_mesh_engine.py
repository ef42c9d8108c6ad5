"""The serving engine and the split server on a data 2 x model 2 mesh
(``InferenceEngine(env=)``, ``SplitServer(env=)``) against the JAX
package's own, with and without context-parallel attention
(``torch_mesh_engine_cases``): a reduced starcoder2-3b (4 q heads, one
kv head: the cache length shards over the model axis) and a reduced
recurrentgemma-9b (its ring of 8 under prompts of up to 12 tokens, the
RG-LRU state by channels), float32, four prompts of 5, 9, 12 and 7
tokens into 4 slots, 6 greedy tokens each.

* Every request's tokens equal the reference engine's, on every rank.
* A stream exported after 3 steps, cancelled and imported back into the
  same mesh engine goes on to the same tokens; its exported leaves are
  whole and equal a one-process engine's export at the same step (rtol
  1e-4, atol 1e-5: float32 sums in other orders).
* One split generation of a (2, 8) batch at block 1 equals the
  reference's ``SplitServer(env=).generate``, on every rank.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch_mesh_engine_cases import run_cases                     # noqa: E402

from repro_torch._tree import leaves                             # noqa: E402

RTOL, ATOL = 1e-4, 1e-5
STARCODER = dict(layers=2, d_model=64, heads=4, kv_heads=1, d_ff=64,
                 vocab=300)
HYBRID = dict(layers=3, d_model=32, heads=2, kv_heads=1, d_ff=64, vocab=300)
CASES = (("starcoder2", "starcoder2-3b", STARCODER, False),
         ("starcoder2_cp", "starcoder2-3b", STARCODER, True),
         ("hybrid", "recurrentgemma-9b", HYBRID, False),
         ("hybrid_cp", "recurrentgemma-9b", HYBRID, True))
IDS = [c[0] for c in CASES]


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    return run_cases(CASES, tmp_path_factory.mktemp("mesh_engine"))


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_the_mesh_engine_s_tokens_equal_the_reference_s(worlds, case):
    ref, ranks = worlds
    want = ref[case[0]]["engine"]
    for rank, out in enumerate(ranks):
        assert out[case[0]]["engine"] == want, rank


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_a_stream_migrated_on_the_mesh_goes_on_as_before(worlds, case):
    ref, ranks = worlds
    want = ref[case[0]]["engine"]
    for rank, out in enumerate(ranks):
        got = out[case[0]]
        assert got["migrated"] == want, rank
        mesh, one = got["exported"]
        for i, (a, b) in enumerate(zip(leaves(mesh), leaves(one))):
            assert a.shape == b.shape, (rank, i)
            np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=RTOL,
                                       atol=ATOL, err_msg=f"leaf {i}")


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_the_mesh_split_server_equals_the_reference_s(worlds, case):
    ref, ranks = worlds
    want = ref[case[0]]["split"]
    for rank, out in enumerate(ranks):
        np.testing.assert_array_equal(out[case[0]]["split"].numpy(), want,
                                      err_msg=f"rank {rank}")
