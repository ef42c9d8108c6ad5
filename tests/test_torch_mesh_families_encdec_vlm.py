"""The encoder-decoder and the VLM on a data 2 x model 2 mesh against the
JAX package's own mesh path (``torch_mesh_family_cases``: one float32
train step from the same weights and batch; the loss, aux, grad_norm,
the updated parameters and every gradient leaf).

* seamless-m4t (2 encoder and 2 decoder layers, 2 heads, 2 kv heads):
  the encoder stack runs under the same mesh, each decoder block's
  cross attention on the rank's heads (k/v heads shard too) with ``wo``
  ending in an all-reduce; ``src_embeds`` are rows of the batch.
* internvl2 (3 q heads padded to 4 for tp 2, one replicated kv head)
  with its patch prefix: ``patch_embeds`` are rows of the batch with
  the tokens, and the prefix is cut before the loss.
"""
import pytest

torch = pytest.importorskip("torch")

from torch_mesh_family_cases import (  # noqa: E402
    assert_grads, assert_metrics, assert_remesh, assert_updates, run_cases)

CASES = (("seamless", "seamless-m4t-large-v2",
          dict(layers=2, d_model=32, heads=2, kv_heads=2, d_ff=64,
               vocab=300), (2, 2), ("grads", "remesh")),
         ("internvl2_prefix", "internvl2-1b",
          dict(layers=2, d_model=48, heads=3, kv_heads=1, d_ff=64,
               vocab=300), (2, 2), ("grads", "remesh")))
IDS = [c[0] for c in CASES]


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    return run_cases(CASES, tmp_path_factory.mktemp("mesh_encdec_vlm"))


@pytest.mark.parametrize("case", CASES, ids=IDS)
@pytest.mark.parametrize("metric", ["loss", "aux", "grad_norm"])
def test_encdec_vlm_mesh_step_metrics_match_the_reference(worlds, case,
                                                          metric):
    assert_metrics(*worlds, case, metric)


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_encdec_vlm_mesh_step_updates_match_the_reference(worlds, case):
    assert_updates(*worlds, case)


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_encdec_vlm_mesh_gradients_match_the_reference(worlds, case):
    assert_grads(*worlds, case)


def test_the_vlm_batch_carries_its_prefix_and_pads_its_heads(worlds):
    """internvl2's batch has 4 patch embeddings a row; its 3 q heads are
    4 in the reference's tree, the padded head's ``wo`` rows zero."""
    from repro_torch import interop
    from torch_mesh_family_cases import cfg_of
    ref, _ = worlds
    name, arch, kw, _, _ = CASES[1]
    cfg = cfg_of(arch, kw)
    assert ref[name]["batch"]["patch_embeds"].shape[:2] == (4, 4)
    p0 = interop.lm_params_from_numpy(cfg, ref[name]["params"])
    assert p0["layers"][0]["mix"]["wq"].shape[1] == 4
    assert not p0["layers"][0]["mix"]["wo"][3:].any()


REMESH = [c for c in CASES if "remesh" in c[4]]


@pytest.mark.parametrize("case", REMESH, ids=[c[0] for c in REMESH])
def test_remesh_state_onto_a_data_mesh_steps_on_as_an_unbroken_run(worlds,
                                                                   case):
    """The live weights and moments after one step, re-cut by
    ``remesh_state`` onto data 4 x model 1, step on as the second step
    of an unbroken one-process run."""
    assert_remesh(*worlds, case)
