"""RWKV-6 and RecurrentGemma on a data 2 x model 2 mesh against the JAX
package's own mesh path (``torch_mesh_family_cases``: one float32 train
step from the same weights and batch; the loss, aux, grad_norm and the
updated parameters).

* RWKV-6 with 2 heads: the time mix's heads shard (one a rank), the
  WKV recurrence runs on the rank's head with the decay cut to it, and
  ``wo`` ends in an all-reduce; the channel mix is tensor parallel.
* RWKV-6 with 3 heads, which do not divide tp 2: the time mix runs
  replicated on both model ranks (rwkv6-3b's 40 heads at tp 16), the
  channel mix still sharded.
* RecurrentGemma (rglru, rglru, local attention; 2 heads, a window of 8
  under 16-token sequences): the RG-LRU's channels shard (one gate
  block a rank), the local attention's q heads shard and its single kv
  head is replicated.

Every gradient leaf is held against the reference's ``jax.grad`` of its
mesh loss too: a replicated parameter feeding a sharded branch (``mu``,
``w0``, ``wA``, ``wB``) must get its gradient summed over the model
axis, a branch computed whole on every rank must not.
"""
import pytest

torch = pytest.importorskip("torch")

from torch_mesh_family_cases import (  # noqa: E402
    assert_grads, assert_metrics, assert_remesh, assert_updates, run_cases)

CASES = (("rwkv_heads_sharded", "rwkv6-3b",
          dict(layers=2, d_model=32, heads=2, d_ff=64, vocab=300), (2, 2),
          ("grads", "remesh")),
         ("rwkv_heads_replicated", "rwkv6-3b",
          dict(layers=2, d_model=48, heads=3, d_ff=64, vocab=300), (2, 2),
          ("grads",)),
         ("recurrentgemma", "recurrentgemma-9b",
          dict(layers=3, d_model=32, heads=2, kv_heads=1, d_ff=64,
               vocab=300), (2, 2), ("grads", "remesh")))
IDS = [c[0] for c in CASES]


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    return run_cases(CASES, tmp_path_factory.mktemp("mesh_recurrent"))


@pytest.mark.parametrize("case", CASES, ids=IDS)
@pytest.mark.parametrize("metric", ["loss", "aux", "grad_norm"])
def test_recurrent_mesh_step_metrics_match_the_reference(worlds, case,
                                                         metric):
    assert_metrics(*worlds, case, metric)


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_recurrent_mesh_step_updates_match_the_reference(worlds, case):
    assert_updates(*worlds, case)


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_recurrent_mesh_gradients_match_the_reference(worlds, case):
    assert_grads(*worlds, case)


def test_the_heads_shard_only_when_they_divide_tp():
    from repro_torch.models.rwkv import heads_sharded, time_mix_specs
    from repro_torch.runtime.meshenv import make_env
    from torch_mesh_family_cases import cfg_of
    env = make_env({"data": 2, "model": 2})
    for (_, arch, kw, _, _), sharded in zip(CASES[:2], (True, False)):
        cfg = cfg_of(arch, kw)
        assert heads_sharded(cfg, env) == sharded
        assert tuple(time_mix_specs(cfg, env)["wo"]) == (
            ("model" if sharded else None), None, None)


REMESH = [c for c in CASES if "remesh" in c[4]]


@pytest.mark.parametrize("case", REMESH, ids=[c[0] for c in REMESH])
def test_remesh_state_onto_a_data_mesh_steps_on_as_an_unbroken_run(worlds,
                                                                   case):
    """The live weights and moments after one step, re-cut by
    ``remesh_state`` onto data 4 x model 1, step on as the second step
    of an unbroken one-process run."""
    assert_remesh(*worlds, case)
