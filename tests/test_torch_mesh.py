"""The port's mesh (``runtime/meshenv.py``, ``launch/mesh.py``,
``runtime/elastic.py``) against the JAX package.

* Spec trees: the parameters' (``transformer.param_specs``, restacked
  as the reference's tree by ``_reference_specs``) and AdamW's
  (``runtime.train.opt_state_specs``, ZeRO-1) entry for entry against
  the reference's ``init_lm`` and ``opt_state_specs``, at data 2 x model
  2 for a reduced dense config and at data 16 x model 16 for full-width
  starcoder2-3b (24 -> 32 padded q heads), qwen3-8b and yi-34b (56 ->
  64), the reference traced by ``jax.eval_shape`` on an ``AbstractMesh``
  (nothing allocated, no forced devices).
* The vocab-sharded ops at model 2 and model 4 with a padded vocab (300
  -> 384), in a spawned four-rank gloo world (``torch_mesh_ranks``),
  against the reference's single-device ops (which the sharded ones
  must equal): ``embed_lookup``, ``fused_unembed_xent`` value and
  gradients (against ``jax.grad``) within 1e-5 (float32 sums in other
  orders), ``unembed_logits`` + ``sharded_argmax`` exactly, including a
  tie across two shards (the smallest global index wins).
* ``compressed_pod_mean`` at pod 2 against the reference's
  ``quantize_int8`` / ``dequantize_int8`` summed in pod order, bit for
  bit, over two calls (the second carrying the first's error feedback).
* ``shrink_mesh``'s edge cases, and a family other than the dense
  decoder raising on a mesh (ROADMAP item 8b).
"""
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax                                                       # noqa: E402
import jax.numpy as jnp                                          # noqa: E402
from jax.sharding import AbstractMesh                            # noqa: E402

from repro.configs import get_config as j_get_config             # noqa: E402
from repro.configs import reduced as j_reduced                   # noqa: E402
from repro.models import layers as j_layers                      # noqa: E402
from repro.models import sharded_ops as j_ops                    # noqa: E402
from repro.models import transformer as j_tfm                    # noqa: E402
from repro.runtime import compression as j_comp                  # noqa: E402
from repro.runtime import meshenv as j_meshenv                   # noqa: E402
from repro.runtime import train as j_train                       # noqa: E402
from repro_torch._tree import tree_map                            # noqa: E402
from repro_torch.configs import get_config, reduced              # noqa: E402
from repro_torch.models import layers as t_layers                # noqa: E402
from repro_torch.models import sharded_ops as t_ops              # noqa: E402
from repro_torch.models import transformer as t_tfm              # noqa: E402
from repro_torch.runtime import train as t_train                 # noqa: E402
from repro_torch.runtime.meshenv import P, make_env              # noqa: E402

from torch_mesh_ranks import ops_rank, run_world                  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
V, VP, D = 300, 384, 16
OPS_TOL = 1e-5


# ---------------------------------------------------------------------------
# spec trees
# ---------------------------------------------------------------------------
SPEC_CASES = (("reduced", 2, 2, False), ("reduced", 2, 2, True),
              ("starcoder2-3b", 16, 16, False), ("qwen3-8b", 16, 16, False),
              ("yi-34b", 16, 16, False))


def _cfgs(arch: str):
    if arch == "reduced":
        return (j_reduced(j_get_config("qwen3-8b"), layers=3, d_model=48,
                          heads=3, kv_heads=1),
                reduced(get_config("qwen3-8b"), layers=3, d_model=48,
                        heads=3, kv_heads=1))
    return j_get_config(arch), get_config(arch)


def _reference_specs(cfg, env) -> dict:
    """``transformer.param_specs`` in the reference's stacked tree
    (``stack`` = {``tail``, ``scan``}, a scan leaf's spec led by ``None``
    for its superblock axis): what the reference's ``init_lm(cfg, key,
    env)`` returns as its specs."""
    specs = t_tfm.param_specs(cfg, env)
    blocks = specs.pop("layers")
    period = len(cfg.pattern)
    rem = cfg.num_layers % period
    scan = tuple(tree_map(lambda sp: P(None, *sp), blocks[rem + j])
                 for j in range(period))
    specs["stack"] = {"tail": tuple(blocks[:rem]), "scan": scan}
    return specs


def _reference(jcfg, data: int, model: int, cp: bool):
    """The reference's (param specs, param shapes, env), traced only."""
    env = j_meshenv.make_env(AbstractMesh((data, model), ("data", "model")),
                             context_parallel_attn=cp)
    box = {}

    def init(key):
        params, box["specs"] = j_tfm.init_lm(jcfg, key, env)
        return params

    shapes = jax.eval_shape(init, jax.random.PRNGKey(0))
    return box["specs"], shapes, env


def _assert_same_specs(port, ref, where="") -> None:
    """Entry for entry: dict keys, tuple lengths, each spec's entries."""
    if isinstance(ref, dict):
        assert sorted(port) == sorted(ref), where
        for k in ref:
            _assert_same_specs(port[k], ref[k], f"{where}/{k}")
    elif isinstance(ref, j_meshenv.P):
        assert tuple(port) == tuple(ref), (where, port, ref)
    else:
        assert len(port) == len(ref), where
        for i, (a, b) in enumerate(zip(port, ref)):
            _assert_same_specs(a, b, f"{where}/{i}")


@pytest.mark.parametrize("arch,data,model,cp", SPEC_CASES)
@pytest.mark.parametrize("tree", ["params", "opt_state"])
def test_spec_trees_match_the_reference(arch, data, model, cp, tree):
    """``cp``: the reference's context-parallel attention replicates the
    attention weights; the port's specs follow, and its model refuses
    the mode (ROADMAP item 8b)."""
    jcfg, tcfg = _cfgs(arch)
    jspecs, shapes, jenv = _reference(jcfg, data, model, cp)
    env = make_env({"data": data, "model": model}, context_parallel_attn=cp)
    if cp:
        with pytest.raises(NotImplementedError, match="8b"):
            t_tfm.check_supported(tcfg, env)
    pspecs = _reference_specs(tcfg, env)
    if tree == "params":
        _assert_same_specs(pspecs, jspecs)
        return
    want = j_train.opt_state_specs(jspecs, shapes, jenv)
    got = t_train.opt_state_specs(
        pspecs, jax.tree.map(lambda a: a.shape, shapes), env)
    assert tuple(got.step) == tuple(want.step) == ()
    _assert_same_specs(got.m, want.m)
    _assert_same_specs(got.v, want.v)


@pytest.mark.parametrize("hq,hkv,tp", [(24, 2, 16), (56, 8, 16), (14, 2, 16),
                                       (3, 1, 2), (6, 3, 4), (32, 8, 2),
                                       (5, 5, 4)])
def test_padded_heads_and_vocab_are_the_reference_s(hq, hkv, tp):
    assert t_layers.padded_heads(hq, hkv, tp) == \
        j_layers.padded_heads(hq, hkv, tp)
    for vocab in (257, 49152, 151936):
        assert t_ops.padded_vocab(vocab, tp) == j_ops.padded_vocab(vocab, tp)


@pytest.mark.parametrize("arch", ["granite-moe-1b-a400m", "rwkv6-3b",
                                  "recurrentgemma-9b",
                                  "seamless-m4t-large-v2", "internvl2-1b"])
@pytest.mark.parametrize("layout", [{"data": 2, "model": 1},
                                    {"data": 1, "model": 2}])
def test_other_families_on_a_mesh_wait_for_item_8b(arch, layout):
    cfg = reduced(get_config(arch))
    env = make_env(layout)
    t_tfm.check_supported(cfg)                # one process: supported
    for call in (lambda: t_tfm.check_supported(cfg, env),
                 lambda: t_train.make_train_step(cfg, env=env),
                 lambda: t_tfm.param_specs(cfg, env)):
        with pytest.raises(NotImplementedError, match="8b"):
            call()


# ---------------------------------------------------------------------------
# the vocab-sharded ops, compressed_pod_mean and shrink_mesh on ranks
# ---------------------------------------------------------------------------
def _inputs(seed: int = 0) -> dict:
    rng = np.random.default_rng(seed)
    f32 = np.float32
    logits = rng.standard_normal((2, 3, VP)).astype(f32)
    logits[0, 1, 5] = logits[0, 1, 200] = logits[0, 1, 300] = 9.0
    return {"tied": rng.standard_normal((VP, D)).astype(f32) * f32(0.5),
            "untied": rng.standard_normal((D, VP)).astype(f32) * f32(0.5),
            "h": rng.standard_normal((2, 5, D)).astype(f32),
            "ids": rng.integers(0, V, (2, 5)),
            "tie_logits": logits,
            "grads": [rng.standard_normal((4, 2, 300)).astype(f32)
                      for _ in range(8)]}


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    x = _inputs()
    return x, run_world(ops_rank, 4, tmp_path_factory.mktemp("ops"), x)


def _ref_xent(x, tied: bool):
    table = x["tied"] if tied else x["untied"]

    def f(h, t):
        return j_ops.fused_unembed_xent(j_meshenv.CPU_ENV, h, t, x["ids"],
                                        transpose_table=tied, valid_vocab=V)

    loss = f(jnp.asarray(x["h"]), jnp.asarray(table))
    dh, dt = jax.grad(lambda h, t: jnp.sum(f(h, t)), argnums=(0, 1))(
        jnp.asarray(x["h"]), jnp.asarray(table))
    return np.asarray(loss), np.asarray(dh), np.asarray(dt)


def _close(got, want, what):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=OPS_TOL,
                               atol=OPS_TOL * np.abs(want).max(),
                               err_msg=what)


@pytest.mark.parametrize("tp", [2, 4])
@pytest.mark.parametrize("tied", [True, False])
def test_fused_unembed_xent_value_and_gradients(ranks, tp, tied):
    x, outs = ranks
    loss, dh, dt = _ref_xent(x, tied)
    for r, out in enumerate(outs):
        rec = out[tp][tied]
        _close(rec["loss"], loss, f"rank {r} loss")
        _close(rec["dh"], dh, f"rank {r} dh")
        _close(rec["dtable"], dt, f"rank {r} dtable")


@pytest.mark.parametrize("tp", [2, 4])
def test_embed_lookup_and_greedy_pick(ranks, tp):
    x, outs = ranks
    want_embed = np.asarray(j_ops.embed_lookup(
        j_meshenv.CPU_ENV, jnp.asarray(x["tied"]), jnp.asarray(x["ids"])))
    for tied in (True, False):
        table = x["tied"] if tied else x["untied"]
        logits = j_ops.unembed_logits(j_meshenv.CPU_ENV, jnp.asarray(x["h"]),
                                      jnp.asarray(table),
                                      transpose_table=tied, valid_vocab=V)
        want = np.asarray(j_ops.sharded_argmax(j_meshenv.CPU_ENV, logits))
        for out in outs:
            np.testing.assert_array_equal(out[tp][tied]["argmax"], want)
    for out in outs:
        np.testing.assert_array_equal(out[tp]["embed"], want_embed)


@pytest.mark.parametrize("tp", [2, 4])
def test_sharded_argmax_tie_across_shards_takes_the_smallest_index(ranks,
                                                                   tp):
    x, outs = ranks
    want = np.asarray(j_ops.sharded_argmax(j_meshenv.CPU_ENV,
                                           jnp.asarray(x["tie_logits"])))
    assert want[0, 1] == 5
    for out in outs:
        np.testing.assert_array_equal(out[tp]["tie"], want)


def test_compressed_pod_mean_with_error_feedback(ranks):
    """Rank r is (pod r // 2, data r % 2): its pod partner is r ^ 2."""
    x, outs = ranks

    def ref_call(g_pods, e_pods):
        qs = [j_comp.quantize_int8(jnp.asarray(g + e))
              for g, e in zip(g_pods, e_pods)]
        total = jnp.zeros(g_pods[0].shape, jnp.float32)
        for q, s in qs:
            total = total + j_comp.dequantize_int8(q, s, g_pods[0].shape)
        errs = [np.asarray(jnp.asarray(g + e) - j_comp.dequantize_int8(
            q, s, g.shape)) for g, e, (q, s) in zip(g_pods, e_pods, qs)]
        return np.asarray(total / 2), errs

    for r, out in enumerate(outs):
        pods = (r % 2, 2 + r % 2)
        for key, sl in (("a", np.s_[:]), ("b", np.s_[:, :1])):
            g1 = [x["grads"][(0 if key == "a" else 4) + p][sl] for p in pods]
            zero = [np.zeros_like(g) for g in g1]
            mean1, e1 = ref_call(g1, zero)
            g2 = [g * np.float32(0.5) + np.float32(1.0) for g in g1]
            mean2, e2 = ref_call(g2, e1)
            me = pods.index(r)
            np.testing.assert_array_equal(out["pod"]["mean1"][key], mean1)
            np.testing.assert_array_equal(out["pod"]["err1"][key], e1[me])
            np.testing.assert_array_equal(out["pod"]["mean2"][key], mean2)
            np.testing.assert_array_equal(out["pod"]["err2"][key], e2[me])


def test_shrink_mesh_keeps_the_surviving_data_rows(ranks):
    _, outs = ranks
    first, last = ("data", "model"), ("model", "data")
    for r, out in enumerate(outs):
        assert out[first]["shape"] == {"data": 1, "model": 2}
        assert out[first]["mesh"] == [[0, 1]]
        assert out[first]["member"] == (r in (0, 1))
        assert out[last]["shape"] == {"model": 2, "data": 1}
        assert out[last]["mesh"] == [[0], [2]]
        assert out[last]["member"] == (r in (0, 2))
        assert out["drop_all"] == "cannot drop all data rows"
        assert "no 'data' axis" in out["no_data"]


@pytest.mark.parametrize("cards,backend", [
    (["card-0", "card-1", "card-2", "card-3"], "nccl"),
    (["card-0"], "nccl"),
    (["card-0", "card-0", "card-0", "card-0"], "gloo"),
    (["card-0", "card-1", "card-0", "card-1"], "gloo"),
    ([None, None], "gloo"),
    (["card-0", None], "gloo")])
def test_backend_follows_the_cards_the_ranks_hold(cards, backend):
    """``nccl`` only when every rank holds a card of its own (NCCL
    refuses two ranks on one device), whatever the host's card count."""
    from repro_torch.launch.mesh import choose_backend
    assert choose_backend(cards) == backend


@pytest.mark.parametrize("first", ["repro_torch.runtime",
                                   "repro_torch.models.sharded_ops",
                                   "repro_torch.models.layers",
                                   "repro_torch.runtime.meshenv",
                                   "repro_torch.runtime.train"])
def test_the_mesh_modules_load_no_jax_in_a_fresh_interpreter(first):
    """Each module the mesh threads through imports first in a fresh
    interpreter (no circular import through ``runtime.meshenv``), and
    the mesh's modules load nothing of JAX or the JAX package."""
    code = (
        "import sys\n"
        f"import {first}\n"
        "import repro_torch.runtime.meshenv, repro_torch.runtime.elastic\n"
        "import repro_torch.launch.mesh, repro_torch.launch.train\n"
        "import repro_torch.runtime.compression, repro_torch.interop\n"
        "bad = sorted(m for m in sys.modules if m == 'jax'"
        " or m.startswith(('jax.', 'jaxlib')) or m == 'repro'"
        " or m.startswith('repro.'))\n"
        "print('LOADED', bad)\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert "LOADED []" in out.stdout
