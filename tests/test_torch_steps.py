"""The port's cell programs (``launch/steps.py``) and cache spec trees
(``transformer.cache_specs``) against the JAX package's.

* The cases of the reference's ``tests/test_steps.py``: ``input_specs``
  shapes (and dtypes) for every architecture x cell, the long_500k rule
  and its ``ValueError``, ``abstract_params`` equal to a real
  ``init_lm`` on a reduced config, ``abstract_caches`` with int8 codes
  and float32 scales, every program building on one process.
* Against ``repro.launch.steps`` itself, at data 2 x model 2 (an
  ``AbstractMesh``: nothing allocated, no forced devices): every
  program's ``in_specs``/``out_specs`` equal to the specs of the
  reference program's shardings, entry for entry, for a reduced config
  of every architecture and every cell it supports (decode also with
  int8 caches); ``abstract_params``' shapes and dtypes equal to the
  reference's.
* Building full-size yi-34b's ``train_4k`` program allocates nothing.
* The cache spec trees, entry for entry, against the reference's
  ``abstract_caches`` (its stacked ``scan`` leaves, ``P(None, *sp)``,
  mapped onto the port's one entry a block), with and without int8
  caches: each family reduced at data 2 x model 2, and every
  architecture at full width at data 16 x model 16 for ``decode_32k`` and
  ``long_500k`` (through ``jax.eval_shape``: nothing allocated).
"""
import resource

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax                                                       # noqa: E402
from jax.sharding import AbstractMesh                            # noqa: E402

from repro.configs import get_config as j_get_config             # noqa: E402
from repro.configs import reduced as j_reduced                   # noqa: E402
from repro.launch import steps as j_steps                        # noqa: E402
from repro.runtime import meshenv as j_meshenv                   # noqa: E402
from repro.runtime.train import TrainConfig as JTrainConfig      # noqa: E402
from repro_torch import interop                                  # noqa: E402
from repro_torch._tree import leaves, tree_map                   # noqa: E402
from repro_torch.configs import (ALL_CELLS, ARCH_IDS,            # noqa: E402
                                 CELLS_BY_NAME, get_config, reduced,
                                 supports_cell)
from repro_torch.launch import steps                             # noqa: E402
from repro_torch.models import transformer as t_tfm              # noqa: E402
from repro_torch.runtime.meshenv import CPU_ENV, P, make_env     # noqa: E402
from repro_torch.runtime.train import TrainConfig                # noqa: E402

SUBQUADRATIC = ("gemma3-27b", "recurrentgemma-9b", "rwkv6-3b")
CELL_NAMES = [c.name for c in ALL_CELLS]
#: a reduced config of each family (``reduced`` kwargs, as both packages
#: take them), RWKV-6 with heads that divide tp 2 and with 3 that do not
REDUCED = {
    "dense": ("qwen3-8b", dict(layers=3, d_model=48, heads=3, kv_heads=1)),
    "granite-moe": ("granite-moe-1b-a400m", {}),
    "rwkv6": ("rwkv6-3b", {}),
    "rwkv6-3-heads": ("rwkv6-3b", dict(d_model=48, heads=3)),
    "recurrentgemma": ("recurrentgemma-9b", dict(layers=5)),
    "gemma3": ("gemma3-27b", dict(layers=7)),
    "seamless": ("seamless-m4t-large-v2", {}),
    "internvl2": ("internvl2-1b", dict(d_model=48, heads=3, kv_heads=1)),
}


def _j_env(data: int, model: int):
    return j_meshenv.make_env(AbstractMesh((data, model), ("data", "model")))


def _t_env(data: int, model: int):
    return make_env({"data": data, "model": model})


# ---------------------------------------------------------------------------
# port trees -> the reference's stacked trees
# ---------------------------------------------------------------------------
def _restack(cfg, blocks: list) -> dict:
    """One tree per block as the reference's ``{"tail", "scan"}`` (a scan
    leaf's spec led by ``None`` for its superblock axis)."""
    period = len(cfg.pattern)
    rem = cfg.num_layers % period
    scan = tuple(tree_map(lambda sp: P(None, *sp), blocks[rem + j])
                 for j in range(period))
    return {"tail": tuple(blocks[:rem]), "scan": scan}


def _param_tree(cfg, specs: dict) -> dict:
    specs = dict(specs)
    specs["stack"] = _restack(cfg, specs.pop("layers"))
    if cfg.enc_dec:
        specs["encoder"] = _restack(t_tfm.encoder_cfg(cfg),
                                    specs.pop("encoder"))
    return specs


def _cache_tree(cfg, specs: list) -> dict:
    """An attention block's ``{"k", "v"[, scales][, "cross"]}`` as the
    reference's ``{"mix": {...}[, "cross"]}``, then restacked."""
    blocks = []
    for c in specs:
        if "k" in c:
            b = {"mix": {k: v for k, v in c.items() if k != "cross"}}
            if "cross" in c:
                b["cross"] = c["cross"]
            c = b
        blocks.append(c)
    return _restack(cfg, blocks)


def _assert_same_specs(port, ref, where="") -> None:
    """Entry for entry: dict keys, sequence lengths, each spec's
    entries (a reference ``NamedSharding`` by its spec)."""
    if isinstance(ref, jax.sharding.NamedSharding):
        ref = ref.spec
    if isinstance(ref, dict):
        assert sorted(port) == sorted(ref), (where, sorted(port), sorted(ref))
        for k in ref:
            _assert_same_specs(port[k], ref[k], f"{where}/{k}")
    elif isinstance(ref, j_meshenv.P):
        assert isinstance(port, P), (where, port)
        assert tuple(port) == tuple(ref), (where, port, ref)
    else:
        assert len(port) == len(ref), where
        for i, (a, b) in enumerate(zip(port, ref)):
            _assert_same_specs(a, b, f"{where}/{i}")


# ---------------------------------------------------------------------------
# the reference's tests/test_steps.py cases
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch", ARCH_IDS)
@pytest.mark.parametrize("cell_name", CELL_NAMES)
def test_input_specs_match_the_reference(arch, cell_name):
    cfg, cell = get_config(arch), CELLS_BY_NAME[cell_name]
    got = steps.input_specs(cfg, cell)
    want = j_steps.input_specs(j_get_config(arch), cell)
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        assert tuple(got[k].shape) == tuple(w.shape), k
        assert str(got[k].dtype).split(".")[-1] == str(w.dtype), k
        assert got[k].device.type == "meta"
    if cell.kind != "decode":
        S = steps.text_len(cfg, cell)
        prefix = cfg.frontend_len if cfg.frontend == "vit" else 0
        assert S + prefix == cell.seq_len
        assert S == j_steps.text_len(j_get_config(arch), cell)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_long_context_support_rule(arch):
    cfg, cell = get_config(arch), CELLS_BY_NAME["long_500k"]
    assert supports_cell(cfg, cell) == (arch in SUBQUADRATIC)
    if arch not in SUBQUADRATIC:
        with pytest.raises(ValueError, match="long_500k"):
            steps.build_cell(cfg, CPU_ENV, cell, TrainConfig())


def _reduced(name: str):
    arch, kw = REDUCED[name]
    return j_reduced(j_get_config(arch), **kw), reduced(get_config(arch),
                                                        **kw)


@pytest.mark.parametrize("family", ["dense", "granite-moe", "seamless"])
def test_abstract_params_match_a_real_init_lm(family):
    """Shapes and dtypes of a real ``init_lm`` and of the reference's
    ``abstract_params`` (its stacked tree unstacked), on ``meta``."""
    jcfg, cfg = _reduced(family)
    for env, (data, model) in ((CPU_ENV, (1, 1)), (_t_env(2, 2), (2, 2))):
        shapes, specs = steps.abstract_params(cfg, env)
        real = t_tfm.init_lm(cfg, torch.Generator().manual_seed(0), "cpu",
                             env)
        assert all(t.device.type == "meta" for t in leaves(shapes))
        assert tree_map(lambda t: (tuple(t.shape), t.dtype), shapes) == \
            tree_map(lambda t: (tuple(t.shape), t.dtype), real)
        assert leaves(specs) == leaves(t_tfm.param_specs(cfg, env))
        jenv = j_meshenv.CPU_ENV if data == 1 else _j_env(data, model)
        jshapes, _ = j_steps.abstract_params(jcfg, jenv)
        want = interop.lm_params_from_numpy(cfg, jax.tree.map(
            lambda a: np.zeros(a.shape, np.float32 if a.dtype == jax.numpy
                               .bfloat16 else a.dtype), jshapes))
        assert tree_map(lambda t: tuple(t.shape), shapes) == \
            tree_map(lambda t: tuple(t.shape), want)


def test_abstract_caches_hold_int8_codes_and_float32_scales():
    cfg = reduced(get_config("qwen3-8b"))
    caches, specs = steps.abstract_caches(cfg, CPU_ENV, batch=2,
                                          cache_len=32, kv_quant=True)
    dtypes = {t.dtype for t in leaves(caches)}
    assert dtypes == {torch.int8, torch.float32}
    assert all(t.device.type == "meta" for t in leaves(caches))
    assert tuple(caches[0]["k_scale"].shape) == (2, 32, cfg.num_kv_heads)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_every_program_builds_on_one_process(arch):
    cfg = reduced(get_config(arch))
    kinds = set()
    for cell in ALL_CELLS:
        if not supports_cell(cfg, cell):
            continue
        prog = steps.build_cell(cfg, CPU_ENV, cell, TrainConfig())
        kinds.add(prog.kind)
        assert prog.in_specs is None and prog.out_specs is None
        assert all(t.device.type == "meta" for t in leaves(prog.args)
                   if torch.is_tensor(t) and t.dim())
        assert prog.name == f"{cfg.name}:{cell.name}"
    assert kinds == {"train", "prefill", "decode"}


@pytest.mark.parametrize("family", sorted(REDUCED))
@pytest.mark.parametrize("cell_name", CELL_NAMES)
def test_program_specs_match_the_reference_s_shardings(family, cell_name):
    """At data 2 x model 2; decode cells with int8 caches
    (``kv_quant_serving``)."""
    jcfg, cfg = _reduced(family)
    cell = CELLS_BY_NAME[cell_name]
    if not supports_cell(cfg, cell):
        return
    quant = cell.kind == "decode"
    prog = steps.build_cell(cfg, _t_env(2, 2), cell,
                            TrainConfig(kv_quant_serving=quant))
    jprog = j_steps.build_cell(jcfg, _j_env(2, 2), cell,
                               JTrainConfig(kv_quant_serving=quant))
    assert (prog.kind, prog.donate_argnums) == (jprog.kind,
                                                jprog.donate_argnums)
    ins, outs = list(prog.in_specs), list(prog.out_specs)
    if prog.kind == "train":
        ins[0] = outs[0] = _param_tree(cfg, ins[0])
        for tree in (ins, outs):
            tree[1] = type(tree[1])(
                step=tree[1].step, m=_param_tree(cfg, tree[1].m),
                v=_param_tree(cfg, tree[1].v))
    elif prog.kind == "prefill":
        ins[0] = _param_tree(cfg, ins[0])
        outs[1] = _cache_tree(cfg, outs[1])
    else:
        ins[0] = _param_tree(cfg, ins[0])
        ins[3] = outs[2] = _cache_tree(cfg, ins[3])
    _assert_same_specs(ins, jprog.in_shardings, "in")
    _assert_same_specs(outs, jprog.out_shardings, "out")


def test_full_size_yi_34b_train_program_allocates_nothing():
    before = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
    prog = steps.build_cell(get_config("yi-34b"), _t_env(16, 16),
                            CELLS_BY_NAME["train_4k"], TrainConfig())
    grown_kb = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss - before
    tensors = [t for t in leaves(prog.args) if torch.is_tensor(t)]
    big = [t for t in tensors if t.dim()]
    assert all(t.device.type == "meta" for t in big)
    assert sum(t.numel() for t in big) > 3 * 3.4e10   # params, m and v
    assert grown_kb < 256 * 1024, grown_kb


# ---------------------------------------------------------------------------
# cache spec trees
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("family", sorted(REDUCED))
@pytest.mark.parametrize("kv_quant", [False, True])
def test_cache_spec_trees_match_the_reference_reduced(family, kv_quant):
    jcfg, cfg = _reduced(family)
    cross = 16 if cfg.enc_dec else 0
    for B in (4, 1):
        _, want = j_steps.abstract_caches(jcfg, _j_env(2, 2), B, 32, cross,
                                          kv_quant=kv_quant)
        got = t_tfm.cache_specs(cfg, _t_env(2, 2), B, 32, cross, kv_quant)
        _assert_same_specs(_cache_tree(cfg, got), want, f"B {B}")


@pytest.mark.parametrize("arch", ARCH_IDS)
@pytest.mark.parametrize("cell_name", ["decode_32k", "long_500k"])
@pytest.mark.parametrize("kv_quant", [False, True])
def test_cache_spec_trees_match_the_reference_full_width(arch, cell_name,
                                                         kv_quant):
    cell = CELLS_BY_NAME[cell_name]
    cfg = get_config(arch)
    cross = steps.DECODE_SRC_LEN if cfg.enc_dec else 0
    _, want = j_steps.abstract_caches(j_get_config(arch), _j_env(16, 16),
                                      cell.global_batch, cell.seq_len,
                                      cross, kv_quant=kv_quant)
    got = t_tfm.cache_specs(cfg, _t_env(16, 16), cell.global_batch,
                            cell.seq_len, cross, kv_quant)
    _assert_same_specs(_cache_tree(cfg, got), want)
    local = t_tfm.init_caches(cfg, cell.global_batch, cell.seq_len, "meta",
                              kv_quant, cross, env=_t_env(16, 16))
    whole, _ = steps.abstract_caches(cfg, CPU_ENV, cell.global_batch,
                                     cell.seq_len, cross, kv_quant)
    for lc, wc, sc in zip(local, whole, got):
        for t, w, sp in zip(leaves(lc), leaves(wc), leaves(sc)):
            n = [w.shape[i] // max(1, _t_env(16, 16).axis_size(e))
                 for i, e in enumerate(tuple(sp) + (None,) * 4)
                 if i < w.dim()]
            assert list(t.shape) == n
