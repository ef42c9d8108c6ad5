"""Shared pieces of the ``test_torch_mesh_families*`` files: every model
family's float32 train step on a mesh against the JAX package's own mesh
step.

A case is (name, arch, ``reduced`` kwargs, mesh (data, model), extras):
the port runs it in a spawned four-rank gloo world (``torch_mesh_ranks``;
a mesh of fewer ranks leaves the others out), the reference in a
subprocess with four forced host devices, jitting ``make_train_step``
with its shardings (params by their spec tree, AdamW's state by
``opt_state_specs``, the batch over ``data``), both from the same numpy
weights and batch.  Extras: ``grads`` also compares every gradient leaf
(the reference's ``jax.grad`` of ``loss_fn`` jitted with the same
shardings); ``drops`` counts, in the reference, the assignments its
capacity rule drops (its single-device ``_moe_local`` run eagerly, on
the whole batch for the global rule of a data mesh, on each data shard's
rows for the per-shard rule of tp > 1); ``remesh`` re-cuts the live
state after the step by ``elastic.remesh_state`` onto data 4 x model 1
(every sharded spec changes) and takes one more step there, held
against an unbroken two-step run on one process (:func:`unbroken`);
``cp`` runs both packages under context-parallel attention (``make_env(
..., context_parallel_attn=True)``).

The weights are the port's ``init_lm`` for the case's mesh (q heads
padded for its TP size), in the reference's stacked tree, with the norm
weights randomised (they start at zero, which would hide a wrong
``(1 + w)`` convention), RWKV-6's token-shift mixes, decay bias and
group-norm weights randomised too, and an MoE router scaled by
``ROUTER_SCALE`` so that routing is uneven enough to drop assignments
at the reference's capacity factor 1.25.

This module imports nothing of JAX or of the JAX package, so a spawned
rank loads only the port.
"""
from __future__ import annotations

import dataclasses
import os
import pickle
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
#: test_torch_mesh_train.py's: float32 sums in other orders (and the
#: collectives') keep the loss, aux and grad_norm within 1e-5 relative;
#: AdamW's first step moves an element by about lr x sign(g), so the
#: change of a leaf is held to 1e-2 of its own RMS in error RMS
LOSS_RTOL = 1e-5
UPDATE_RMS = 1e-2
#: test_torch_train_families.py's gradient bound: error RMS over the
#: reference's RMS, per leaf
GRAD_RMS = 1e-4
BATCH, SEQ = 4, 16
ROUTER_SCALE = 4.0
REFERENCE_TIMEOUT_S = 300

_REFERENCE = r"""
import dataclasses, os, pickle, sys
os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                           + " --xla_force_host_platform_device_count=4")
os.environ["JAX_PLATFORMS"] = "cpu"
import jax
import jax.numpy as jnp
import numpy as np
from repro.configs import get_config, reduced
from repro.models import moe as jmoe
from repro.models import transformer as tfm
from repro.optim import adamw
from repro.runtime.meshenv import CPU_ENV, make_env
from repro.runtime.train import (TrainConfig, batch_specs, make_train_step,
                                 opt_state_specs, shardings_for)

assert jax.device_count() == 4
with open(sys.argv[1], "rb") as f:
    inputs = pickle.load(f)
cases = inputs.pop("__cases__")
drops = [0]
inner = jmoe._moe_local


def spy(x_flat, router, *a, num_experts, top_k, capacity, **kw):
    idx = np.asarray(jax.lax.top_k(jax.nn.softmax(
        x_flat.astype(jnp.float32) @ router, axis=-1), top_k)[1])
    counts = np.bincount(idx.reshape(-1), minlength=num_experts)
    drops[0] += int(np.maximum(counts - capacity, 0).sum())
    return inner(x_flat, router, *a, num_experts=num_experts, top_k=top_k,
                 capacity=capacity, **kw)


out = {}
for name, arch, kw, (data, model), extras in cases:
    devs = np.asarray(jax.devices()[:data * model]).reshape(data, model)
    env = make_env(jax.sharding.Mesh(devs, ("data", "model")),
                   context_parallel_attn="cp" in extras)
    cfg = dataclasses.replace(reduced(get_config(arch), **kw),
                              dtype="float32")
    specs = {}

    def init(key):
        params, specs["p"] = tfm.init_lm(cfg, key, env)
        return params

    shapes = jax.eval_shape(init, jax.random.PRNGKey(0))
    pspecs = specs["p"]
    params = jax.tree.map(jnp.asarray, inputs[name]["params"])
    assert jax.tree.map(lambda a: a.shape, params) == jax.tree.map(
        lambda a: a.shape, shapes), name
    batch = {k: jnp.asarray(v) for k, v in inputs[name]["batch"].items()}
    p_sh = shardings_for(env, pspecs)
    b_sh = shardings_for(env, batch_specs(cfg, env, batch))
    step = jax.jit(make_train_step(cfg, env, TrainConfig()),
                   in_shardings=(p_sh, shardings_for(env, opt_state_specs(
                       pspecs, params, env)), b_sh),
                   out_shardings=(p_sh, None, None))
    new, _, m = step(params, adamw.init(params), batch)
    rec = {k: float(m[k]) for k in ("loss", "aux", "total", "grad_norm")}
    rec["new"] = jax.tree.map(np.asarray, new)
    if "grads" in extras:
        grad = jax.jit(jax.grad(lambda p, b: tfm.loss_fn(cfg, p, env, b)[0]),
                       in_shardings=(p_sh, b_sh), out_shardings=p_sh)
        rec["grads"] = jax.tree.map(np.asarray, grad(params, batch))
    if "drops" in extras:
        jmoe._moe_local = spy
        drops[0] = 0
        parts = data if model > 1 else 1
        rows = batch["tokens"].shape[0] // parts
        for i in range(parts):
            part = {k: v[i * rows:(i + 1) * rows] for k, v in batch.items()}
            tfm.loss_fn(cfg, params, CPU_ENV, part, remat=False, unroll=True)
        jmoe._moe_local = inner
        rec["drops"] = drops[0]
    out[name] = rec
with open(sys.argv[2], "wb") as f:
    pickle.dump(out, f)
"""


def cfg_of(arch: str, kw: dict):
    from repro_torch.configs import get_config, reduced
    return dataclasses.replace(reduced(get_config(arch), **kw),
                               dtype="float32")


def _stacked(cfg, blocks: list) -> dict:
    """The reference's {"tail", "scan"} stacking of one tree per block."""
    from repro_torch._tree import tree_map
    period = len(cfg.pattern)
    rem = cfg.num_layers % period
    return {"tail": tuple(blocks[:rem]), "scan": tuple(
        tree_map(lambda *xs: np.stack(xs), *blocks[rem + j::period])
        for j in range(period))}


def _randomise(p: dict, rng) -> None:
    """Norm weights (and RWKV-6's mu, w0 and ln_x) to random values; an
    MoE router scaled by ROUTER_SCALE."""
    def fill(t, scale, shift=0.0):
        t.copy_(torch.from_numpy((rng.standard_normal(t.shape) * scale
                                  + shift).astype(np.float32)))

    for blk in p["layers"] + p.get("encoder", []):
        for key in ("ln1", "ln2", "ln_cross"):
            if key in blk:
                fill(blk[key], 0.5)
        mix = blk["mix"]
        for key in ("q_norm", "k_norm"):
            if key in mix:
                fill(mix[key], 0.5)
        if "ln_x" in mix:
            fill(mix["mu"], 0.2, 0.5)
            fill(mix["w0"], 0.5)
            fill(mix["ln_x"], 0.3, 1.0)
            fill(blk["ffn"]["mu"], 0.2, 0.5)
        if "router" in blk["ffn"]:
            blk["ffn"]["router"].mul_(ROUTER_SCALE)
    for key in ("final_norm", "enc_norm"):
        if key in p:
            fill(p[key], 0.5)


def inputs_for(cases) -> dict:
    """Every case's weights, as the reference's ``init_lm`` tree of numpy
    leaves, and its global batch (``batch_at``: tokens and labels, and
    ``patch_embeds`` or ``src_embeds`` as the family takes them)."""
    from repro_torch._tree import tree_map
    from repro_torch.models import transformer as tfm
    from repro_torch.models.transformer import encoder_cfg
    from repro_torch.runtime.data import DataConfig, batch_at
    from repro_torch.runtime.meshenv import make_env
    rng = np.random.default_rng(1)
    out = {"__cases__": list(cases)}
    for name, arch, kw, (data, model), _ in cases:
        cfg = cfg_of(arch, kw)
        layout = make_env({"data": data, "model": model})
        p = tfm.init_lm(cfg, torch.Generator().manual_seed(0), "cpu", layout)
        _randomise(p, rng)
        p = tree_map(lambda t: t.numpy(), p)
        p["stack"] = _stacked(cfg, p.pop("layers"))
        if cfg.enc_dec:
            p["encoder"] = _stacked(encoder_cfg(cfg), p.pop("encoder"))
        batch = batch_at(cfg, DataConfig(seed=1, seq_len=SEQ,
                                         global_batch=BATCH), 0, "cpu")
        out[name] = {"params": p,
                     "batch": {k: v.numpy() for k, v in batch.items()}}
    return out


def mesh_rank(rank: int, inputs: dict) -> dict:
    """Every case's step on its mesh (a rank past the mesh only builds
    it): the logical parameters it ends with, its metrics, and with
    ``grads`` the logical gradient of every leaf."""
    from repro_torch import interop
    from repro_torch._tree import leaves
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import transformer as tfm
    from repro_torch.runtime.meshenv import make_env, unshard_tree
    from repro_torch.runtime.train import (TrainConfig, init_opt_state,
                                           loss_and_grads, make_train_step)
    out = {}
    for name, arch, kw, shape, extras in inputs["__cases__"]:
        cfg = cfg_of(arch, kw)
        env = make_env(make_mesh(shape, ("data", "model")),
                       context_parallel_attn="cp" in extras)
        if not env.member:
            continue
        r = inputs[name]
        batch = {k: torch.from_numpy(np.asarray(v))
                 for k, v in r["batch"].items()}
        specs = tfm.param_specs(cfg, env)
        params = interop.shard_lm_params(cfg, r["params"], env)
        rec = {}
        if "grads" in extras:
            _, _, grads = loss_and_grads(cfg, params, batch, env=env)
            rec["grads"] = [env.unshard(g, sp) for g, sp in
                            zip(grads, leaves(specs))]
        step = make_train_step(cfg, TrainConfig(), env=env)
        params, opt, m = step(params, init_opt_state(cfg, params, env),
                              batch)
        rec.update({k: float(v) for k, v in m.items()})
        rec["new"] = [p.detach() for p in
                      leaves(unshard_tree(params, specs, env))]
        if "remesh" in extras:
            rec["remesh"] = _remesh_step(cfg, r["params"], batch, env,
                                         params, opt)
        out[name] = rec
    return out


def _remesh_step(cfg, tree: dict, batch: dict, env, params, opt) -> dict:
    """The live state re-cut onto data 4 x model 1, then one step there:
    its loss and the logical parameters it ends with."""
    from repro_torch import interop
    from repro_torch._tree import leaves, tree_map
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import transformer as tfm
    from repro_torch.runtime.elastic import remesh_state
    from repro_torch.runtime.meshenv import unshard_tree
    from repro_torch.runtime.train import (TrainConfig, make_train_step,
                                           opt_state_specs)
    shapes = tree_map(lambda t: tuple(t.shape),
                      interop.lm_params_from_numpy(cfg, tree))

    def state_specs(e):
        ps = tfm.param_specs(cfg, e)
        return {"params": ps, "opt_state": opt_state_specs(ps, shapes, e)}

    new, new_env = remesh_state({"params": params, "opt_state": opt},
                                state_specs, env,
                                make_mesh((4, 1), ("data", "model")))
    params, _, m = make_train_step(cfg, TrainConfig(), env=new_env)(
        new["params"], new["opt_state"], batch)
    logical = unshard_tree(params, tfm.param_specs(cfg, new_env), new_env)
    return {"loss": float(m["loss"]),
            "new": [p.detach() for p in leaves(logical)]}


def unbroken(ref: dict, case) -> tuple:
    """The case's two steps on one process from the reference's weights:
    (weights before, second step's loss, weights after)."""
    from repro_torch import interop
    from repro_torch._tree import leaves
    from repro_torch.runtime.train import (TrainConfig, init_opt_state,
                                           make_train_step)
    name, arch, kw, _, _ = case
    cfg = cfg_of(arch, kw)
    params = interop.lm_params_from_numpy(cfg, ref[name]["params"])
    before = [p.clone() for p in leaves(params)]
    batch = {k: torch.from_numpy(np.asarray(v))
             for k, v in ref[name]["batch"].items()}
    step = make_train_step(cfg, TrainConfig())
    opt = init_opt_state(cfg, params)
    for _ in range(2):
        params, opt, m = step(params, opt, batch)
    return before, float(m["loss"]), [p.detach() for p in leaves(params)]


def run_cases(cases, tmp: Path) -> tuple:
    """The reference's subprocess and the port's world at once; returns
    (reference records with the inputs beside them, rank records)."""
    from torch_mesh_ranks import run_world
    inputs = inputs_for(cases)
    with open(tmp / "inputs.pkl", "wb") as f:
        pickle.dump(inputs, f)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    with subprocess.Popen([sys.executable, "-c", _REFERENCE,
                           str(tmp / "inputs.pkl"), str(tmp / "ref.pkl")],
                          cwd=ROOT, env=env, stdout=subprocess.PIPE,
                          stderr=subprocess.PIPE, text=True) as proc:
        ranks = run_world(mesh_rank, 4, tmp / "world", inputs)
        _, err = proc.communicate(timeout=REFERENCE_TIMEOUT_S)
    assert proc.returncode == 0, err[-3000:]
    with open(tmp / "ref.pkl", "rb") as f:
        ref = pickle.load(f)
    for name in ref:
        ref[name].update(inputs[name])
    return ref, ranks


def rel_rms(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.sqrt(np.mean((got - want) ** 2))
                 / max(np.sqrt(np.mean(want ** 2)), 1e-30))


def members(ranks, shape) -> list:
    """The records of the ranks on a mesh of ``shape`` (the first
    prod(shape) ranks)."""
    return ranks[:int(np.prod(shape))]


def assert_metrics(ref: dict, ranks: list, case, metric: str) -> None:
    name, _, _, shape, _ = case
    want = ref[name][metric]
    for rank, out in enumerate(members(ranks, shape)):
        got = out[name][metric]
        assert got == want or abs(got - want) <= LOSS_RTOL * abs(want), (
            rank, metric, got, want)


def assert_updates(ref: dict, ranks: list, case) -> None:
    from repro_torch import interop
    from repro_torch._tree import leaves
    name, arch, kw, shape, _ = case
    cfg = cfg_of(arch, kw)
    before = leaves(interop.lm_params_from_numpy(cfg, ref[name]["params"]))
    want = leaves(interop.lm_params_from_numpy(cfg, ref[name]["new"]))
    for rank, out in enumerate(members(ranks, shape)):
        got = out[name]["new"]
        assert [tuple(g.shape) for g in got] == \
            [tuple(w.shape) for w in want]
        for i, (g, w, p0) in enumerate(zip(got, want, before)):
            rr = rel_rms(g.numpy() - p0.numpy(), w.numpy() - p0.numpy())
            assert rr <= UPDATE_RMS, (rank, i, rr)


def assert_remesh(ref: dict, ranks: list, case) -> None:
    """Every rank's step after ``remesh_state`` onto data 4 x model 1
    matches the second step of an unbroken one-process run."""
    before, loss, after = unbroken(ref, case)
    for rank, out in enumerate(ranks):
        rec = out[case[0]]["remesh"]
        assert abs(rec["loss"] - loss) <= LOSS_RTOL * abs(loss), (rank,
                                                                  rec, loss)
        for i, (g, w, p0) in enumerate(zip(rec["new"], after, before)):
            rr = rel_rms((g - p0).numpy(), (w - p0).numpy())
            assert rr <= UPDATE_RMS, (rank, i, rr)


def assert_grads(ref: dict, ranks: list, case) -> None:
    from repro_torch import interop
    from repro_torch._tree import leaves
    name, arch, kw, shape, _ = case
    cfg = cfg_of(arch, kw)
    want = leaves(interop.lm_params_from_numpy(cfg, ref[name]["grads"]))
    for rank, out in enumerate(members(ranks, shape)):
        worst = max(rel_rms(g.numpy(), w.numpy())
                    for g, w in zip(out[name]["grads"], want))
        assert worst <= GRAD_RMS, (rank, worst)
