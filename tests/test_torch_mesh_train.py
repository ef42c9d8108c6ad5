"""Tensor- and data-parallel training of the dense decoder family on a
data 2 x model 2 mesh against the JAX package's own mesh path, and the
elastic resume of a mesh checkpoint on a smaller mesh.

The reference runs ``make_train_step`` jitted with its shardings
(params by their spec tree, AdamW's state by ``opt_state_specs``, the
batch over ``data``) in a subprocess with four forced host devices; the
port runs the same float32 step in a spawned four-rank gloo world
(``torch_mesh_ranks``) at the same time, from the same numpy weights
(the port's ``init_lm`` for the mesh's TP size, norms randomised, in
the reference's stacked tree; ``interop.shard_lm_params`` cuts each
rank's slices) and batch.  Two reduced
configs: qwen3's qk-norm with one kv head (kv heads replicated, as 1
does not divide tp 2) and 4 q heads; starcoder2's 3 q heads, padded to
4 for tp 2 (the padded head's ``wo`` rows zero).

Tolerances (float32, sums in other orders, collectives included): the
loss and ``grad_norm`` within 1e-5 relative; each updated parameter's
change (p1 - p0) within 1e-2 of its own RMS in error RMS, the bound
``chip_smoke.TRAIN_CROSS_UPDATE_RMS`` argues (AdamW's first step moves
an element by ~lr x sign(g), so a gradient within rounding of zero may
move it the other way).
"""
import dataclasses
import os
import pickle
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch_mesh_ranks import run_world                            # noqa: E402

from repro_torch import interop                                  # noqa: E402
from repro_torch._tree import leaves                             # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
#: (name, arch, q heads, kv heads) of the reduced float32 configs
CASES = (("qk_norm_kv_replicated", "qwen3-8b", 4, 1),
         ("padded_q_heads", "starcoder2-3b", 3, 1))
LOSS_RTOL = 1e-5
UPDATE_RMS = 1e-2
BATCH, SEQ = 4, 16

_REFERENCE = r"""
import dataclasses, os, pickle, sys
os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                           + " --xla_force_host_platform_device_count=4")
os.environ["JAX_PLATFORMS"] = "cpu"
import jax
import jax.numpy as jnp
import numpy as np
from repro.configs import get_config, reduced
from repro.models import transformer as tfm
from repro.optim import adamw
from repro.runtime.data import DataConfig, batch_at
from repro.runtime.meshenv import make_env
from repro.runtime.train import (TrainConfig, batch_specs, make_train_step,
                                 opt_state_specs, shardings_for)

assert jax.device_count() == 4
env = make_env(jax.sharding.Mesh(np.asarray(jax.devices()).reshape(2, 2),
                                  ("data", "model")))
with open(sys.argv[1], "rb") as f:
    inputs = pickle.load(f)
out = {}
for name, arch, heads, kv in %(cases)r:
    cfg = dataclasses.replace(
        reduced(get_config(arch), layers=2, d_model=16 * heads, heads=heads,
                kv_heads=kv, d_ff=128, vocab=300), dtype="float32")
    specs = {}

    def init(key):
        params, specs["p"] = tfm.init_lm(cfg, key, env)
        return params

    shapes = jax.eval_shape(init, jax.random.PRNGKey(0))
    pspecs = specs["p"]
    params = jax.tree.map(jnp.asarray, inputs[name]["params"])
    assert jax.tree.map(lambda a: a.shape, params) == jax.tree.map(
        lambda a: a.shape, shapes)
    opt = adamw.init(params)
    batch = {k: jnp.asarray(v) for k, v in inputs[name]["batch"].items()}
    step = jax.jit(make_train_step(cfg, env, TrainConfig()),
                   in_shardings=(shardings_for(env, pspecs),
                                 shardings_for(env, opt_state_specs(
                                     pspecs, params, env)),
                                 shardings_for(env, batch_specs(
                                     cfg, env, batch))),
                   out_shardings=(shardings_for(env, pspecs), None, None))
    new, _, m = step(params, opt, batch)
    out[name] = {"loss": float(m["loss"]),
                 "grad_norm": float(m["grad_norm"]),
                 "new": jax.tree.map(np.asarray, new)}
with open(sys.argv[2], "wb") as f:
    pickle.dump(out, f)
""" % {"cases": CASES, "seq": SEQ, "batch": BATCH}


def _cfg(arch: str, heads: int, kv: int):
    from repro_torch.configs import get_config, reduced
    return dataclasses.replace(
        reduced(get_config(arch), layers=2, d_model=16 * heads, heads=heads,
                kv_heads=kv, d_ff=128, vocab=300), dtype="float32")


def _inputs() -> dict:
    """Every case's weights, as the reference's ``init_lm`` tree of
    numpy leaves, and its global batch: the port's ``init_lm`` padded
    for tp 2, norm weights randomised (they start at zero, which would
    hide a wrong ``(1 + w)`` convention), scan blocks stacked on a
    leading superblock axis."""
    from repro_torch._tree import tree_map
    from repro_torch.models import transformer as tfm
    from repro_torch.runtime.data import DataConfig, batch_at
    from repro_torch.runtime.meshenv import make_env
    layout = make_env({"data": 2, "model": 2})
    rng = np.random.default_rng(1)
    out = {}
    for name, arch, heads, kv in CASES:
        cfg = _cfg(arch, heads, kv)
        p = tfm.init_lm(cfg, torch.Generator().manual_seed(0), "cpu", layout)
        for blk in p["layers"]:
            for sub, key in (("ln1", None), ("ln2", None),
                             ("mix", "q_norm"), ("mix", "k_norm")):
                t = blk[sub] if key is None else blk[sub].get(key)
                if t is not None:
                    t.copy_(torch.from_numpy(rng.standard_normal(
                        t.shape).astype(np.float32) * 0.5))
        p["final_norm"].copy_(torch.from_numpy(rng.standard_normal(
            p["final_norm"].shape).astype(np.float32) * 0.5))
        p = tree_map(lambda t: t.numpy(), p)
        blocks = p.pop("layers")
        period = len(cfg.pattern)
        rem = cfg.num_layers % period
        p["stack"] = {"tail": tuple(blocks[:rem]), "scan": tuple(
            tree_map(lambda *xs: np.stack(xs), *blocks[rem + j::period])
            for j in range(period))}
        batch = batch_at(cfg, DataConfig(seed=1, seq_len=SEQ,
                                         global_batch=BATCH), 0, "cpu")
        out[name] = {"params": p,
                     "batch": {k: v.numpy() for k, v in batch.items()}}
    return out


def _batch(b: dict) -> dict:
    return {k: torch.from_numpy(np.asarray(v)) for k, v in b.items()}


def _step(cfg, params, batch, env, opt=None):
    """One mesh train step from this rank's ``params``; returns (params,
    opt, metrics as floats)."""
    from repro_torch.runtime.train import (TrainConfig, init_opt_state,
                                           make_train_step)
    if opt is None:
        opt = init_opt_state(cfg, params, env)
    params, opt, m = make_train_step(cfg, TrainConfig(), env=env)(
        params, opt, batch)
    return params, opt, {k: float(v) for k, v in m.items()}


def _remesh_steps(cfg, r: dict, batch: dict, env, state: dict) -> dict:
    """The live state after one step at data 2 x model 2 re-cut by
    ``remesh_state`` onto data 1 x model 2 (``shrink_mesh``: ranks 2 and
    3 dropped, ZeRO-1 off) and onto data 4 x model 1 (every spec
    changes), then one step on each new mesh."""
    from repro_torch._tree import tree_map
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import transformer as tfm
    from repro_torch.runtime.elastic import remesh_state, shrink_mesh
    from repro_torch.runtime.meshenv import unshard_tree
    from repro_torch.runtime.train import init_opt_state, opt_state_specs
    shapes = tree_map(lambda t: tuple(t.shape),
                      interop.lm_params_from_numpy(cfg, r["params"]))

    def state_specs(e):
        ps = tfm.param_specs(cfg, e)
        return {"params": ps, "opt_state": opt_state_specs(ps, shapes, e)}

    meshes = (("shrunk", shrink_mesh(env.mesh, drop_data_rows=1)),
              ("data4", make_mesh((4, 1), ("data", "model"))))
    out = {}
    for label, mesh in meshes:
        new, new_env = remesh_state(state, state_specs, env, mesh)
        rec = {"member": new_env.member, "shape": new_env.shape}
        if new_env.member:
            rec["m_shapes"] = [t.shape for t in leaves(new["opt_state"].m)]
            rec["m_want"] = [t.shape for t in leaves(init_opt_state(
                cfg, new["params"], new_env).m)]
            params, _, m = _step(cfg, new["params"], batch, new_env,
                                 opt=new["opt_state"])
            logical = unshard_tree(params, tfm.param_specs(cfg, new_env),
                                   new_env)
            rec.update(step=int(new["opt_state"].step), loss1=m["loss"],
                       new=[p.detach() for p in leaves(logical)])
        out[("remesh", label)] = rec
    return out


def _mesh_steps(rank: int, ref: dict, ckpt_dir: str) -> dict:
    """Every case's step at data 2 x model 2 (the logical parameters it
    ends with), then the elastic run: one step of the first case at data
    2 x model 2, a logical checkpoint, the mesh shrunk to data 1 x model 2
    and one more step there after ``restore``."""
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import transformer as tfm
    from repro_torch.runtime import checkpoint as ckpt
    from repro_torch.runtime.elastic import shrink_mesh
    from repro_torch.runtime.meshenv import make_env, unshard_tree
    from repro_torch.runtime.train import opt_state_specs
    mesh = make_mesh((2, 2), ("data", "model"))
    env = make_env(mesh)
    out = {}
    for name, arch, heads, kv in CASES:
        cfg = _cfg(arch, heads, kv)
        r = ref[name]
        params = interop.shard_lm_params(cfg, r["params"], env)
        params, _, m = _step(cfg, params, _batch(r["batch"]), env)
        logical = unshard_tree(params, tfm.param_specs(cfg, env), env)
        out[name] = dict(m, new=[p.detach() for p in leaves(logical)])

    name, arch, heads, kv = CASES[0]
    cfg, r = _cfg(arch, heads, kv), ref[name]
    batch = _batch(r["batch"])

    from repro_torch.runtime.train import TrainConfig, loss_and_grads
    cfg16 = dataclasses.replace(cfg, dtype="bfloat16")
    p16 = interop.shard_lm_params(cfg16, tfm.init_lm(
        cfg16, torch.Generator().manual_seed(0), "cpu", env), env)
    for flag in (False, True):
        _, m, grads = loss_and_grads(cfg16, p16, batch, env=env,
                                     tcfg=TrainConfig(bf16_collectives=flag))
        out[("bf16_collectives", flag)] = (float(m["loss"]),
                                          [g.detach() for g in grads])

    def specs_for(e, params):
        ps = tfm.param_specs(cfg, e)
        return {"params": ps, "opt_state": opt_state_specs(ps, params, e)}

    params = interop.shard_lm_params(cfg, r["params"], env)
    params, opt, m0 = _step(cfg, params, batch, env)
    ckpt.save(ckpt_dir, ckpt.TrainState(
        step=1, params=params, opt_state=opt, data_cursor=1,
        rng=torch.Generator().manual_seed(1).get_state()),
        env=env, specs=specs_for(env, params))
    out.update(_remesh_steps(cfg, r, batch, env, {"params": params,
                                                  "opt_state": opt}))
    small = make_env(shrink_mesh(mesh, drop_data_rows=1))
    out["elastic"] = {"member": small.member, "shape": small.shape,
                      "loss0": m0["loss"]}
    if small.member:
        from repro_torch.runtime.train import init_opt_state
        fresh = interop.shard_lm_params(cfg, r["params"], small)
        example = ckpt.TrainState(step=0, params=fresh,
                                  opt_state=init_opt_state(cfg, fresh, small),
                                  data_cursor=0, rng=torch.zeros(0))
        state = ckpt.restore(ckpt_dir, example, env=small,
                             specs=specs_for(small, fresh))
        params, _, m1 = _step(cfg, state.params, batch, small,
                              opt=state.opt_state)
        logical = unshard_tree(params, tfm.param_specs(cfg, small), small)
        out["elastic"].update(step=state.step, loss1=m1["loss"],
                              new=[p.detach() for p in leaves(logical)])
    return out


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("mesh_train")
    inputs = _inputs()
    with open(tmp / "inputs.pkl", "wb") as f:
        pickle.dump(inputs, f)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    with subprocess.Popen([sys.executable, "-c", _REFERENCE,
                           str(tmp / "inputs.pkl"), str(tmp / "ref.pkl")],
                          cwd=ROOT, env=env, stdout=subprocess.PIPE,
                          stderr=subprocess.PIPE, text=True) as proc:
        ranks = run_world(_mesh_steps, 4, tmp / "world", inputs,
                          str(tmp / "ckpt"))
        _, err = proc.communicate(timeout=300)
    assert proc.returncode == 0, err[-3000:]
    with open(tmp / "ref.pkl", "rb") as f:
        ref = pickle.load(f)
    for name in ref:
        ref[name].update(inputs[name])
    return ref, ranks


def _rel_rms(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.sqrt(np.mean((got - want) ** 2))
                 / max(np.sqrt(np.mean(want ** 2)), 1e-30))


@pytest.mark.parametrize("case", [c[0] for c in CASES])
@pytest.mark.parametrize("metric", ["loss", "grad_norm"])
def test_mesh_step_metrics_match_the_reference(worlds, case, metric):
    ref, ranks = worlds
    for rank, out in enumerate(ranks):
        assert out[case][metric] == pytest.approx(
            ref[case][metric], rel=LOSS_RTOL), (rank, metric)


@pytest.mark.parametrize("case", [c[0] for c in CASES])
def test_mesh_step_updates_match_the_reference(worlds, case):
    ref, ranks = worlds
    name, arch, heads, kv = next(c for c in CASES if c[0] == case)
    cfg = _cfg(arch, heads, kv)
    before = leaves(interop.lm_params_from_numpy(cfg, ref[case]["params"]))
    want = leaves(interop.lm_params_from_numpy(cfg, ref[case]["new"]))
    for rank, out in enumerate(ranks):
        got = out[case]["new"]
        assert [tuple(g.shape) for g in got] == \
            [tuple(w.shape) for w in want]
        for i, (g, w, p0) in enumerate(zip(got, want, before)):
            rr = _rel_rms(g.numpy() - p0.numpy(), w.numpy() - p0.numpy())
            assert rr <= UPDATE_RMS, (rank, i, rr)


def test_padded_q_heads_keep_zero_wo_rows_and_every_rank_agrees(worlds):
    """starcoder2's 3 q heads pad to 4 at tp 2; the reference's and the
    port's logical trees agree in shape, every rank gathers the same
    parameters, and the padded head's ``wo`` rows start at zero."""
    ref, ranks = worlds
    cfg = _cfg("starcoder2-3b", 3, 1)
    p0 = interop.lm_params_from_numpy(cfg, ref["padded_q_heads"]["params"])
    assert p0["layers"][0]["mix"]["wq"].shape[1] == 4
    assert not p0["layers"][0]["mix"]["wo"][3:].any()
    for out in ranks[1:]:
        for a, b in zip(out["padded_q_heads"]["new"],
                        ranks[0]["padded_q_heads"]["new"]):
            assert torch.equal(a, b)


def test_bf16_collectives_average_gradients_in_their_own_dtype(worlds):
    """A bf16 model at data 2 x model 2: gradients cross the batch axes
    in float32 by default and in bf16 with ``bf16_collectives``; the
    latter's mean is the former's rounded once more, within 2^-8 (the
    bf16 unit roundoff) in error RMS, and the loss is the same."""
    _, ranks = worlds
    for out in ranks:
        loss32, g32 = out[("bf16_collectives", False)]
        loss16, g16 = out[("bf16_collectives", True)]
        assert loss16 == loss32
        assert {g.dtype for g in g32} == {torch.float32}
        assert {g.dtype for g in g16} == {torch.bfloat16}
        for a, b in zip(g16, g32):
            assert _rel_rms(a.float().numpy(), b.numpy()) <= 2.0 ** -8


def _unbroken(ref: dict):
    """The first case's two steps on one process from the reference's
    weights: (weights before, first metrics, second metrics, weights
    after)."""
    from repro_torch.runtime.meshenv import CPU_ENV
    name, arch, heads, kv = CASES[0]
    cfg = _cfg(arch, heads, kv)
    params = interop.lm_params_from_numpy(cfg, ref[name]["params"])
    before = [p.clone() for p in leaves(params)]
    batch = _batch(ref[name]["batch"])
    params, opt, m0 = _step(cfg, params, batch, CPU_ENV)
    params, _, m1 = _step(cfg, params, batch, CPU_ENV, opt=opt)
    return before, m0, m1, [p.detach() for p in leaves(params)]


def _assert_steps_on(rec: dict, m1: dict, after, before) -> None:
    assert rec["step"] == 1
    assert rec["loss1"] == pytest.approx(m1["loss"], rel=LOSS_RTOL)
    for g, w, p0 in zip(rec["new"], after, before):
        assert _rel_rms((g - p0).numpy(), (w - p0).numpy()) <= UPDATE_RMS


def test_elastic_resume_on_a_smaller_mesh_matches_an_unbroken_run(worlds):
    """A logical checkpoint saved at data 2 x model 2 after one step,
    restored on the surviving data 1 x model 2 mesh (ranks 0 and 1),
    steps on as an unbroken two-step run on one process does."""
    ref, ranks = worlds
    assert [o["elastic"]["member"] for o in ranks] == [True, True,
                                                       False, False]
    assert ranks[0]["elastic"]["shape"] == {"data": 1, "model": 2}
    before, m0, m1, after = _unbroken(ref)
    for out in ranks[:2]:
        e = out["elastic"]
        assert e["loss0"] == pytest.approx(m0["loss"], rel=LOSS_RTOL)
        _assert_steps_on(e, m1, after, before)


@pytest.mark.parametrize("label,shape,members", [
    ("shrunk", {"data": 1, "model": 2}, [True, True, False, False]),
    ("data4", {"data": 4, "model": 1}, [True] * 4)])
def test_remesh_state_steps_on_as_an_unbroken_run(worlds, label, shape,
                                                  members):
    """The live state (weights and ZeRO-1 moments) after one step at
    data 2 x model 2, re-cut by ``remesh_state`` for a new mesh: a
    dropped rank gets nothing, the moments come out as the new mesh's
    ZeRO-1 cuts them, and one more step there matches an unbroken
    two-step run on one process."""
    ref, ranks = worlds
    before, _, m1, after = _unbroken(ref)
    for out, member in zip(ranks, members):
        rec = out[("remesh", label)]
        assert rec["member"] == member
        if member:
            assert rec["shape"] == shape
            assert rec["m_shapes"] == rec["m_want"]
            _assert_steps_on(rec, m1, after, before)


def _run(args, cwd) -> str:
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run([sys.executable, *args], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr[-3000:]
    return proc.stdout


def _losses(out: str) -> dict:
    return {int(s): float(v) for s, v in
            re.findall(r"step\s+(\d+) loss ([0-9.]+)", out)}


def test_launcher_mesh_host_under_torchrun_resumes_on_one_process(tmp_path):
    """``--mesh host`` under ``torch.distributed.run`` (2 CPU ranks, a
    data mesh, ZeRO-1) trains 2 of 4 steps and checkpoints logical
    tensors; one process resumes at step 2.  The first rank alone
    prints, and the losses of both runs agree with an unbroken
    one-process run within 1e-3 (the bf16 smoke config: each rank's
    half of the batch is rounded apart from the whole batch's)."""
    from repro_torch.launch import train as t_launch
    args = ["--device", "cpu", "--size", "smoke", "--steps", "4", "--seq",
            "16", "--batch", "2"]
    ck = ["--ckpt-dir", str(tmp_path / "ck"), "--ckpt-every", "2",
          "--resume"]
    first = _run(["-m", "torch.distributed.run", "--standalone",
                  "--nproc-per-node", "2", "-m", "repro_torch.launch.train",
                  "--mesh", "host", *args, *ck, "--stop-after", "2"],
                 tmp_path)
    assert first.count("[preempt] stopping after 2 steps") == 1, first
    assert sorted(_losses(first)) == [0, 1]
    second = _run(["-m", "repro_torch.launch.train", *args, *ck], tmp_path)
    assert "[resume] restored step 2, data cursor 2" in second
    straight = t_launch.run(t_launch.parse_args(args))["losses"]
    resumed = {**_losses(first), **_losses(second)}
    assert sorted(resumed) == [0, 1, 2, 3]
    for s, v in straight.items():
        assert resumed[s] == pytest.approx(v, rel=1e-3), s
