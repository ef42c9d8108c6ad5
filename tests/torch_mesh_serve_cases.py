"""Shared pieces of the ``test_torch_mesh_serve*`` files: every model
family's float32 prefill and greedy decode steps on a mesh against the
JAX package's own mesh path.

A case is (name, arch, ``reduced`` kwargs, mesh (data, model), extras);
extras may hold ``kv_quant`` (int8 caches), ``positions`` (per-sequence
(B,) positions at decode, each row its own offset), ``batch`` (the
batch size, default ``BATCH``), ``prompt`` (the prompt length, default
``PROMPT``), ``drops`` (count the assignments the MoE's decode
capacity drops) and ``cp`` (both packages under context-parallel
attention).  The port runs it in a spawned four-rank gloo world
(``torch_mesh_ranks``; a mesh of fewer ranks leaves the others out),
the reference in a subprocess with four forced host devices, jitting
``transformer.prefill`` with a cache longer than the prompt (its
``build_prefill`` fixes the cache to the prompt, ROADMAP §3) and
``transformer.decode_step`` with their shardings (parameters by their
spec tree, the batch's rows over ``data`` when they divide it, the
caches by ``abstract_caches``' specs, the logits over ``(b, "model")``),
both from the same numpy weights (the family train cases' weights,
``torch_mesh_family_cases.inputs_for``) and prompts.

Each rank returns, gathered over its mesh: the prefill's logits (B, Vp)
and caches, then for each of ``STEPS`` greedy decode steps its logits,
next tokens and, after the last, its caches; and whether
``interop.shard_lm_caches`` of the gathered caches gives back its own
pieces.

This module imports nothing of JAX or of the JAX package, so a spawned
rank loads only the port.
"""
from __future__ import annotations

import os
import pickle
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

from torch_mesh_family_cases import cfg_of

ROOT = Path(__file__).resolve().parents[1]
BATCH, PROMPT, CACHE_LEN, STEPS = 4, 12, 24, 3
#: the one-process serving tests' float32 bounds (test_torch_hybrid.py,
#: test_torch_kv_int8.py): logits and float cache leaves within rtol
#: 1e-4 (atol 1e-5 near zero), float32 sums in other orders; int8 codes
#: within one step on at most CODE_SHARE of them (a rounding tie that
#: the sums' order moves)
RTOL, ATOL, CODE_SHARE = 1e-4, 1e-5, 1e-3
REFERENCE_TIMEOUT_S = 300

_REFERENCE = r"""
import dataclasses, os, pickle, sys
os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                           + " --xla_force_host_platform_device_count=4")
os.environ["JAX_PLATFORMS"] = "cpu"
import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import NamedSharding, PartitionSpec as P
from repro.configs import get_config, reduced
from repro.launch.steps import abstract_caches
from repro.models import transformer as tfm
from repro.runtime.meshenv import make_env
from repro.runtime.train import shardings_for

assert jax.device_count() == 4
with open(sys.argv[1], "rb") as f:
    inputs = pickle.load(f)
out = {}
for name, arch, kw, (data, model), extras in inputs["__cases__"]:
    devs = np.asarray(jax.devices()[:data * model]).reshape(data, model)
    env = make_env(jax.sharding.Mesh(devs, ("data", "model")),
                   context_parallel_attn="cp" in extras)
    cfg = dataclasses.replace(reduced(get_config(arch), **kw),
                              dtype="float32")
    r = inputs[name]
    specs = {}

    def init(key):
        params, specs["p"] = tfm.init_lm(cfg, key, env)
        return params

    jax.eval_shape(init, jax.random.PRNGKey(0))
    params = jax.tree.map(jnp.asarray, r["params"])
    batch = {k: jnp.asarray(v) for k, v in r["batch"].items()}
    B = batch["tokens"].shape[0]
    b_ax = env.batch_if(B)
    total = batch["tokens"].shape[1] + (batch["patch_embeds"].shape[1]
                                        if "patch_embeds" in batch else 0)
    cross = batch["src_embeds"].shape[1] if "src_embeds" in batch else 0
    quant = "kv_quant" in extras
    _, cspecs = abstract_caches(cfg, env, B, r["cache_len"], cross,
                                kv_quant=quant)
    c_sh = shardings_for(env, cspecs)
    p_sh = shardings_for(env, specs["p"])
    b_sh = {k: NamedSharding(env.mesh, P(b_ax, *([None] * (v.ndim - 1))))
            for k, v in batch.items()}
    lg_sh = NamedSharding(env.mesh, P(b_ax, "model"))
    pre = jax.jit(lambda p, b: tfm.prefill(cfg, p, env, b,
                                           cache_len=r["cache_len"],
                                           kv_quant=quant),
                  in_shardings=(p_sh, b_sh), out_shardings=(lg_sh, c_sh))
    logits, caches = pre(params, batch)
    rec = {"prefill": {"logits": np.asarray(logits),
                       "caches": jax.tree.map(np.asarray, caches)}}
    pos_sh = NamedSharding(env.mesh, P(b_ax) if "positions" in extras
                           else P())
    dec = jax.jit(lambda p, t, q, c: tfm.decode_step(cfg, p, env, t, q, c),
                  in_shardings=(p_sh, NamedSharding(env.mesh, P(b_ax, None)),
                                pos_sh, c_sh),
                  out_shardings=(lg_sh, NamedSharding(env.mesh, P(b_ax)),
                                 c_sh))
    token = jnp.argmax(logits[:, :cfg.vocab_size], axis=-1)
    steps = []
    for i, pos in enumerate(r["positions"]):
        logits, token, caches = dec(params, token[:, None].astype(jnp.int32),
                                    jnp.asarray(pos), caches)
        steps.append({"logits": np.asarray(logits),
                      "token": np.asarray(token)})
    rec["steps"] = steps
    rec["caches"] = jax.tree.map(np.asarray, caches)
    out[name] = rec
with open(sys.argv[2], "wb") as f:
    pickle.dump(out, f)
"""


def _positions(total: int, B: int, per_row: bool) -> list:
    """Each decode step's position: the scalar total + i, or per row
    total + i + (b mod 2), so that rows write different slots."""
    out = []
    for i in range(STEPS):
        if per_row:
            out.append((total + i + np.arange(B) % 2).astype(np.int32))
        else:
            out.append(np.int32(total + i))
    return out


def inputs_for(cases) -> dict:
    """Every case's weights (the family train cases', in the
    reference's stacked tree), its prompts (tokens, and ``patch_embeds``
    or ``src_embeds`` as the family takes them), its cache length and
    its decode positions."""
    import torch_mesh_family_cases as fam
    train_cases = [(n, a, kw, shape, ()) for n, a, kw, shape, _ in cases]
    out = fam.inputs_for(train_cases)
    rng = np.random.default_rng(7)
    for name, arch, kw, _, extras in cases:
        cfg = cfg_of(arch, kw)
        ex = dict(e if isinstance(e, tuple) else (e, True) for e in extras)
        B, S = ex.get("batch", BATCH), ex.get("prompt", PROMPT)
        batch = {"tokens": rng.integers(0, cfg.vocab_size, (B, S))
                 .astype(np.int32)}
        prefix = 0
        if cfg.frontend == "vit":
            prefix = cfg.frontend_len
            batch["patch_embeds"] = rng.standard_normal(
                (B, prefix, cfg.d_model)).astype(np.float32)
        if cfg.enc_dec:
            batch["src_embeds"] = rng.standard_normal(
                (B, ex.get("source", S), cfg.d_model)).astype(np.float32)
        cache_len = ex.get("cache_len", CACHE_LEN)
        assert cache_len >= S + prefix + STEPS + 1
        out[name].update(batch=batch, cache_len=cache_len,
                         positions=_positions(S + prefix, B,
                                              "positions" in ex))
    return out


def _extras(case) -> dict:
    return dict(e if isinstance(e, tuple) else (e, True) for e in case[4])


def serve_rank(rank: int, inputs: dict) -> dict:
    """Every case's prefill and STEPS greedy decode steps on its mesh (a
    rank past the mesh only builds it), gathered over the mesh."""
    from repro_torch import interop
    from repro_torch._tree import leaves
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import transformer as tfm
    from repro_torch.runtime.meshenv import P, make_env, unshard_tree
    out = {}
    for case in inputs["__cases__"]:
        name, arch, kw, shape, _ = case
        ex = _extras(case)
        cfg = cfg_of(arch, kw)
        env = make_env(make_mesh(shape, ("data", "model")),
                       context_parallel_attn=bool(ex.get("cp")))
        if not env.member:
            continue
        r = inputs[name]
        params = interop.shard_lm_params(cfg, r["params"], env)
        batch = {k: torch.from_numpy(np.asarray(v))
                 for k, v in r["batch"].items()}
        B = batch["tokens"].shape[0]
        b_ax = env.batch_if(B)
        total = batch["tokens"].shape[1] + (
            batch["patch_embeds"].shape[1] if "patch_embeds" in batch else 0)
        cross = (batch["src_embeds"].shape[1] if "src_embeds" in batch
                 else 0)
        quant = bool(ex.get("kv_quant"))
        specs = tfm.cache_specs(cfg, env, B, r["cache_len"], cross, quant)
        rec = {}
        with torch.no_grad(), _DropCounter(cfg) as drops:
            logits, caches = tfm.prefill(cfg, params, batch,
                                         cache_len=r["cache_len"],
                                         kv_quant=quant, env=env)
            full = unshard_tree(caches, specs, env)
            rec["prefill"] = {"logits": env.unshard(logits,
                                                    P(b_ax, "model")),
                              "caches": full}
            again = interop.shard_lm_caches(cfg, full, env)
            rec["reshard"] = all(torch.equal(a, b) for a, b in zip(
                leaves(again), leaves(caches)))
            drops.clear()
            token = torch.argmax(rec["prefill"]["logits"][:, :cfg.vocab_size],
                                 dim=-1)
            steps = []
            for pos in r["positions"]:
                pos = torch.from_numpy(np.asarray(pos).astype(np.int64))
                logits, nxt, caches = tfm.decode_step(
                    cfg, params, token[:, None], pos, caches, env=env,
                    specs=specs)
                token = env.unshard(nxt, P(b_ax))
                steps.append({"logits": env.unshard(logits, P(b_ax, "model")),
                              "token": token})
            rec["steps"] = steps
            rec["caches"] = unshard_tree(caches, specs, env)
            rec["decode_drops"] = sum(drops)
        out[name] = rec
    return out


class _DropCounter:
    """Counts, per ``moe._moe_local`` call in the block, the
    token-expert assignments its capacity drops (the router's top-k of
    the call's inputs; on a data mesh each expert's earlier data ranks'
    assignments first, as the call does); a list of counts."""

    def __init__(self, cfg):
        self.on = bool(cfg.num_experts)

    def __enter__(self):
        from repro_torch.models import moe as moe_mod
        self.seen, self.inner = [], moe_mod._moe_local
        if not self.on:
            return self.seen
        inner, seen = self.inner, self.seen

        def spy(x_flat, router, *a, num_experts, top_k, capacity, **kw):
            idx = torch.topk(x_flat.float() @ router, top_k,
                             dim=-1).indices.reshape(-1)
            counts = torch.bincount(idx, minlength=num_experts)
            before = torch.zeros_like(counts)
            axis, env = kw.get("data_axis"), kw.get("env")
            if axis is not None:
                parts = env.gather_parts(counts, axis)
                i = env.axis_index(axis)
                if i:
                    before = torch.stack(parts[:i]).sum(dim=0)
            kept = torch.minimum(torch.clamp(capacity - before, min=0),
                                 counts)
            seen.append(int((counts - kept).sum()))
            return inner(x_flat, router, *a, num_experts=num_experts,
                         top_k=top_k, capacity=capacity, **kw)

        moe_mod._moe_local = spy
        return seen

    def __exit__(self, *exc):
        from repro_torch.models import moe as moe_mod
        moe_mod._moe_local = self.inner
        return False


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
        ranks = run_world(serve_rank, 4, tmp / "world", inputs)
        _, err = proc.communicate(timeout=REFERENCE_TIMEOUT_S)
    assert proc.returncode == 0, err[-3000:]
    with open(tmp / "ref.pkl", "rb") as f:
        ref = pickle.load(f)
    for name in ref:
        ref[name].update(inputs[name])
    return ref, ranks


def members(ranks, shape) -> list:
    return ranks[:int(np.prod(shape))]


def _close(got, want, what: str) -> None:
    np.testing.assert_allclose(np.asarray(got, np.float64),
                               np.asarray(want, np.float64), rtol=RTOL,
                               atol=ATOL, err_msg=what)


def assert_caches(cfg, got: list, want_tree: dict, what: str) -> None:
    """Every leaf of the port's gathered caches against the reference's
    (its stacked tree converted by ``interop.lm_caches_from_numpy``)."""
    from repro_torch import interop
    from repro_torch._tree import leaves, tree_map
    want = interop.lm_caches_from_numpy(cfg, want_tree)
    assert tree_map(lambda t: tuple(t.shape), got) == \
        tree_map(lambda t: tuple(t.shape), want), what
    for i, (g, w) in enumerate(zip(leaves(got), leaves(want))):
        if w.dtype == torch.int8:
            d = np.abs(g.numpy().astype(np.int32) - w.numpy().astype(np.int32))
            assert d.max() <= 1 and np.mean(d > 0) <= CODE_SHARE, (
                what, i, int((d > 0).sum()))
        else:
            _close(g.numpy(), w.numpy(), f"{what} leaf {i}")


def assert_case(ref: dict, ranks: list, case) -> None:
    """Prefill logits and caches, every decode step's logits and greedy
    tokens, the caches after the last step, on every member rank."""
    name, arch, kw, shape, _ = case
    cfg = cfg_of(arch, kw)
    want = ref[name]
    for rank, out in enumerate(members(ranks, shape)):
        got = out[name]
        _close(got["prefill"]["logits"].numpy(), want["prefill"]["logits"],
               f"rank {rank} prefill logits")
        assert_caches(cfg, got["prefill"]["caches"],
                      want["prefill"]["caches"], f"rank {rank} prefill")
        assert got["reshard"], rank
        for i, (g, w) in enumerate(zip(got["steps"], want["steps"])):
            _close(g["logits"].numpy(), w["logits"],
                   f"rank {rank} step {i} logits")
            np.testing.assert_array_equal(g["token"].numpy(), w["token"])
        assert_caches(cfg, got["caches"], want["caches"],
                      f"rank {rank} after decode")


__all__ = ["BATCH", "CACHE_LEN", "PROMPT", "STEPS",
           "assert_case", "inputs_for", "members", "run_cases",
           "serve_rank"]
