"""Shared pieces of ``tests/test_torch_mesh_engine.py``: the serving
engine and the split server on a data 2 x model 2 mesh, with and without
context-parallel attention, against the JAX package's own
``InferenceEngine(env=)`` and ``SplitServer(env=)``.

A case is (name, arch, ``reduced`` kwargs, context-parallel flag).  The
port runs every case in a spawned four-rank gloo world
(``torch_mesh_ranks``), the reference in a subprocess with four forced
host devices, both from the same numpy weights
(``torch_mesh_family_cases.inputs_for``: the port's ``init_lm`` for
tp 2, norms randomised): ``PROMPTS`` into 4 slots of ``CACHE_LEN``
positions, ``NEW`` greedy tokens each, and one split generation of a
(2, ``SPLIT_PROMPT``) batch at block ``SPLIT``.  The port also
migrates one stream mid-run (``export_cache``, ``cancel``,
``import_cache`` on the same mesh engine) and exports it once more
beside a one-process engine's export at the same step.

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
MESH = (2, 2)
PROMPT_LENS = (5, 9, 12, 7)
NEW, SLOTS, CACHE_LEN = 6, 4, 32
SPLIT, SPLIT_PROMPT, SPLIT_NEW = 1, 8, 4
#: the step after which the port migrates stream 1
MIGRATE_AFTER = 3
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
from repro.runtime.meshenv import make_env
from repro.serving.engine import InferenceEngine
from repro.serving.split import SplitServer

assert jax.device_count() == 4
with open(sys.argv[1], "rb") as f:
    inputs = pickle.load(f)
out = {}
for name, arch, kw, cp in inputs["__engine_cases__"]:
    devs = np.asarray(jax.devices()).reshape(2, 2)
    env = make_env(jax.sharding.Mesh(devs, ("data", "model")),
                   context_parallel_attn=cp)
    cfg = dataclasses.replace(reduced(get_config(arch), **kw),
                              dtype="float32")
    r = inputs[name]
    params = jax.tree.map(jnp.asarray, r["params"])
    eng = InferenceEngine(cfg, params, env=env, slots=r["slots"],
                          cache_len=r["cache_len"])
    for p in r["prompts"]:
        eng.submit(p, r["new"])
    res = eng.run_to_completion()
    split = SplitServer(cfg, params, env=env).generate(
        jnp.asarray(r["split_tokens"]), r["split"], r["split_new"])
    out[name] = {"engine": {k: list(map(int, v)) for k, v in res.items()},
                 "split": np.asarray(split)}
with open(sys.argv[2], "wb") as f:
    pickle.dump(out, f)
"""


def inputs_for(cases) -> dict:
    """Every case's weights (the family train cases' at ``MESH``), its
    prompts and its split batch."""
    import torch_mesh_family_cases as fam
    out = fam.inputs_for([(n, a, kw, MESH, ()) for n, a, kw, _ in cases])
    out.pop("__cases__")
    out["__engine_cases__"] = list(cases)
    rng = np.random.default_rng(11)
    for name, arch, kw, _ in cases:
        vocab = cfg_of(arch, kw).vocab_size
        out[name].update(
            prompts=[rng.integers(0, vocab, n).astype(np.int32)
                     for n in PROMPT_LENS],
            split_tokens=rng.integers(0, vocab, (2, SPLIT_PROMPT))
            .astype(np.int32),
            slots=SLOTS, cache_len=CACHE_LEN, new=NEW, split=SPLIT,
            split_new=SPLIT_NEW)
    return out


def engine_rank(rank: int, inputs: dict) -> dict:
    """Every case on the mesh: the engine's tokens by request, the
    tokens of a run that migrates stream 1 after ``MIGRATE_AFTER``
    steps, the migrated stream's whole cache leaves beside a
    one-process engine's at that step, and the split generation."""
    from repro_torch import interop
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.runtime.meshenv import make_env
    from repro_torch.serving.engine import InferenceEngine
    from repro_torch.serving.split import SplitServer
    out = {}
    for name, arch, kw, cp in inputs["__engine_cases__"]:
        cfg = cfg_of(arch, kw)
        env = make_env(make_mesh(MESH, ("data", "model")),
                       context_parallel_attn=cp)
        r = inputs[name]
        params = interop.shard_lm_params(cfg, r["params"], env)
        whole = interop.lm_params_from_numpy(cfg, r["params"])
        rec = {}
        with torch.no_grad():
            eng = InferenceEngine(cfg, params, device="cpu", slots=SLOTS,
                                  cache_len=CACHE_LEN, env=env)
            for p in r["prompts"]:
                eng.submit(p, NEW)
            rec["engine"] = {k: list(v) for k, v in
                             eng.run_to_completion().items()}
            rec["migrated"], rec["exported"] = _migrate(cfg, params, whole,
                                                        r["prompts"], env)
            rec["split"] = SplitServer(cfg, params, device="cpu",
                                       env=env).generate(
                torch.from_numpy(r["split_tokens"]).long(), SPLIT,
                SPLIT_NEW)
        out[name] = rec
    return out


def _migrate(cfg, params, whole, prompts, env) -> tuple:
    """Stream 1 exported after ``MIGRATE_AFTER`` steps, cancelled and
    imported back into the mesh engine: every request's tokens (stream
    1's as the tokens before and after the move), and its exported
    leaves with a one-process engine's at the same step."""
    from repro_torch.serving.engine import InferenceEngine
    engines = [InferenceEngine(cfg, params, device="cpu", slots=SLOTS,
                               cache_len=CACHE_LEN, env=env),
               InferenceEngine(cfg, whole, device="cpu", slots=SLOTS,
                               cache_len=CACHE_LEN)]
    for eng in engines:
        for p in prompts:
            eng.submit(p, NEW)
        for _ in range(MIGRATE_AFTER):
            eng.step()
    (mesh_leaves, pos), (one_leaves, one_pos) = (
        e.export_cache(1) for e in engines)
    assert pos == one_pos
    eng = engines[0]
    done = eng.cancel(1)
    rid = eng.import_cache(np.concatenate([prompts[1], done]),
                           NEW - len(done), mesh_leaves, pos)
    res = {k: list(v) for k, v in eng.run_to_completion().items()}
    res[1] = list(done) + res.pop(rid)
    return res, (mesh_leaves, one_leaves)


def run_cases(cases, tmp: Path) -> tuple:
    """The reference's subprocess and the port's world at once; returns
    (reference records, rank records)."""
    from torch_mesh_ranks import run_world
    inputs = inputs_for(cases)
    with open(tmp / "inputs.pkl", "wb") as f:
        pickle.dump(inputs, f)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    with subprocess.Popen([sys.executable, "-c", _REFERENCE,
                           str(tmp / "inputs.pkl"), str(tmp / "ref.pkl")],
                          cwd=ROOT, env=env, stdout=subprocess.PIPE,
                          stderr=subprocess.PIPE, text=True) as proc:
        ranks = run_world(engine_rank, 4, tmp / "world", inputs)
        _, err = proc.communicate(timeout=REFERENCE_TIMEOUT_S)
    assert proc.returncode == 0, err[-3000:]
    with open(tmp / "ref.pkl", "rb") as f:
        ref = pickle.load(f)
    return ref, ranks


__all__ = ["CACHE_LEN", "NEW", "PROMPT_LENS", "SLOTS", "engine_rank",
           "inputs_for", "run_cases"]
