"""The rank side of ``tests/test_torch_mesh_int8_chain.py``: a reduced
dense decoder served on a model-4 mesh with int8 caches (the cache
length sharded, as ``chip_smoke.py``'s [mesh] (e) int8 case), its prefill
and decode steps from its own prefill's codes.

This module imports nothing of JAX or of the JAX package, so a spawned
rank loads only the port.
"""
from __future__ import annotations

import dataclasses

import torch

#: the mesh (data, model), the batch, the prompt, the cache, the steps
SHAPE = (1, 4)
BATCH, PROMPT, CACHE_LEN, STEPS = 4, 1024, 1032, 3


def chain_cfg():
    from repro_torch.configs import get_config, reduced
    return dataclasses.replace(
        reduced(get_config("qwen3-8b"), layers=2, d_model=64, heads=4,
                kv_heads=2, d_ff=64, vocab=300), dtype="float32")


def chain_inputs(cfg) -> dict:
    """The prompts and each decode step's fed tokens, from a seed."""
    g = torch.Generator().manual_seed(5)
    return {"tokens": torch.randint(0, cfg.vocab_size, (BATCH, PROMPT),
                                    generator=g, dtype=torch.int32),
            "steps": [torch.randint(0, cfg.vocab_size, (BATCH,),
                                    generator=g, dtype=torch.int32)
                      for _ in range(STEPS)]}


def layout_params(cfg, env):
    """The weights of the mesh's layout (``init_lm`` from seed 0), as
    ``chip_smoke.mesh_serve_baseline`` draws them."""
    from repro_torch.models import transformer as tfm
    return tfm.init_lm(cfg, torch.Generator().manual_seed(0), "cpu", env)


def chain_rank(rank: int) -> dict:
    """The mesh's int8 prefill and its decode steps from its own codes:
    the prefill's caches gathered whole and each step's logits."""
    from repro_torch import interop
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import transformer as tfm
    from repro_torch.runtime.meshenv import P, make_env, unshard_tree
    cfg = chain_cfg()
    env = make_env(make_mesh(SHAPE, ("data", "model")))
    params = interop.shard_lm_params(cfg, layout_params(cfg, env), env)
    inputs = chain_inputs(cfg)
    specs = tfm.cache_specs(cfg, env, BATCH, CACHE_LEN, 0, True)
    b_ax = env.batch_if(BATCH)
    with torch.no_grad():
        _, caches = tfm.prefill(cfg, params, {"tokens": inputs["tokens"]},
                                cache_len=CACHE_LEN, kv_quant=True, env=env)
        full = unshard_tree(caches, specs, env)
        logits = []
        for i, tok in enumerate(inputs["steps"]):
            out, _, caches = tfm.decode_step(cfg, params, tok[:, None],
                                             PROMPT + i, caches, env=env,
                                             specs=specs)
            logits.append(env.unshard(out, P(b_ax, "model")))
    return {"prefill_caches": full, "logits": logits}


__all__ = ["BATCH", "CACHE_LEN", "PROMPT", "SHAPE", "STEPS", "chain_cfg",
           "chain_inputs", "chain_rank", "layout_params"]
