"""Carrying state across from the JAX package.

The planner's state is the scenario, the layer profile and the plan
table; the language model's is its parameter tree.  These functions take
them as plain numpy arrays and dicts — what the reference's
``Scenario.to_dict()``, ``LayerProfile`` fields, ``FleetState`` columns,
``init_lm`` leaves and ``prefill`` caches hold — so nothing here imports
the reference.  A
differential test seeds the port's planner with the reference's plan
table through :func:`fleet_from_columns`, the port's language model with
the reference's weights through :func:`lm_params_from_numpy`, or its
chain CNN through :func:`cnn_params_from_numpy`, and both packages then
compute the same step.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch._tree import leaves, tree_map
from repro_torch.api.scenario import Scenario
from repro_torch.configs.base import ATTN_GLOBAL, ATTN_LOCAL, ModelConfig
from repro_torch.configs.chain_cnns import ChainCNNConfig
from repro_torch.core.costs import LayerProfile
from repro_torch.core.planner import PLAN_FIELDS, FleetState
from repro_torch.models.transformer import (encoder_cfg, layer_cache_specs,
                                            param_specs)
from repro_torch.runtime.meshenv import MeshEnv, shard_tree

_INT_COLUMNS = ("server", "split", "R")


def scenario_from_dict(d: dict) -> Scenario:
    """A port Scenario from the reference's ``Scenario.to_dict()``."""
    return Scenario.from_dict(d)


def profile_from_arrays(name: str, flops, out_bits, in_bits: float,
                        result_bits: float) -> LayerProfile:
    """A LayerProfile whose ``fingerprint`` equals the reference's for
    the same name and arrays."""
    return LayerProfile(name=name,
                        flops=np.asarray(flops, np.float64),
                        out_bits=np.asarray(out_bits, np.float64),
                        in_bits=float(in_bits),
                        result_bits=float(result_bits))


def fleet_from_columns(cols: dict) -> FleetState:
    """A FleetState from a dict of the reference FleetState's columns
    (copied, so the port never writes into the caller's arrays)."""
    missing = set(PLAN_FIELDS) - set(cols)
    if missing:
        raise KeyError(f"missing FleetState columns: {sorted(missing)}")
    return FleetState(**{
        k: np.array(cols[k], np.int64 if k in _INT_COLUMNS else np.float64)
        for k in PLAN_FIELDS})


def _tensor(a) -> torch.Tensor:
    """A CPU tensor of a numpy leaf; bfloat16 (ml_dtypes) goes through
    float32, which holds every bfloat16 value exactly."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    return torch.from_numpy(np.array(a))


def _unstack_blocks(cfg: ModelConfig, stack: dict) -> list:
    """One tree per block from the reference's ``{"tail", "scan"}``
    stacking: block ``i`` is ``tail[i]`` for the first ``num_layers %
    len(pattern)`` blocks, then superblock ``j // period`` of
    ``scan[j % period]``."""
    period = len(cfg.pattern)
    rem = cfg.num_layers % period
    blocks = []
    for i in range(cfg.num_layers):
        if i < rem:
            blocks.append(tree_map(_tensor, stack["tail"][i]))
        else:
            j = i - rem
            blocks.append(tree_map(
                lambda a, n=j // period: _tensor(np.asarray(a)[n]),
                stack["scan"][j % period]))
    return blocks


def lm_params_from_numpy(cfg: ModelConfig, tree: dict) -> dict:
    """The port's parameters (CPU tensors) from the reference's ``init_lm``
    tree as numpy leaves: ``embed`` (Vp, d), ``final_norm`` (d,),
    ``unembed`` (d, Vp) unless tied, and ``stack`` = {``tail``: one block
    per remainder layer, ``scan``: one block per pattern position, each
    leaf stacked on a leading superblock axis}: the stacking of
    :func:`_unstack_blocks`, whatever the blocks hold (attention, MoE,
    RWKV-6 or RG-LRU leaves, an encoder-decoder's ``ln_cross`` and
    ``cross``).  An encoder-decoder's ``encoder`` stack, stacked the same
    way, becomes a list of blocks beside ``enc_norm``."""
    params = {"embed": _tensor(tree["embed"]),
              "final_norm": _tensor(tree["final_norm"]),
              "layers": _unstack_blocks(cfg, tree["stack"])}
    if not cfg.tie_embeddings:
        params["unembed"] = _tensor(tree["unembed"])
    if cfg.enc_dec:
        params["encoder"] = _unstack_blocks(encoder_cfg(cfg),
                                            tree["encoder"])
        params["enc_norm"] = _tensor(tree["enc_norm"])
    return params


def shard_lm_params(cfg: ModelConfig, tree: dict, env: MeshEnv) -> dict:
    """One rank's parameters under ``env`` from a logical tree: the
    reference's ``init_lm`` tree as numpy leaves (its ``stack``
    unstacked first, :func:`lm_params_from_numpy`) or the port's own
    (``init_lm(cfg, gen, device, env)``), each leaf cut by
    :func:`repro_torch.models.transformer.param_specs`."""
    if "stack" in tree:
        tree = lm_params_from_numpy(cfg, tree)
    return shard_tree(tree, param_specs(cfg, env), env)


def lm_caches_from_numpy(cfg: ModelConfig, tree: dict) -> list:
    """The port's caches (CPU tensors, one tree per block) from the
    reference's ``prefill``/``init_caches`` caches as numpy leaves,
    stacked as the parameters are.  An attention block's ``{"mix": {"k",
    "v"}}`` becomes the port's ``{"k", "v"}`` (a sliding-window ring in
    the same slot order; int8 codes with their ``k_scale``/``v_scale``),
    with an encoder-decoder's ``"cross"`` k/v beside them; RWKV-6 and
    RG-LRU state trees carry over as they are."""
    blocks = _unstack_blocks(cfg, tree)
    types = cfg.layer_types()
    out = []
    for b, lt in zip(blocks, types):
        if lt in (ATTN_GLOBAL, ATTN_LOCAL):
            b = dict(b["mix"], **{k: v for k, v in b.items() if k != "mix"})
        out.append(b)
    return out


def shard_lm_caches(cfg: ModelConfig, tree, env: MeshEnv) -> list:
    """One rank's caches under ``env`` from whole (logical) caches: the
    reference's stacked tree as numpy leaves (converted first,
    :func:`lm_caches_from_numpy`) or the port's list, each block cut by
    :func:`repro_torch.models.transformer.layer_cache_specs` of its own
    batch, length, source length and int8 scales."""
    if isinstance(tree, dict):
        tree = lm_caches_from_numpy(cfg, tree)
    out = []
    for c, lt in zip(tree, cfg.layer_types()):
        batch = leaves(c)[0].shape[0]
        L = c["k"].shape[1] if "k" in c else 0
        cross = c["cross"]["k"].shape[1] if "cross" in c else 0
        specs = layer_cache_specs(cfg, env, lt, batch, L, cross,
                                  "k_scale" in c)
        out.append(shard_tree(c, specs, env))
    return out


def cnn_params_from_numpy(cfg: ChainCNNConfig, params: list) -> list:
    """The port's chain-CNN parameters (CPU float32 tensors) from the
    reference's ``init_cnn`` list as numpy leaves: a conv's HWIO weight
    becomes the port's (Cout, Cin, K, K) in channels-last memory, its bias
    carries over; a pool has none; an fc keeps its (In, Out) weight, rows
    in the reference's NHWC flatten order, and its bias."""
    out = []
    for layer, p in zip(cfg.layers, params):
        if layer.kind == "conv":
            w = _tensor(p["w"]).permute(3, 2, 0, 1)
            out.append({"w": w.contiguous(
                memory_format=torch.channels_last), "b": _tensor(p["b"])})
        elif layer.kind == "pool":
            out.append({})
        else:
            out.append({"w": _tensor(p["w"]), "b": _tensor(p["b"])})
    return out
