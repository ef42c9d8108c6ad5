"""Cell programs: (architecture x input shape) -> a step and its specs.

The port of the JAX package's ``repro/launch/steps.py``.  One
:class:`CellProgram` describes what a launcher runs for a cell:

* ``train_4k``     -> ``train_step(params, opt_state, batch)``
* ``prefill_32k``  -> ``prefill_step(params, batch)``
* ``decode_32k`` / ``long_500k`` -> ``serve_step(params, token, pos,
  caches)``

Its ``args`` are stand-ins on the ``meta`` device at the global (padded)
shapes: building a program allocates nothing, so full-size yi-34b or
gemma3-27b programs build for a 512-rank layout on any host.  Its
``in_specs``/``out_specs`` are ``PartitionSpec`` trees in the port's
trees, the specs of the reference's shardings (None off a mesh), and
``fn`` runs on a rank: it takes the rank's shards of the state
(parameters, optimizer state, caches) and the batch inputs whole (the
batch dict, ``token``, ``pos``), of which it keeps its own rows, as
``runtime.train.make_train_step``'s step does; it returns the rank's
pieces of the outputs under ``out_specs``.  The reference's
``jitted()``/``lower()`` have no counterpart here: lowering a program is
the dry run's (ROADMAP item 8d).

:func:`input_specs` is the shape oracle: stand-ins for every model input
of a cell (tokens and labels, the stubbed frontends' precomputed
embeddings, the decode token and position).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig, ShapeCell, supports_cell
from repro_torch.models import transformer as tfm
from repro_torch.models.layers import param_dtype
from repro_torch.optim import adamw
from repro_torch.runtime.meshenv import MeshEnv, P
from repro_torch.runtime.train import (TrainConfig, make_train_step,
                                       opt_state_specs)
from repro_torch._tree import tree_map

#: encoder source length of an encoder-decoder's decode cells (the
#: decoder's cache holds the cell's seq_len; the cross memory is fixed)
DECODE_SRC_LEN = 4096
META = torch.device("meta")


@dataclasses.dataclass
class CellProgram:
    name: str
    kind: str                         # train | prefill | decode
    fn: Callable
    args: Tuple[Any, ...]             # meta stand-ins, global shapes
    in_specs: Optional[Tuple[Any, ...]]
    out_specs: Optional[Any]
    donate_argnums: Tuple[int, ...] = ()


# ---------------------------------------------------------------------------
# Abstract state (nothing allocated)
# ---------------------------------------------------------------------------
def abstract_params(cfg: ModelConfig, env: MeshEnv) -> tuple:
    """(parameter stand-ins on ``meta``, their spec tree) for ``env``:
    ``init_lm``'s shapes and dtypes, with nothing drawn."""
    params = tfm.init_lm(cfg, torch.Generator(), META, env)
    return params, tfm.param_specs(cfg, env)


def abstract_caches(cfg: ModelConfig, env: MeshEnv, batch: int,
                    cache_len: int, cross_len: int = 0,
                    kv_quant: bool = False) -> tuple:
    """(the whole caches of a ``batch`` on ``meta``, their spec tree under
    ``env``, :func:`repro_torch.models.transformer.cache_specs`)."""
    caches = tfm.init_caches(cfg, batch, cache_len, META, kv_quant,
                             cross_len)
    return caches, tfm.cache_specs(cfg, env, batch, cache_len, cross_len,
                                   kv_quant)


def abstract_opt_state(params) -> adamw.AdamWState:
    """AdamW's state of stand-in parameters (its moments on ``meta``)."""
    return adamw.init(params)


# ---------------------------------------------------------------------------
# Input specs (the shape oracle)
# ---------------------------------------------------------------------------
def _tok(b: int, s: int) -> torch.Tensor:
    return torch.empty((b, s), dtype=torch.int32, device=META)


def text_len(cfg: ModelConfig, cell: ShapeCell) -> int:
    """Token count such that the whole context (frontend prefix + text)
    equals the cell's seq_len."""
    if cfg.frontend == "vit":
        return cell.seq_len - cfg.frontend_len
    return cell.seq_len


def input_specs(cfg: ModelConfig, cell: ShapeCell) -> Dict[str, Any]:
    """Stand-ins (``meta``) for every model input of one cell."""
    B = cell.global_batch
    dt = param_dtype(cfg)
    if cell.kind in ("train", "prefill"):
        S = text_len(cfg, cell)
        out = {"tokens": _tok(B, S)}
        if cell.kind == "train":
            out["labels"] = _tok(B, S)
        if cfg.frontend == "vit":
            out["patch_embeds"] = torch.empty(
                (B, cfg.frontend_len, cfg.d_model), dtype=dt, device=META)
        if cfg.enc_dec:
            out["src_embeds"] = torch.empty((B, cell.seq_len, cfg.d_model),
                                            dtype=dt, device=META)
        return out
    # decode: one new token against a seq_len cache
    return {"token": _tok(B, 1),
            "pos": torch.empty((), dtype=torch.int32, device=META)}


def _batch_specs(env: MeshEnv, tree):
    """Each input's rows over the batch axes when they divide them."""
    if not env.is_spmd:
        return None

    def spec_of(x):
        if x.dim() and env.batch_if(x.shape[0]) is not None:
            return P(env.batch(), *([None] * (x.dim() - 1)))
        return P(*([None] * x.dim()))

    return tree_map(spec_of, tree)


# ---------------------------------------------------------------------------
# Cell program builders
# ---------------------------------------------------------------------------
def build_train(cfg: ModelConfig, env: MeshEnv, cell: ShapeCell,
                tcfg: TrainConfig = TrainConfig()) -> CellProgram:
    params, pspecs = abstract_params(cfg, env)
    opt = abstract_opt_state(params)
    batch = input_specs(cfg, cell)
    step = make_train_step(cfg, tcfg, env=env)
    in_specs = out_specs = None
    if env.is_spmd:
        o_specs = opt_state_specs(pspecs, params, env)
        in_specs = (pspecs, o_specs, _batch_specs(env, batch))
        out_specs = (pspecs, o_specs, {k: P() for k in
                                       ("loss", "aux", "total",
                                        "grad_norm")})
    return CellProgram(name=f"{cfg.name}:{cell.name}", kind="train", fn=step,
                       args=(params, opt, batch), in_specs=in_specs,
                       out_specs=out_specs, donate_argnums=(0, 1))


def build_prefill(cfg: ModelConfig, env: MeshEnv, cell: ShapeCell, *,
                  triangular: bool = False) -> CellProgram:
    params, pspecs = abstract_params(cfg, env)
    batch = input_specs(cfg, cell)
    B = cell.global_batch
    cross_len = cell.seq_len if cfg.enc_dec else 0
    _, cspecs = abstract_caches(cfg, env, B, cell.seq_len, cross_len)

    def prefill_step(params, batch):
        return tfm.prefill(cfg, params, batch, cache_len=cell.seq_len,
                           triangular=triangular, env=env)

    in_specs = out_specs = None
    if env.is_spmd:
        in_specs = (pspecs, _batch_specs(env, batch))
        out_specs = (P(env.batch_if(B), "model"), cspecs)
    return CellProgram(name=f"{cfg.name}:{cell.name}", kind="prefill",
                       fn=prefill_step, args=(params, batch),
                       in_specs=in_specs, out_specs=out_specs)


def build_decode(cfg: ModelConfig, env: MeshEnv, cell: ShapeCell, *,
                 kv_quant: bool = False) -> CellProgram:
    params, pspecs = abstract_params(cfg, env)
    B = cell.global_batch
    cross_len = DECODE_SRC_LEN if cfg.enc_dec else 0
    caches, cspecs = abstract_caches(cfg, env, B, cell.seq_len, cross_len,
                                     kv_quant)
    io = input_specs(cfg, cell)
    specs = cspecs if env.is_spmd else None

    def serve_step(params, token, pos, caches):
        return tfm.decode_step(cfg, params, token, pos, caches, env=env,
                               specs=specs)

    in_specs = out_specs = None
    if env.is_spmd:
        b_ax = env.batch_if(B)
        in_specs = (pspecs, P(b_ax, None), P(), cspecs)
        out_specs = (P(b_ax, "model"), P(b_ax), cspecs)
    return CellProgram(name=f"{cfg.name}:{cell.name}", kind="decode",
                       fn=serve_step,
                       args=(params, io["token"], io["pos"], caches),
                       in_specs=in_specs, out_specs=out_specs,
                       donate_argnums=(3,))


def build_cell(cfg: ModelConfig, env: MeshEnv, cell: ShapeCell,
               tcfg: TrainConfig = TrainConfig()) -> CellProgram:
    """The cell's program; ``ValueError`` for a cell the architecture
    does not support (long_500k on full attention)."""
    if not supports_cell(cfg, cell):
        raise ValueError(
            f"{cfg.name} does not support {cell.name} "
            "(full-attention arch on a 500k-context cell)")
    if cell.kind == "train":
        return build_train(cfg, env, cell, tcfg)
    if cell.kind == "prefill":
        return build_prefill(cfg, env, cell,
                             triangular=tcfg.triangular_attention)
    return build_decode(cfg, env, cell, kv_quant=tcfg.kv_quant_serving)


__all__ = ["CellProgram", "DECODE_SRC_LEN", "abstract_caches",
           "abstract_opt_state", "abstract_params", "build_cell",
           "build_decode", "build_prefill", "build_train", "input_specs",
           "text_len"]
