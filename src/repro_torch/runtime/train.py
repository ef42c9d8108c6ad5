"""The train step: loss, backward, AdamW, on one process or on a mesh.

The port of the JAX package's ``repro/runtime/train.py``.
``make_train_step`` returns ``train_step(params, opt_state, batch) ->
(params, opt_state, metrics)`` with ``metrics`` holding ``loss``,
``aux``, ``total`` and ``grad_norm`` (() tensors on the device), as the
reference's does.  Gradients come from ``torch.autograd.grad`` through
:func:`repro_torch.models.transformer.loss_fn` (on the card: the
attention and RMSNorm backward kernels, ``remat`` recomputing each
block), and :func:`repro_torch.optim.adamw.update` applies them in
place, so the returned trees are the ones passed in.

On a mesh (``env``, every family), the reference's sharding strategy,
with the collectives GSPMD and ``shard_map`` would insert made
explicit:

* parameters: each rank holds its slice under the model's spec tree
  (``transformer.param_specs``), replicated over the batch axes;
* batch: ``train_step`` takes the global batch and each rank keeps its
  contiguous rows over the batch axes;
* gradients: averaged over the batch axes by an all-reduce, in their
  own dtype with ``bf16_collectives`` and in float32 without it;
* ``grad_norm`` (and the clip): every sharded leaf's squares summed over
  the model axis, every replicated leaf counted once;
* AdamW ``m``/``v`` (ZeRO-1, always on a data mesh, as in the
  reference, whose ``zero1`` field is read nowhere): the param's spec
  plus its largest divisible unsharded dim over the batch axes
  (:func:`zero1_spec`); each batch rank updates its slice of the moments
  and of the parameters, and the parameters are then gathered, one
  all-gather a sliced leaf.

The metrics are the mean over the batch axes of each rank's: the loss
of its rows, and the MoE's ``aux``, which is global on a data mesh
(every rank holds the same value) and the data shard's with tp > 1, as
the reference's.  The reference's three mesh-only fields are read by
the cell programs (``launch/steps.py``): ``triangular_attention`` by
prefill (accepted; the attention kernel always skips the masked-out kv
blocks, so it changes no number), ``kv_quant_serving`` by decode (int8
caches), and ``context_parallel_attention``, which the dry run reads
into its env (``MeshEnv.context_parallel_attn``: attention over the
sequence, ``models/transformer.py``), as the reference's does.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, List, Optional, Tuple

import torch

from repro_torch._tree import leaves, tree_map, unflatten
from repro_torch.configs.base import ModelConfig
from repro_torch.models import transformer as tfm
from repro_torch.optim import adamw
from repro_torch.optim.adamw import AdamWConfig, AdamWState
from .meshenv import CPU_ENV, MeshEnv, P, _names


def zero1_spec(spec: P, shape: Tuple[int, ...], env: MeshEnv) -> P:
    """ZeRO-1: extend a param spec by sharding one unsharded dim over the
    batch axes (the largest dim that the DP size divides)."""
    if not env.is_spmd or env.dp <= 1:
        return spec
    entries = list(spec) + [None] * (len(shape) - len(spec))
    axes = tuple(env.batch_axes)
    best, best_size = None, 0
    for i, (e, n) in enumerate(zip(entries, shape)):
        if e is None and n % env.dp == 0 and n > best_size:
            best, best_size = i, n
    if best is None:
        return spec
    entries[best] = axes if len(axes) > 1 else axes[0]
    return P(*entries)


def opt_state_specs(param_specs, params, env: MeshEnv) -> AdamWState:
    """Spec tree of the AdamW state; ``params`` mirrors ``param_specs``
    with tensors, arrays or shape tuples at its leaves."""
    mv = tree_map(lambda sp, p: zero1_spec(
        sp, tuple(getattr(p, "shape", p)), env), param_specs, params)
    return AdamWState(step=P(), m=mv, v=mv)


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    adamw: AdamWConfig = AdamWConfig()
    remat: bool = True
    capacity_factor: float = 1.25
    triangular_attention: bool = False  # prefill: changes no number
    context_parallel_attention: bool = False   # the dry run's env flag
    kv_quant_serving: bool = False      # decode cells: int8 k/v caches
    bf16_collectives: bool = False      # gradients cross in their dtype
    zero1: bool = True                  # read nowhere, as the reference's


def _zero1_dims(pspecs, params, env: MeshEnv) -> list:
    """Per leaf, the dim that ZeRO-1 shards over the batch axes, or None
    (no divisible dim): where :func:`zero1_spec` extends its spec."""
    out = []
    for sp, p in zip(leaves(pspecs), leaves(params)):
        z = zero1_spec(sp, tuple(p.shape), env)
        full = list(sp) + [None] * (len(z) - len(sp))
        out.append(next((i for i, (a, b) in enumerate(zip(z, full))
                         if a != b), None))
    return out


def init_opt_state(cfg: ModelConfig, params,
                   env: MeshEnv = CPU_ENV) -> AdamWState:
    """Zero AdamW state for this rank's ``params``: ``adamw.init`` on one
    process; on a data mesh, the moments of each leaf's ZeRO-1 slice over
    the batch axes only (:func:`opt_state_specs`)."""
    if not env.is_spmd or env.dp <= 1:
        return adamw.init(params)
    dims = _zero1_dims(tfm.param_specs(cfg, env), params, env)

    def zeros(p, d):
        shape = list(p.shape)
        if d is not None:
            shape[d] //= env.dp
        return torch.zeros(shape, dtype=torch.float32, device=p.device)

    mv = [zeros(p, d) for p, d in zip(leaves(params), dims)]
    return AdamWState(step=torch.zeros((), dtype=torch.int32),
                      m=unflatten(params, mv),
                      v=unflatten(params, [torch.zeros_like(t) for t in mv]))


def local_batch(batch: dict, env: MeshEnv) -> dict:
    """This rank's contiguous rows of a global batch over the batch
    axes (the whole batch on one process)."""
    if env.dp <= 1:
        return batch
    return {k: env.local_slice(v, 0, env.batch()) for k, v in batch.items()}


def _global_mean(x: torch.Tensor, env: MeshEnv) -> torch.Tensor:
    """The mean over the batch axes of a per-rank () value."""
    x = x.detach()
    if env.dp <= 1:
        return x
    x = env.all_reduce_(x.clone(), env.batch())
    return x / env.dp


def loss_and_grads(cfg: ModelConfig, params, batch: dict, *,
                   tcfg: "TrainConfig" = TrainConfig(),
                   env: MeshEnv = CPU_ENV) -> tuple:
    """(total, metrics, grads): the loss of the global ``batch`` and the
    gradient of every leaf of ``params`` (in :func:`leaves` order).  On
    a mesh, each rank's loss is over its rows, the metrics are their
    mean over the batch axes, and each gradient is averaged over the
    batch axes (float32 unless ``tcfg.bf16_collectives``), so every
    rank holds the global gradient of its parameter slices."""
    flat = leaves(params)
    for p in flat:
        p.requires_grad_(True)
    total, metrics = tfm.loss_fn(cfg, params, local_batch(batch, env),
                                 remat=tcfg.remat,
                                 capacity_factor=tcfg.capacity_factor,
                                 env=env)
    grads = list(torch.autograd.grad(total, flat))
    if env.dp > 1:
        for i, g in enumerate(grads):
            buf = (g if tcfg.bf16_collectives else g.float()).contiguous()
            env.all_reduce_(buf, env.batch())
            grads[i] = buf.mul_(1.0 / env.dp)
    metrics = {k: _global_mean(v, env) for k, v in metrics.items()}
    return _global_mean(total, env), metrics, grads


def grad_norm(grads: List[torch.Tensor], pspecs, env: MeshEnv
              ) -> torch.Tensor:
    """The global gradient norm on a mesh: the squares of every leaf
    sharded over the model axis summed over it, every replicated leaf
    counted once."""
    sharded = torch.zeros((), dtype=torch.float32, device=grads[0].device)
    replicated = torch.zeros_like(sharded)
    for g, sp in zip(grads, leaves(pspecs)):
        sq = torch.sum(torch.square(g.float()))
        if any(env.model_axis in _names(e) for e in sp):
            sharded = sharded + sq
        else:
            replicated = replicated + sq
    if env.tp > 1:
        env.all_reduce_(sharded, env.model_axis)
    return torch.sqrt(sharded + replicated)


def make_train_step(cfg: ModelConfig, tcfg: TrainConfig = TrainConfig(),
                    lr_schedule: Optional[Callable] = None, *,
                    env: MeshEnv = CPU_ENV):
    """Returns train_step(params, opt_state, batch) -> (params, opt_state,
    metrics); the learning rate is ``tcfg.adamw.lr`` times
    ``lr_schedule(opt_state.step)`` (default 1).  On a mesh, ``params``
    are this rank's slices (``interop.shard_lm_params``), ``opt_state``
    its :func:`init_opt_state`, ``batch`` the global batch."""
    sched = lr_schedule or (lambda s: 1.0)
    tfm.check_supported(cfg, env)
    if not env.is_spmd:
        def train_step(params, opt_state: AdamWState, batch: dict):
            total, metrics, grads = loss_and_grads(cfg, params, batch,
                                                   tcfg=tcfg)
            params, opt_state, opt_metrics = adamw.update(
                tcfg.adamw, unflatten(params, grads), opt_state, params,
                lr_scale=sched(opt_state.step))
            return params, opt_state, dict(metrics, total=total,
                                           **opt_metrics)
        return train_step

    pspecs = tfm.param_specs(cfg, env)
    batch_axes = env.batch()

    def mesh_step(params, opt_state: AdamWState, batch: dict):
        total, metrics, grads = loss_and_grads(cfg, params, batch,
                                               tcfg=tcfg, env=env)
        gnorm = grad_norm(grads, pspecs, env)
        flat = leaves(params)
        dims = _zero1_dims(pspecs, params, env)
        with torch.no_grad():
            g_own = [g if d is None else env.local_slice(g, d, batch_axes)
                     for g, d in zip(grads, dims)]
            p_own = [p if d is None else env.local_slice(p, d, batch_axes)
                     for p, d in zip(flat, dims)]
            _, opt_state, _ = adamw.update(
                tcfg.adamw, g_own, AdamWState(
                    step=opt_state.step, m=leaves(opt_state.m),
                    v=leaves(opt_state.v)), p_own,
                lr_scale=sched(opt_state.step), grad_norm=gnorm)
            for p, d in zip(flat, dims):
                if d is not None:
                    env.gather_into_(p.detach(), d, batch_axes)
        opt_state = AdamWState(step=opt_state.step,
                               m=unflatten(params, opt_state.m),
                               v=unflatten(params, opt_state.v))
        return params, opt_state, dict(metrics, total=total,
                                       grad_norm=gnorm)

    return mesh_step


__all__ = ["TrainConfig", "grad_norm", "init_opt_state", "local_batch",
           "loss_and_grads", "make_train_step", "opt_state_specs",
           "zero1_spec"]
