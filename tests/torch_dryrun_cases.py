"""Helpers of ``tests/test_torch_dryrun.py``: small cell programs, their
arguments drawn on the CPU, and a gloo rank that records the
collectives ``torch.distributed`` emits while it runs them.

This module imports nothing of JAX or of the JAX package, so a spawned
rank loads only the port.
"""
from __future__ import annotations

import torch

from repro_torch._tree import tree_map

#: a small cell of each kind
SEQ, BATCH = 32, 4


def cell_of(kind: str):
    from repro_torch.configs.base import ShapeCell
    return ShapeCell(f"small_{kind}", SEQ, BATCH, kind)


def small_cfg(arch: str, layers: int = 2):
    from repro_torch.configs import get_config, reduced
    return reduced(get_config(arch), layers=layers)


def draw(tree, cfg, seed: int = 0):
    """CPU tensors of each ``meta`` leaf's shape and dtype: floats normal
    x 0.02, integers (tokens, labels, the decode position) in [0, 3)."""
    g = torch.Generator().manual_seed(seed)

    def one(x):
        if not torch.is_tensor(x):
            return x
        if x.dtype.is_floating_point:
            return (torch.randn(x.shape, generator=g) * 0.02).to(x.dtype)
        return torch.randint(0, 3, x.shape, generator=g, dtype=x.dtype)

    return tree_map(one, tree)


def program(arch: str, kind: str, env, layers: int = 2):
    """(the cell program of a small ``arch`` config on ``env``, the
    arguments its ``fn`` takes on this rank, on ``meta``)."""
    from repro_torch.launch.dryrun import rank_args
    from repro_torch.launch.steps import build_cell
    cfg = small_cfg(arch, layers)
    prog = build_cell(cfg, env, cell_of(kind))
    return cfg, prog, rank_args(prog, env)[0]


def record_rank(rank: int, cases) -> list:
    """Each case's (arch, kind, mesh shape) train or serve program on a
    real mesh, its arguments drawn on the CPU; the collectives it emits
    as (kind, bytes, group size), ``torch.distributed``'s all_reduce and
    all_gather wrapped to record them; with this rank's coordinate."""
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.runtime.meshenv import make_env
    record = []
    real = {"all_reduce": dist.all_reduce, "all_gather": dist.all_gather}

    def all_reduce(t, *a, group=None, **kw):
        record.append(("all-reduce", t.numel() * t.element_size(),
                       dist.get_world_size(group)))
        return real["all_reduce"](t, *a, group=group, **kw)

    def all_gather(parts, t, *a, group=None, **kw):
        record.append(("all-gather", sum(p.numel() * p.element_size()
                                         for p in parts),
                       dist.get_world_size(group)))
        return real["all_gather"](parts, t, *a, group=group, **kw)

    out = []
    dist.all_reduce, dist.all_gather = all_reduce, all_gather
    try:
        for arch, kind, shape in cases:
            env = make_env(make_mesh(shape, ("data", "model")))
            cfg, prog, args = program(arch, kind, env)
            del record[:]
            prog.fn(*draw(args, cfg))
            out.append({"coordinate": env.coordinate,
                        "record": list(record)})
    finally:
        dist.all_reduce, dist.all_gather = real["all_reduce"], \
            real["all_gather"]
    return out


__all__ = ["BATCH", "SEQ", "cell_of", "draw", "program", "record_rank",
           "small_cfg"]
