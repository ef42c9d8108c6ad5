"""Mesh construction over an initialised ``torch.distributed`` world.

The port of the JAX package's ``repro/launch/mesh.py``.  A mesh is a
``torch.distributed.device_mesh.DeviceMesh`` whose dims are named (the
reference's ``("data", "model")`` or ``("pod", "data", "model")``);
``runtime.meshenv.make_env`` turns it into a ``MeshEnv``.

The process-group backend is chosen once, by :func:`init_world`, from
the cards the ranks hold: each rank puts its card's UUID in the
rendezvous store, and the world takes ``nccl`` when no two ranks hold
the same card, ``gloo`` when some share one (NCCL refuses two ranks on
one device) or a rank has none.  The port's collectives are
``all_reduce`` and ``all_gather``, which gloo runs on CUDA tensors.

:func:`make_production_mesh` gives the reference's production layouts
(256 and 512 ranks) as the ``{axis: size}`` dict ``make_env`` takes:
no world of that size exists, so the dry run (``launch/dryrun.py``)
runs one rank's program on ``meta`` under a recording env of the
layout.
"""
from __future__ import annotations

import datetime
import math
import os
from typing import Optional, Tuple

import torch
import torch.distributed as dist

#: NVIDIA H100 SXM (data sheet, dense, 700 W): bf16 tensor-core FLOP/s,
#: HBM3 bytes/s, and NVLink 4's bytes/s in one direction (900 GB/s both
#: ways), in place of the reference's TPU v5e figures
PEAK_BF16_FLOPS = 989e12
HBM_BW = 3.35e12
NVLINK_BW = 450e9


def choose_backend(cards) -> str:
    """``nccl`` when every rank holds a card (``cards``: one id per rank,
    None for a rank on the CPU) and no two hold the same one, else
    ``gloo``."""
    if all(c is not None for c in cards) and len(set(cards)) == len(cards):
        return "nccl"
    return "gloo"


def init_world(device=None, *, timeout_s: float = 600.0,
               store=None, rank: Optional[int] = None,
               world_size: Optional[int] = None) -> Tuple[torch.device, str]:
    """Initialise the default process group and pick this rank's device.

    ``device`` ``None`` means ``cuda``, as every entry point of the port;
    ``cuda`` with no index means card ``LOCAL_RANK`` modulo the cards
    this process sees (so ranks that each see one card take it, and
    ranks on a host with fewer cards than ranks share them).  Rank and
    world size come from the arguments, else from the environment
    ``torch.distributed.run`` sets (``RANK``, ``WORLD_SIZE``,
    ``LOCAL_RANK``, ``MASTER_ADDR``/``PORT``); ``store`` (e.g. a
    ``FileStore``) replaces the environment's rendezvous.  The device is
    made current before any mesh is built, so that ``DeviceMesh`` does
    not pick one itself; the backend follows from every rank's card
    (:func:`choose_backend`).  Returns (device, backend)."""
    dev = torch.device("cuda" if device is None else device)
    rank = int(os.environ.get("RANK", 0)) if rank is None else rank
    world_size = (int(os.environ.get("WORLD_SIZE", 1))
                  if world_size is None else world_size)
    card = None
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("device 'cuda' requested but "
                               "torch.cuda.is_available() is False")
        if dev.index is None:
            local_rank = int(os.environ.get("LOCAL_RANK", rank))
            dev = torch.device("cuda",
                               local_rank % torch.cuda.device_count())
        torch.cuda.set_device(dev)
        torch.zeros(1, device=dev)           # the context exists now
        card = str(torch.cuda.get_device_properties(dev).uuid)
    timeout = datetime.timedelta(seconds=timeout_s)
    if store is None:
        store, rank, world_size = next(dist.rendezvous(
            "env://", rank=rank, world_size=world_size, timeout=timeout))
        store.set_timeout(timeout)
    cards = dist.PrefixStore("repro_torch/card", store)
    cards.set(str(rank), card or "")
    backend = choose_backend([cards.get(str(r)).decode() or None
                              for r in range(world_size)])
    dist.init_process_group(backend=backend, store=store, rank=rank,
                            world_size=world_size, timeout=timeout)
    return dev, backend


def _device_type() -> str:
    """``cuda`` once :func:`init_world` has made a card current."""
    return ("cuda" if torch.cuda.is_available()
            and torch.cuda.is_initialized() else "cpu")


def make_mesh(shape: Tuple[int, ...], axes: Tuple[str, ...]):
    """A mesh over the first ``prod(shape)`` ranks of the world, rank
    order row-major over ``axes`` (the reference's ``jax.make_mesh``
    order).  Every rank of the world calls it; a rank past the mesh
    gets no coordinate."""
    from torch.distributed.device_mesh import DeviceMesh
    n = math.prod(shape)
    if n > dist.get_world_size():
        raise ValueError(f"mesh {shape} needs {n} ranks, the world has "
                         f"{dist.get_world_size()}")
    return DeviceMesh(_device_type(), torch.arange(n).reshape(shape),
                      mesh_dim_names=tuple(axes))


def make_production_mesh(*, multi_pod: bool = False) -> dict:
    """The reference's production layout: ``{"data": 16, "model": 16}``
    (256 ranks) or ``{"pod": 2, "data": 16, "model": 16}`` (512), the
    layout ``runtime.meshenv.make_env`` takes."""
    if multi_pod:
        return {"pod": 2, "data": 16, "model": 16}
    return {"data": 16, "model": 16}


def make_host_mesh(max_model: int = 1):
    """A ``("data", "model")`` mesh over every rank of the initialised
    world, the model axis the largest divisor of the world size up to
    ``max_model``; None when the world is one rank (or none is
    initialised): the single-process path."""
    if not dist.is_initialized() or dist.get_world_size() <= 1:
        return None
    n = dist.get_world_size()
    model = 1
    for cand in range(min(max_model, n), 0, -1):
        if n % cand == 0:
            model = cand
            break
    return make_mesh((n // model, model), ("data", "model"))


__all__ = ["HBM_BW", "NVLINK_BW", "PEAK_BF16_FLOPS", "choose_backend",
           "init_world", "make_host_mesh", "make_mesh",
           "make_production_mesh"]
