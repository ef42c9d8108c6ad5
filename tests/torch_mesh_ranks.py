"""Multi-rank worlds on the CPU for the ``test_torch_mesh*`` files.

``run_world(fn, world, tmp_path, *args)`` spawns ``world`` processes
(the ``spawn`` start method: the test process has threads), each a
``gloo`` rank with ``FileStore`` rendezvous in ``tmp_path`` (no port to
collide with another xdist worker), one intra-op thread and a timeout on
every collective; rank r runs ``fn(r, *args)`` and its return value
(anything ``torch.save`` takes) comes back in rank order.  A rank that
raises, hangs past the timeout or dies fails the world.

This module imports nothing of JAX or of the JAX package, so a spawned
rank loads only the port.
"""
from __future__ import annotations

import os
import traceback

import torch

#: every collective of a world, and the whole world, end within these
COLLECTIVE_TIMEOUT_S = 60.0
WORLD_TIMEOUT_S = 150.0


def _entry(fn, rank: int, world: int, tmp: str, args: tuple) -> None:
    import torch.distributed as dist
    from repro_torch.launch.mesh import init_world
    torch.set_num_threads(1)
    store = dist.FileStore(os.path.join(tmp, "store"), world)
    init_world("cpu", store=store, rank=rank, world_size=world,
               timeout_s=COLLECTIVE_TIMEOUT_S)
    try:
        out = fn(rank, *args)
        torch.save(out, os.path.join(tmp, f"rank{rank}.pt"))
    except BaseException:
        with open(os.path.join(tmp, f"rank{rank}.err"), "w") as f:
            f.write(traceback.format_exc())
        raise
    finally:
        dist.destroy_process_group()


def run_world(fn, world: int, tmp_path, *args) -> list:
    """``fn(rank, *args)`` on every rank of a ``world``-rank gloo world;
    returns the ranks' results in rank order."""
    import torch.multiprocessing as mp
    tmp = str(tmp_path)
    os.makedirs(tmp, exist_ok=True)
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_entry, args=(fn, r, world, tmp, args))
             for r in range(world)]
    for p in procs:
        p.start()
    for p in procs:
        p.join(WORLD_TIMEOUT_S)
    alive = [r for r, p in enumerate(procs) if p.is_alive()]
    for p in procs:
        if p.is_alive():
            p.kill()
            p.join()
    errs = []
    for r in range(world):
        path = os.path.join(tmp, f"rank{r}.err")
        if os.path.exists(path):
            with open(path) as f:
                errs.append(f"rank {r}:\n{f.read()}")
    assert not alive and not errs and all(
        p.exitcode == 0 for p in procs), (
        f"ranks alive past {WORLD_TIMEOUT_S} s: {alive}; exit codes "
        f"{[p.exitcode for p in procs]}\n" + "\n".join(errs))
    return [torch.load(os.path.join(tmp, f"rank{r}.pt"), weights_only=False)
            for r in range(world)]


def ops_rank(rank: int, x: dict) -> dict:
    """``tests/test_torch_mesh.py``'s world: the vocab-sharded ops at
    model 2 and 4, ``compressed_pod_mean`` at pod 2 and ``shrink_mesh``,
    on inputs ``x`` (that file's ``_inputs``)."""
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import sharded_ops as t_ops
    from repro_torch.runtime.compression import compressed_pod_mean
    from repro_torch.runtime.elastic import shrink_mesh
    from repro_torch.runtime.meshenv import P, make_env
    V = 300
    out = {}
    for tp in (2, 4):
        env = make_env(make_mesh((4 // tp, tp), ("data", "model")))
        rec = {}
        for tied in (True, False):
            full = torch.from_numpy(x["tied" if tied else "untied"])
            spec = P("model", None) if tied else P(None, "model")
            table = env.shard(full, spec).clone().requires_grad_(True)
            h = torch.from_numpy(x["h"]).requires_grad_(True)
            ids = torch.from_numpy(x["ids"])
            loss = t_ops.fused_unembed_xent(h, table, ids,
                                            transpose_table=tied,
                                            valid_vocab=V, env=env)
            dh, dt = torch.autograd.grad(loss.sum(), (h, table))
            logits = t_ops.unembed_logits(h.detach(), table.detach(),
                                          transpose_table=tied,
                                          valid_vocab=V, env=env)
            rec[tied] = {"loss": loss.detach(), "dh": dh,
                         "dtable": env.unshard(dt, spec),
                         "argmax": t_ops.sharded_argmax(logits, env=env)}
        table = env.shard(torch.from_numpy(x["tied"]), P("model", None))
        rec["embed"] = t_ops.embed_lookup(table, torch.from_numpy(x["ids"]),
                                          env=env)
        tie = env.shard(torch.from_numpy(x["tie_logits"]),
                        P(None, None, "model"))
        rec["tie"] = t_ops.sharded_argmax(tie, env=env)
        out[tp] = rec

    pod_env = make_env(make_mesh((2, 2), ("pod", "data")))
    grads = {"a": torch.from_numpy(x["grads"][rank]),
             "b": torch.from_numpy(x["grads"][4 + rank][:, :1])}
    errors = {k: torch.zeros(v.shape) for k, v in grads.items()}
    mean1, err1 = compressed_pod_mean(pod_env, grads, errors)
    grads2 = {k: v * 0.5 + 1.0 for k, v in grads.items()}
    mean2, err2 = compressed_pod_mean(pod_env, grads2, err1)
    out["pod"] = {"mean1": mean1, "err1": err1, "mean2": mean2,
                  "err2": err2}

    for names in (("data", "model"), ("model", "data")):
        shape = (2, 2)
        small = shrink_mesh(make_mesh(shape, names), drop_data_rows=1)
        senv = make_env(small)
        out[names] = {"shape": senv.shape, "member": senv.member,
                      "mesh": small.mesh.tolist()}
    try:
        shrink_mesh(make_mesh((2, 2), ("data", "model")), drop_data_rows=2)
    except ValueError as e:
        out["drop_all"] = str(e)
    try:
        shrink_mesh(make_mesh((4,), ("model",)))
    except ValueError as e:
        out["no_data"] = str(e)
    return out
