"""End-to-end training launcher: data -> train_step -> checkpoint,
restartable.

The port of the JAX package's ``repro/launch/train.py`` on one card:

* checkpoint every ``--ckpt-every`` steps (atomic commit, retention 3);
* ``--resume`` restores the newest complete checkpoint (params, AdamW
  moments and step, data cursor, generator state) and continues;
* data is a pure function of (seed, step): restart-safe by construction;
* a preemption is simulated by ``--stop-after N`` (exit 0 after N steps
  of this run).

It prints the reference's lines (``step … loss … gnorm …``,
``[resume]``, ``[preempt]``, ``done: …``).  Every family trains (dense,
MoE, RWKV-6, RecurrentGemma, encoder-decoder).  ``--device`` defaults to the
card; ``--device cpu`` takes the plain PyTorch path.

``--mesh host`` under ``torch.distributed.run`` trains on a data mesh
over every rank of the world (``launch.mesh.make_host_mesh``; the dense
family only), each rank on its rows of the global batch, AdamW's
moments sharded ZeRO-1; the mesh's first rank prints, and checkpoints
hold logical tensors, so a run resumes on another world size or on one
process.  With one process it is the single-process path.

    python -m repro_torch.launch.train --arch starcoder2-3b --size smoke \\
        --steps 20 --ckpt-dir /tmp/ckpt --resume
    python -m torch.distributed.run --nproc-per-node 2 \\
        -m repro_torch.launch.train --mesh host --size 100m --steps 4
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import time

import torch
import torch.distributed as dist

from repro_torch._device import resolve_device
from repro_torch.configs import get_config, reduced
from repro_torch.interop import shard_lm_params
from repro_torch.launch.mesh import init_world, make_host_mesh
from repro_torch.models import transformer as tfm
from repro_torch.optim import adamw
from repro_torch.optim.schedules import cosine_with_warmup
from repro_torch.runtime import checkpoint as ckpt
from repro_torch.runtime.data import DataConfig, batch_at
from repro_torch.runtime.meshenv import make_env
from repro_torch.runtime.train import (TrainConfig, init_opt_state,
                                       make_train_step, opt_state_specs)


def build_reduced_100m(cfg):
    """~100M-param member of the arch's family (the reference's)."""
    d = 768
    return dataclasses.replace(
        reduced(cfg, layers=max(12, len(cfg.pattern)), d_model=d, heads=12,
                kv_heads=4, d_ff=2048, vocab=32_000),
        name=cfg.name + "-100m")


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default="qwen3-8b")
    ap.add_argument("--size", default="smoke",
                    choices=["smoke", "100m", "full"])
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--ckpt-every", type=int, default=10)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--stop-after", type=int, default=0,
                    help="simulate preemption after N steps (exit 0)")
    ap.add_argument("--mesh", default="none", choices=["none", "host"])
    ap.add_argument("--log-every", type=int, default=1)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu (the plain PyTorch path)")
    return ap.parse_args(argv)


def _rng_state(seed: int) -> torch.Tensor:
    return torch.Generator().manual_seed(seed).get_state()


def run(args: argparse.Namespace) -> dict:
    """Train as ``args`` say; returns {"start", "losses" ({step: loss} of
    the logged steps), "grad_norms", "preempted", "seconds", "first"
    (this rank is the one that prints)}."""
    full = get_config(args.arch)
    cfg = {"smoke": lambda: reduced(full),
           "100m": lambda: build_reduced_100m(full),
           "full": lambda: full}[args.size]()
    own_world = False
    if args.mesh == "host" and not dist.is_initialized() and int(
            os.environ.get("WORLD_SIZE", 1)) > 1:
        device, _ = init_world(args.device)
        own_world = True
    else:
        device = resolve_device(args.device)
    env = make_env(make_host_mesh() if args.mesh == "host" else None)
    tfm.check_supported(cfg, env)
    say = print if env.is_first else (lambda *a, **k: None)

    gen = torch.Generator(device=device).manual_seed(0)
    params = tfm.init_lm(cfg, gen, device, env)
    specs = None
    if env.is_spmd:
        params = shard_lm_params(cfg, params, env)
        pspecs = tfm.param_specs(cfg, env)
        specs = {"params": pspecs,
                 "opt_state": opt_state_specs(pspecs, params, env)}
    tcfg = TrainConfig(adamw=adamw.AdamWConfig(lr=args.lr))
    opt_state = init_opt_state(cfg, params, env)
    sched = cosine_with_warmup(warmup=max(2, args.steps // 10),
                               total=max(args.steps, 10))
    train_step = make_train_step(cfg, tcfg, lr_schedule=sched, env=env)
    dcfg = DataConfig(seed=0, seq_len=args.seq, global_batch=args.batch)

    start = 0
    if args.resume and args.ckpt_dir:
        example = ckpt.TrainState(step=0, params=params,
                                  opt_state=opt_state, data_cursor=0,
                                  rng=_rng_state(0))
        restored = ckpt.restore(args.ckpt_dir, example, env=env,
                                specs=specs)
        if restored is not None:
            params = restored.params
            opt_state = restored.opt_state
            start = restored.data_cursor
            say(f"[resume] restored step {restored.step}, "
                f"data cursor {start}", flush=True)

    out = {"start": start, "losses": {}, "grad_norms": {},
           "preempted": False}
    t0 = time.time()
    for step in range(start, args.steps):
        batch = batch_at(cfg, dcfg, step, device)
        params, opt_state, metrics = train_step(params, opt_state, batch)
        if step % args.log_every == 0:
            loss = float(metrics["loss"])
            gnorm = float(metrics["grad_norm"])
            out["losses"][step], out["grad_norms"][step] = loss, gnorm
            say(f"step {step:5d} loss {loss:.4f} gnorm {gnorm:.3f} "
                f"({time.time() - t0:.1f}s)", flush=True)
        if args.ckpt_dir and (step + 1) % args.ckpt_every == 0:
            ckpt.save(args.ckpt_dir, ckpt.TrainState(
                step=step + 1, params=params, opt_state=opt_state,
                data_cursor=step + 1, rng=_rng_state(step + 1)),
                env=env, specs=specs)
        if args.stop_after and step + 1 - start >= args.stop_after:
            say(f"[preempt] stopping after {args.stop_after} steps",
                flush=True)
            out["preempted"] = True
            break
    out["seconds"] = time.time() - t0
    out["first"] = env.is_first
    if own_world:
        dist.destroy_process_group()
    return out


def main(argv=None) -> int:
    args = parse_args(argv)
    out = run(args)
    if out["preempted"] or not out["first"]:
        return 0
    losses = list(out["losses"].values())
    if len(losses) >= 2 and losses[-1] > losses[0]:
        print(f"WARNING: loss did not improve ({losses[0]:.3f} -> "
              f"{losses[-1]:.3f})")
    print(f"done: {args.steps - out['start']} steps in "
          f"{out['seconds']:.1f}s; final loss "
          f"{losses[-1] if losses else float('nan'):.4f}", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
