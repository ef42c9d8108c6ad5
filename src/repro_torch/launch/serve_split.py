"""Split LLM serving: the paper's technique on a transformer.

The counterpart of the JAX package's ``examples/serve_split.py``: the
Li-GD planner picks the split point ``s`` from the transformer's own
layer profile (the fused sweep: the CUDA kernel on the card), the device
half computes blocks [0, s), ships the w_s activation, and the edge half
finishes [s, M) and the head.  Greedy split generation is checked to be
identical to the unsplit model.

    python -m repro_torch.launch.serve_split                 # the card
    python -m repro_torch.launch.serve_split --device cpu    # reduced

The model is starcoder2-3b at batch 1, weights random from ``SEED``, and
the user's device computes at ``C_DEV`` (5e9), as in the reference
example.
On the card the model is the architecture as ``get_config`` gives it
(``--layers`` cuts depth only).  ``--device cpu`` takes the plain
PyTorch path, and only at the reduced size (``configs.reduced``).  Exits
non-zero when split != unsplit.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time

import torch

from repro_torch._device import resolve_device
from repro_torch.configs import get_config, reduced
from repro_torch.configs.base import ModelConfig
from repro_torch.core.costs import (DeviceParams, EdgeParams,
                                    device_columns, edge_dict,
                                    rows_to_device)
from repro_torch.core.ligd import LiGDConfig, solve_ligd_batch
from repro_torch.core.profile import profile_transformer
from repro_torch.models import transformer as tfm
from repro_torch.serving.split import SplitServer, activation_bits

#: the reference example's model and user device compute (FLOP/s); the
#: weights are random from SEED and the prompts from SEED + 1
ARCH = "starcoder2-3b"
C_DEV = 5e9
SEED = 0


def plan_split(cfg: ModelConfig, *, seq: int, batch: int, c_dev: float,
               device) -> dict:
    """Li-GD on ``cfg``'s prefill profile for one user of compute
    ``c_dev`` against the default edge server: the split and its (B, r)."""
    profile = profile_transformer(cfg, seq=seq, batch=batch, mode="prefill")
    devs = rows_to_device(device_columns([DeviceParams(c_dev=c_dev)]),
                          device, 1)
    res = solve_ligd_batch(profile, devs, edge_dict(EdgeParams(), device),
                           LiGDConfig(max_iters=200))
    return {"split": int(res.split[0]), "B_hz": float(res.B[0]),
            "r": float(res.r[0]), "U": float(res.U[0])}


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def unsplit_generate(cfg: ModelConfig, params: dict, tokens: torch.Tensor,
                     max_new: int, cache_len: int = 0):
    """Greedy generation through ``prefill`` + ``decode_step``: (tokens
    (B, max_new), prefill ms, decode ms per step)."""
    B, S = tokens.shape
    dev = tokens.device
    t0 = time.perf_counter()
    logits, caches = tfm.prefill(cfg, params, {"tokens": tokens},
                                 cache_len=max(cache_len, S + max_new))
    cur = torch.argmax(logits[:, :cfg.vocab_size], dim=-1)
    _sync(dev)
    t1 = time.perf_counter()
    out = [cur]
    for i in range(max_new - 1):
        _, cur, caches = tfm.decode_step(cfg, params, cur[:, None], S + i,
                                         caches)
        out.append(cur)
    _sync(dev)
    t2 = time.perf_counter()
    per_step = (t2 - t1) / max(max_new - 1, 1) * 1e3
    return torch.stack(out, dim=1), (t1 - t0) * 1e3, per_step


def make_inputs(cfg: ModelConfig, *, device, batch: int, prompt_len: int):
    """Random weights and prompt tokens from ``SEED``, on ``device``."""
    device = resolve_device(device)
    params = tfm.init_lm(cfg, torch.Generator(device).manual_seed(SEED),
                         device)
    tokens = torch.randint(0, cfg.vocab_size, (batch, prompt_len),
                           generator=torch.Generator(device)
                           .manual_seed(SEED + 1), device=device)
    return params, tokens


def run(cfg: ModelConfig, params: dict, tokens: torch.Tensor, *,
        new_tokens: int) -> dict:
    """Plan the split for ``tokens``' shape, generate split and unsplit
    on ``tokens``' device, and compare."""
    device = tokens.device
    batch, prompt_len = tokens.shape
    plan = plan_split(cfg, seq=prompt_len, batch=batch, c_dev=C_DEV,
                      device=device)
    server = SplitServer(cfg, params, device=device)
    t0 = time.perf_counter()
    split_out = server.generate(tokens, plan["split"], max_new=new_tokens)
    _sync(device)
    split_s = time.perf_counter() - t0
    ref, prefill_ms, decode_ms = unsplit_generate(cfg, params, tokens,
                                                  new_tokens)
    return {"model": cfg.name, "layers": cfg.num_layers, "device":
            str(device), "batch": batch, "prompt_len": prompt_len,
            "new_tokens": new_tokens, **plan,
            "w_s_decode_kB": activation_bits(cfg, batch, 1) / 8e3,
            "match": bool(torch.equal(split_out, ref)),
            "split_tokens": split_out.cpu().tolist(),
            "unsplit_tokens": ref.cpu().tolist(),
            "split_generate_s": split_s, "prefill_ms": prefill_ms,
            "decode_ms_per_step": decode_ms}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu (reduced size)")
    ap.add_argument("--layers", type=int, default=None,
                    help="cut depth to this many blocks")
    ap.add_argument("--prompt-len", type=int, default=None,
                    help="default 1024 on the card, 16 on the CPU")
    ap.add_argument("--new-tokens", type=int, default=None,
                    help="default 32 on the card, 12 on the CPU")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    cfg = get_config(ARCH)
    cpu = device.type == "cpu"
    if cpu:
        cfg = reduced(cfg, layers=args.layers or 6)
    elif args.layers:
        cfg = dataclasses.replace(cfg, num_layers=args.layers)
    params, tokens = make_inputs(
        cfg, device=device, batch=1,
        prompt_len=args.prompt_len or (16 if cpu else 1024))
    res = run(cfg, params, tokens,
              new_tokens=args.new_tokens or (12 if cpu else 32))
    print(f"Li-GD split for {res['model']}: s={res['split']} of "
          f"{res['layers']} blocks (B={res['B_hz'] / 1e6:.1f} MHz, "
          f"r={res['r']:.1f})")
    print(json.dumps(res))
    if not res["match"]:
        print("split != unsplit", file=sys.stderr)
        return 1
    print("MATCH: split serving is exact.")
    return 0


if __name__ == "__main__":
    sys.exit(main())
