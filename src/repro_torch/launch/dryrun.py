"""Dry run of every (architecture x cell x production mesh) program.

The port of the JAX package's ``repro/launch/dryrun.py``.  The
reference lowers and compiles each cell's step against 256 or 512
forced host devices and reads XLA's analyses.  No world of 256 ranks
exists here, and the port has no compiler to ask, so the port runs one
rank's program instead:

* ``steps.build_cell`` builds the cell on the production layout
  (``launch.mesh.make_production_mesh``: data 16 x model 16, or pod 2 x
  data 16 x model 16) under a :class:`~repro_torch.runtime.meshenv.
  RecordingEnv` at the coordinate (0, ..., 0);
* the rank's shards of the state (parameters, optimizer state, caches)
  are cut by ``shard_tree`` on ``meta``, where nothing is allocated;
* ``fn`` runs on ``meta`` under ``launch.costs.count``: the kernel ops
  take their ``meta`` routes (no plain version runs; rows 6 and 7's
  loop over time in Python) and report the CUDA routes' work, the env
  records every collective (``launch.collective_stats``).

The port loops over blocks in Python, so the count covers every block
as it runs: the reference's ``probe_costs`` (unrolled probes at 1 and 2
superblocks, extrapolated, because XLA counts a loop body once) has no
counterpart, and ``--unroll`` and ``--no-probe`` neither.  The count is
affine in depth (``tests/test_torch_dryrun.py``), which is what the
reference's extrapolation assumes.

The record keeps the reference's keys where they mean the same thing
(``arch``, ``cell``, ``mesh``, ``status``, ``reason``, ``kind``,
``chips``, ``collectives``, ``roofline``, ``roofline_step_s``, ``mfu``);
``build_s`` and ``trace_s`` (building the program, running it on
``meta``) replace ``lower_s`` and ``compile_s``.  Where a key's meaning
differs from XLA's:

* ``cost_analysis``: ``flops`` and ``bytes accessed`` of the rank:
  ``FlopCounterMode``'s products plus the kernels' own work (XLA also
  counts elementwise ops as flops; the port counts remat's second
  forward, which XLA may fuse or drop), and the bytes every eager aten
  op reads and writes plus the kernels' (XLA's are those of its fused
  program);
* ``memory_analysis``: ``argument_size_in_bytes`` is the rank's pieces
  of the parameters, optimizer state, caches and batch (by their input
  specs; ``fn`` receives the batch whole and keeps its rows),
  ``alias_size_in_bytes`` the donated ones (parameters and optimizer
  state in training, caches in decode), ``output_size_in_bytes`` the
  outputs' bytes (tensors updated in place count again, as XLA counts
  an aliased output), and ``temp_size_in_bytes`` the count's tracked
  peak of storage the run creates, outputs included (XLA's temp is its
  buffer assignment's scratch, outputs apart);
* ``collectives``: from the recorded emissions, not HLO text.

The record is rank (0, ..., 0)'s.  Ranks differ: a decode
write lands on the rank that owns slot ``pos mod L``, and long_500k's
batch of 1 is served as a replica on each data rank; the flops do not
differ between coordinates (the MoE capacity is static), the bytes and
the peak may by the write (``tests/test_torch_dryrun.py``).

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch all \\
      --cell all --mesh both --out experiments/dryrun_torch
"""
from __future__ import annotations

import argparse
import json
import math
import os
import sys
import time
import traceback
from typing import Tuple

import torch

from repro_torch._tree import leaves
from repro_torch.configs import (ALL_CELLS, ARCH_IDS, get_cell, get_config,
                                 supports_cell)
from repro_torch.launch import collective_stats, roofline
from repro_torch.launch.costs import count
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.launch.steps import build_cell
from repro_torch.runtime.meshenv import recording_env, shard_tree
from repro_torch.runtime.train import TrainConfig

#: which of a program's arguments are state, cut to the rank's shards
#: (the rest, the batch inputs, ``fn`` takes whole)
STATE_ARGS = {"train": (0, 1), "prefill": (0,), "decode": (0, 3)}

SKIP_REASON = ("full-attention arch on 500k decode cell "
               "(sub-quadratic required; DESIGN.md §Skips)")


def _bytes(tree) -> int:
    return sum(t.numel() * t.element_size() for t in leaves(tree)
               if torch.is_tensor(t))


def rank_args(prog, env) -> Tuple[list, list]:
    """(the arguments ``fn`` takes on this rank: its shards of the state,
    the batch inputs whole; every argument as the rank's piece under the
    input specs, which is what it holds)."""
    state = STATE_ARGS[prog.kind]
    if prog.in_specs is None:
        return list(prog.args), list(prog.args)
    pieces = [shard_tree(a, s, env) for a, s in zip(prog.args,
                                                    prog.in_specs)]
    return [pieces[i] if i in state else a
            for i, a in enumerate(prog.args)], pieces


def memory_analysis(prog, pieces, out, peak: int) -> dict:
    """The rank's bytes under the reference's ``memory_analysis`` keys
    (module docstring)."""
    return {"argument_size_in_bytes": _bytes(pieces),
            "output_size_in_bytes": _bytes(out),
            "temp_size_in_bytes": int(peak),
            "alias_size_in_bytes": _bytes([pieces[i]
                                           for i in prog.donate_argnums])}


def run_cell(arch: str, cell_name, multi_pod: bool, *,
             tcfg: TrainConfig = TrainConfig(), cfg=None) -> dict:
    """Build one cell on one production layout, run the rank's program
    on ``meta`` under the count and the recording env; the record.
    ``cell_name`` may be a ``ShapeCell``, and ``cfg`` replaces
    ``get_config(arch)`` (a cut config)."""
    cfg = get_config(arch) if cfg is None else cfg
    cell = (get_cell(cell_name) if isinstance(cell_name, str)
            else cell_name)
    cell_name = cell.name
    mesh_name = "multi" if multi_pod else "single"
    rec = {"arch": arch, "cell": cell_name, "mesh": mesh_name,
           "status": "ok"}
    if not supports_cell(cfg, cell):
        rec["status"] = "skipped"
        rec["reason"] = SKIP_REASON
        return rec
    layout = make_production_mesh(multi_pod=multi_pod)
    env = recording_env(layout, context_parallel_attn=(
        tcfg.context_parallel_attention))
    chips = math.prod(layout.values())

    t0 = time.perf_counter()
    prog = build_cell(cfg, env, cell, tcfg)
    args, pieces = rank_args(prog, env)
    build_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    with count() as c:
        out = prog.fn(*args)
    trace_s = time.perf_counter() - t0

    stats = collective_stats.collect_stats(env.record)
    cost = {"flops": float(c.flops), "bytes accessed": float(c.bytes)}
    kv_b = 1.25 if tcfg.kv_quant_serving else 2.0   # int8 + f32/row scales
    rl = roofline.derive(cfg, cell, cost, stats, chips, tp=env.tp,
                         dp=env.dp, kv_elem_bytes=kv_b)
    rec.update(
        kind=prog.kind, chips=chips, coordinate=list(env.coordinate),
        build_s=round(build_s, 3), trace_s=round(trace_s, 3),
        memory_analysis=memory_analysis(prog, pieces, out, c.peak),
        cost_analysis=cost,
        kernels=c.kernels,
        collectives={"bytes_by_kind": stats.bytes_by_kind,
                     "counts": stats.counts,
                     "total_bytes": stats.total_bytes,
                     "link_bytes": stats.link_bytes,
                     "summary": stats.summary()},
        roofline=rl.row(),
        roofline_step_s=rl.step_time_s,
        mfu=rl.mfu,
    )
    return rec


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="all",
                    help="comma-separated arch ids or 'all'")
    ap.add_argument("--cell", default="all",
                    help="comma-separated cell names or 'all'")
    ap.add_argument("--mesh", default="both",
                    choices=["single", "multi", "both"])
    ap.add_argument("--out", default="experiments/dryrun_torch")
    ap.add_argument("--skip-existing", action="store_true")
    ap.add_argument("--triangular", action="store_true",
                    help="the reference's §Perf flag; changes no number "
                         "here: the port's kernel always skips the "
                         "causal blocks")
    args = ap.parse_args(argv)

    archs = list(ARCH_IDS) if args.arch == "all" else args.arch.split(",")
    cells = ([c.name for c in ALL_CELLS] if args.cell == "all"
             else args.cell.split(","))
    meshes = {"single": [False], "multi": [True],
              "both": [False, True]}[args.mesh]
    os.makedirs(args.out, exist_ok=True)
    tcfg = TrainConfig(triangular_attention=args.triangular)

    failures = []
    for arch in archs:
        for cell in cells:
            for multi in meshes:
                tag = f"{arch}__{cell}__{'multi' if multi else 'single'}"
                path = os.path.join(args.out, tag + ".json")
                if args.skip_existing and os.path.exists(path):
                    print(f"[skip-existing] {tag}")
                    continue
                try:
                    rec = run_cell(arch, cell, multi, tcfg=tcfg)
                except Exception as e:                 # noqa: BLE001
                    rec = {"arch": arch, "cell": cell,
                           "mesh": "multi" if multi else "single",
                           "status": "error", "error": repr(e),
                           "traceback": traceback.format_exc()}
                    failures.append(tag)
                with open(path, "w") as f:
                    json.dump(rec, f, indent=1)
                if rec["status"] == "ok":
                    rl = rec["roofline"]
                    print(f"[ok] {tag}: trace={rec['trace_s']}s "
                          f"compute={rl['compute_s']*1e3:.2f}ms "
                          f"memory={rl['memory_s']*1e3:.2f}ms "
                          f"collective={rl['collective_link_s']*1e3:.2f}ms "
                          f"bottleneck={rl['bottleneck']} "
                          f"mfu={rec['mfu']:.3f}")
                elif rec["status"] == "skipped":
                    print(f"[skipped] {tag}: {rec['reason']}")
                else:
                    print(f"[ERROR] {tag}: {rec['error']}")
                sys.stdout.flush()
    if failures:
        print(f"\n{len(failures)} FAILURES: {failures}")
        return 1
    print("\nAll requested dry-run cells counted.")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
