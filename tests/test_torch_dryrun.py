"""The port's dry run (``launch/dryrun.py``): the recording env, the
count (``launch/costs.py``) and the kernel ops' ``meta`` routes.

* The recording env's record of a small dense and a small MoE train
  program on data 2 x model 2, at each rank's coordinate, equals what a
  real four-rank gloo world running the same program on the CPU emits
  (``torch.distributed``'s calls wrapped to record): kind, bytes and
  group size, in order.
* The count of a small program of each family (dense, MoE, RWKV-6,
  RecurrentGemma, encoder-decoder, VLM), train, prefill and decode, on
  ``meta`` equals its count on the CPU: flops, bytes and the tracked
  peak exactly, the kernel calls and the record too.
* Flops and bytes at 1, 2 and 3 superblocks are affine in depth.
* The flops of a program do not depend on the rank's coordinate.
* ``dryrun.main`` on a few full-size architectures writes the records
  with the reference's keys, ``skipped`` for a full-attention
  architecture on long_500k, and runs no plain version of rows 6 or 7;
  a fresh interpreter running the module loads no ``jax``/``repro``.
* One cut cell end to end against the reference, compiled in a
  subprocess on 256 forced devices (a mesh of ``AxisType.Auto`` axes:
  the reference's ``make_production_mesh`` gives Explicit axes on the
  installed JAX, which its sharding constraints refuse): starcoder2-3b
  at 2 layers, train at B 16 x S 128 on data 16 x model 16; the argument
  and donated bytes equal XLA's, ``model_flops`` equal; the ratios of
  flops and collective bytes are printed, not held (XLA counts
  elementwise ops, fuses, and moves other collectives).
"""
import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

from torch_dryrun_cases import (BATCH, SEQ, cell_of, draw, program,  # noqa
                                record_rank, small_cfg)
from repro_torch.configs import get_config                         # noqa
from repro_torch.configs.base import ShapeCell                     # noqa
from repro_torch.launch import dryrun                              # noqa
from repro_torch.launch.costs import count                         # noqa
from repro_torch.launch.steps import build_cell                    # noqa
from repro_torch.models.layers import param_dtype as t_param_dtype  # noqa
from repro_torch.runtime.meshenv import recording_env              # noqa

ROOT = Path(__file__).resolve().parents[1]
FAMILIES = {"dense": "starcoder2-3b", "moe": "granite-moe-1b-a400m",
            "rwkv6": "rwkv6-3b", "hybrid": "recurrentgemma-9b",
            "enc_dec": "seamless-m4t-large-v2", "vlm": "internvl2-1b"}
LAYOUT = {"data": 2, "model": 2}
COORDS = ((0, 0), (0, 1), (1, 0), (1, 1))


def _counted(fn, args):
    with count() as c:
        out = fn(*args)
        del out
    return c


def test_the_recording_env_records_what_a_gloo_world_emits(tmp_path):
    from torch_mesh_ranks import run_world
    cases = [("starcoder2-3b", "train", (2, 2)),
             ("granite-moe-1b-a400m", "train", (2, 2))]
    ranks = run_world(record_rank, 4, tmp_path, cases)
    for rank, got in enumerate(ranks):
        for (arch, kind, _), real in zip(cases, got):
            env = recording_env(LAYOUT, real["coordinate"])
            _, prog, args = program(arch, kind, env)
            prog.fn(*args)
            mine = [(k, b, n) for k, b, n, _ in env.record]
            assert real["record"], (arch, rank)
            assert mine == real["record"], (arch, rank)
            assert {p for *_, p in env.record} == {"fwd", "bwd"}


@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_the_count_on_meta_equals_the_count_on_the_cpu(family, kind):
    arch = FAMILIES[family]
    got = {}
    for dev in ("meta", "cpu"):
        env = recording_env(LAYOUT)
        cfg, prog, args = program(arch, kind, env)
        if dev == "cpu":
            args = draw(args, cfg)
        c = _counted(prog.fn, args)
        got[dev] = (c.flops, c.aten_flops, c.bytes, c.peak, c.kernels,
                    env.record)
        assert c.flops > 0 and c.bytes > 0 and c.peak > 0, dev
        assert c.live <= c.peak
    assert got["meta"] == got["cpu"]


@pytest.mark.parametrize("family", ["dense", "moe", "hybrid", "rwkv6"])
def test_the_count_is_affine_in_depth(family):
    arch = FAMILIES[family]
    base = small_cfg(arch)
    period = len(base.pattern)
    flops, moved = [], []
    for k in (1, 2, 3):
        cfg = dataclasses.replace(base, num_layers=period * k)
        env = recording_env(LAYOUT)
        prog = build_cell(cfg, env, cell_of("train"))
        c = _counted(prog.fn, dryrun.rank_args(prog, env)[0])
        flops.append(c.flops)
        moved.append(c.bytes)
    assert flops[2] - flops[1] == flops[1] - flops[0] > 0
    assert moved[2] - moved[1] == moved[1] - moved[0] > 0


@pytest.mark.parametrize("kind", ["train", "decode"])
def test_the_flops_do_not_depend_on_the_coordinate(kind):
    for arch in ("starcoder2-3b", "granite-moe-1b-a400m"):
        per = []
        for coord in COORDS:
            env = recording_env(LAYOUT, coord)
            _, prog, args = program(arch, kind, env)
            c = _counted(prog.fn, args)
            per.append((c.flops, c.kernels, [r[:3] for r in env.record]))
        assert all(p == per[0] for p in per), arch
    with pytest.raises(ValueError):
        recording_env(LAYOUT, (2, 0))


def test_main_writes_the_records_and_runs_no_plain_scan(tmp_path,
                                                        monkeypatch):
    from repro_torch.kernels.rglru import ops as rg_ops
    from repro_torch.kernels.wkv6 import ops as wk_ops

    def refuse(*a, **k):
        raise AssertionError("a plain version ran")

    monkeypatch.setattr(rg_ops, "rglru_scan_ref", refuse)
    monkeypatch.setattr(wk_ops, "wkv6_ref", refuse)
    rc = dryrun.main(["--arch", "starcoder2-3b,rwkv6-3b,recurrentgemma-9b",
                      "--cell", "decode_32k,long_500k", "--mesh", "single",
                      "--out", str(tmp_path)])
    assert rc == 0
    recs = {p.stem: json.loads(p.read_text())
            for p in tmp_path.glob("*.json")}
    assert len(recs) == 6
    skip = recs["starcoder2-3b__long_500k__single"]
    assert skip["status"] == "skipped" and "500k" in skip["reason"]
    keys = {"arch", "cell", "mesh", "status", "kind", "chips", "build_s",
            "trace_s", "memory_analysis", "cost_analysis", "collectives",
            "roofline", "roofline_step_s", "mfu"}
    for tag, rec in recs.items():
        if rec["status"] == "skipped":
            continue
        assert rec["status"] == "ok", tag
        assert keys <= set(rec), tag
        assert rec["chips"] == 256 and rec["kind"] == "decode"
        assert set(rec["memory_analysis"]) == {
            "argument_size_in_bytes", "output_size_in_bytes",
            "temp_size_in_bytes", "alias_size_in_bytes"}
        assert set(rec["cost_analysis"]) == {"flops", "bytes accessed"}
        assert set(rec["collectives"]) == {"bytes_by_kind", "counts",
                                           "total_bytes", "link_bytes",
                                           "summary"}
        assert rec["roofline"]["bottleneck"] in ("compute", "memory",
                                                 "collective")
        assert rec["roofline_step_s"] > 0 and 0 < rec["mfu"] < 1
    assert recs["rwkv6-3b__long_500k__single"]["kernels"]["wkv6"]["calls"]
    # skip-existing: nothing recounted
    assert dryrun.main(["--arch", "rwkv6-3b", "--cell", "long_500k",
                        "--mesh", "single", "--out", str(tmp_path),
                        "--skip-existing"]) == 0


def test_a_fresh_interpreter_runs_the_dry_run_without_jax(tmp_path):
    code = (
        "import runpy, sys\n"
        f"sys.argv = ['dryrun', '--arch', 'internvl2-1b', '--cell', "
        f"'decode_32k', '--mesh', 'multi', '--out', {str(tmp_path)!r}]\n"
        "try:\n"
        "    runpy.run_module('repro_torch.launch.dryrun', "
        "run_name='__main__')\n"
        "except SystemExit as e:\n"
        "    rc = e.code\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'repro')]\n"
        "assert not bad, bad\n"
        "sys.exit(rc)\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    p = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=120)
    assert p.returncode == 0, p.stderr[-3000:]
    rec = json.loads(next(tmp_path.glob("*.json")).read_text())
    assert rec["status"] == "ok" and rec["chips"] == 512


_REFERENCE = """
import os
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=256"
import dataclasses, json, sys
import jax
from jax.sharding import AxisType
from repro.configs import get_config
from repro.configs.base import ShapeCell
from repro.launch import hlo_stats, roofline
from repro.launch.steps import build_cell
from repro.runtime.meshenv import make_env
from repro.runtime.train import TrainConfig
cfg = dataclasses.replace(get_config("starcoder2-3b"), num_layers=2)
cell = ShapeCell("train_small", 128, 16, "train")
mesh = jax.make_mesh((16, 16), ("data", "model"),
                     axis_types=(AxisType.Auto,) * 2)
prog = build_cell(cfg, make_env(mesh), cell, TrainConfig(), unroll=True)
with mesh:
    compiled = prog.lower().compile()
m = compiled.memory_analysis()
c = compiled.cost_analysis()
c = c[0] if isinstance(c, (list, tuple)) else c
stats = hlo_stats.collect_stats(compiled.as_text(), 256)
print(json.dumps({
    "memory": {k: int(getattr(m, k)) for k in (
        "argument_size_in_bytes", "alias_size_in_bytes",
        "output_size_in_bytes", "temp_size_in_bytes")},
    "flops": float(c["flops"]), "bytes": float(c["bytes accessed"]),
    "collective_bytes": stats.total_bytes, "link_bytes": stats.link_bytes,
    "model_flops": roofline.model_flops(cfg, cell)}))
"""


def test_a_cut_cell_against_the_references_compiled_program():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               JAX_PLATFORMS="cpu")
    p = subprocess.run([sys.executable, "-c", _REFERENCE], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=240)
    assert p.returncode == 0, p.stderr[-3000:]
    ref = json.loads(p.stdout.strip().splitlines()[-1])
    cfg = dataclasses.replace(get_config("starcoder2-3b"), num_layers=2)
    rec = dryrun.run_cell("starcoder2-3b",
                          ShapeCell("train_small", 128, 16, "train"), False,
                          cfg=cfg)
    mem = rec["memory_analysis"]
    for key in ("argument_size_in_bytes", "alias_size_in_bytes"):
        assert mem[key] == ref["memory"][key], key
    assert rec["roofline"]["model_flops"] == ref["model_flops"]
    ratios = {
        "flops": rec["cost_analysis"]["flops"] / ref["flops"],
        "bytes": rec["cost_analysis"]["bytes accessed"] / ref["bytes"],
        "collective_bytes": (rec["collectives"]["total_bytes"]
                             / ref["collective_bytes"]),
        "link_bytes": rec["collectives"]["link_bytes"] / ref["link_bytes"],
        "output": mem["output_size_in_bytes"]
        / ref["memory"]["output_size_in_bytes"],
        "temp": mem["temp_size_in_bytes"]
        / ref["memory"]["temp_size_in_bytes"]}
    print("port / XLA:", json.dumps(ratios))


# ---------------------------------------------------------------------------
# context-parallel attention
# ---------------------------------------------------------------------------
def test_a_cp_cell_records_the_gathers_where_tp_records_the_psum():
    """A cut starcoder2-3b train cell counts on ``meta`` under
    ``TrainConfig(context_parallel_attention=True)``.  In the loss's
    forward on data 2 x model 2 (one kv head, so k/v and the residual
    differ in bytes), each attention call trades TP's all-reduce of the
    (B, S, d) output for three all-gathers: k and v (B, S, 1, hd) and
    the output (B, S, d), in that order."""
    from repro_torch.configs import reduced
    from repro_torch.models import transformer as tfm
    from repro_torch.runtime.meshenv import shard_tree
    from repro_torch.runtime.train import TrainConfig
    cut = dataclasses.replace(get_config("starcoder2-3b"), num_layers=2)
    rec = dryrun.run_cell("starcoder2-3b", ShapeCell("cut_train", 128, 16,
                                                     "train"), False,
                          cfg=cut,
                          tcfg=TrainConfig(context_parallel_attention=True))
    assert rec["status"] == "ok"
    assert rec["collectives"]["counts"]["all-gather"] > 0
    cfg = reduced(get_config("starcoder2-3b"), layers=2, kv_heads=1)
    B = BATCH // LAYOUT["data"]
    g = torch.Generator().manual_seed(0)
    batch = {k: torch.randint(0, cfg.vocab_size, (B, SEQ), generator=g)
             for k in ("tokens", "labels")}
    got = {}
    for cp in (False, True):
        env = recording_env(LAYOUT, context_parallel_attn=cp)
        params = shard_tree(tfm.init_lm(cfg, torch.Generator().manual_seed(0),
                                        "cpu", env),
                            tfm.param_specs(cfg, env), env)
        with torch.no_grad(), count() as c:
            tfm.loss_fn(cfg, params, batch, remat=False, env=env)
        got[cp] = (c.kernels["flash_attention"]["calls"],
                   [(k, b) for k, b, _, _ in env.record])
    calls = got[False][0]
    assert got[True][0] == calls == cfg.num_layers
    es = torch.empty((), dtype=t_param_dtype(cfg)).element_size()
    resid = B * SEQ * cfg.d_model * es
    kv = B * SEQ * cfg.num_kv_heads * cfg.head_dim * es
    assert kv != resid
    tp, cp = got[False][1], got[True][1]
    assert (tp.count(("all-reduce", resid))
            - cp.count(("all-reduce", resid))) == calls
    assert [b for k, b in tp if k == "all-gather"] == []
    assert [b for k, b in cp if k == "all-gather"] == [kv, kv, resid] * calls


@pytest.mark.parametrize("kind", ["train", "prefill"])
@pytest.mark.parametrize("family", ["dense", "moe", "hybrid", "enc_dec",
                                    "vlm"])
def test_the_cp_count_on_meta_equals_the_count_on_the_cpu(family, kind):
    arch = FAMILIES[family]
    got = {}
    for dev in ("meta", "cpu"):
        env = recording_env(LAYOUT, (1, 1), context_parallel_attn=True)
        cfg, prog, args = program(arch, kind, env)
        if dev == "cpu":
            args = draw(args, cfg)
        c = _counted(prog.fn, args)
        got[dev] = (c.flops, c.aten_flops, c.bytes, c.peak, c.kernels,
                    env.record)
        assert c.flops > 0 and c.bytes > 0 and c.peak > 0, dev
    assert got["meta"] == got["cpu"]


@pytest.mark.parametrize("coord", COORDS)
def test_row_3_reports_the_pairs_of_its_shard_s_offset(coord):
    """Under CP the rank at model index m runs row 3 on q rows [m·S/2,
    (m+1)·S/2) of each sequence against all S keys: the forward's
    reported flops are 4·B·Hq·hd·pairs(S/2, S, causal, window, m·S/2) a
    call, the backward's 2.5 times that."""
    from repro_torch.kernels.flash_attention.ops import pairs
    env = recording_env(LAYOUT, coord, context_parallel_attn=True)
    cfg, prog, args = program("starcoder2-3b", "train", env)
    c = _counted(prog.fn, args)
    B, half = BATCH // 2, SEQ // 2
    Hq = cfg.num_heads
    want = 4.0 * B * Hq * cfg.head_dim * pairs(half, SEQ, True, 0,
                                               coord[1] * half)
    fwd, bwd = c.kernels["flash_attention"], c.kernels["flash_attention_bwd"]
    assert fwd["flops"] == fwd["calls"] * want
    assert bwd["flops"] == bwd["calls"] * 2.5 * want
