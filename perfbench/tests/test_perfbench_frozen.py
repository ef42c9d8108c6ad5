"""The benchmark's frozen copies equal the program's own arithmetic
today, at a few shapes: row 3's pairs and costs, row 5's costs, the
model counts and model flops, the token-batch generator and the
profiler grouping."""
import importlib.util
import json
from pathlib import Path

import pytest
import torch

from harness import data, frozen, groups
from harness.common import model_config
from repro_torch.configs.base import ShapeCell
from repro_torch.kernels.flash_attention import ops as fops
from repro_torch.kernels.moe_gemm import ops as mops
from repro_torch.launch import roofline
from repro_torch.runtime.data import DataConfig, batch_at
from tiny import DENSE, DENSE_LOCAL, MOE

BENCH = Path(__file__).resolve().parents[1]
CONFIGS = [json.loads((BENCH / "configs" / f).read_text())["program"]
           for f in ("starcoder2-3b.json", "granite-moe-1b-a400m.json")]
MODELS = CONFIGS + [DENSE, DENSE_LOCAL, MOE]


@pytest.mark.parametrize("Sq,Skv,causal,window,off", [
    (1024, 1024, True, 0, 0), (8192, 8192, True, 0, 0),
    (1000, 1000, False, 0, 0), (2560, 2560, True, 2048, 0),
    (1024, 4096, True, 0, 3072), (16, 1000, False, 0, 0),
    (777, 777, False, 100, 0)])
def test_attention_pairs(Sq, Skv, causal, window, off):
    assert frozen.attention_pairs(Sq, Skv, causal, window, off) == \
        fops.pairs(Sq, Skv, causal, window, off)


@pytest.mark.parametrize("B,S,Hq,Hkv,hd,dt", [
    (1, 3000, 24, 2, 128, torch.bfloat16), (4, 1024, 24, 2, 128,
                                            torch.bfloat16),
    (4, 4096, 16, 8, 64, torch.bfloat16), (2, 64, 4, 2, 16, torch.float32)])
@pytest.mark.parametrize("stats", [False, True])
@pytest.mark.parametrize("window", [0, 4096])
def test_attention_costs(B, S, Hq, Hkv, hd, dt, stats, window):
    q = torch.empty((B, S, Hq, hd), dtype=dt, device="meta")
    k = torch.empty((B, S, Hkv, hd), dtype=dt, device="meta")
    es = q.element_size()
    bf16 = dt == torch.bfloat16
    assert frozen.attention_fwd_cost(B, S, S, Hq, Hkv, hd, es, True,
                                     window, stats, bf16) == \
        fops._cost_forward(q, k, True, window, stats)[:2]
    assert frozen.attention_bwd_cost(B, S, S, Hq, Hkv, hd, es, True,
                                     window, bf16) == \
        fops._cost_backward(q, k, True, window)[:2]


@pytest.mark.parametrize("E,C,d,ff,dt", [
    (32, 5120, 1024, 512, torch.bfloat16), (32, 1280, 1024, 512,
                                            torch.bfloat16),
    (64, 4, 2048, 1408, torch.bfloat16), (8, 10, 64, 32, torch.float32)])
def test_moe_costs(E, C, d, ff, dt):
    x = torch.empty((E, C, d), dtype=dt, device="meta")
    wg = torch.empty((E, d, ff), dtype=dt, device="meta")
    es = x.element_size()
    assert frozen.moe_fwd_cost(E, C, d, ff, es) == \
        mops._cost_forward(x, wg)[:2]
    assert frozen.moe_bwd_cost(E, C, d, ff, es) == \
        mops._cost_backward(x, wg)[:2]


@pytest.mark.parametrize("m", MODELS, ids=lambda m: m["name"])
def test_model_counts(m):
    cfg = model_config(m)
    assert frozen.num_params(m) == cfg.num_params()
    assert frozen.num_active_params(m) == cfg.num_active_params()
    assert frozen.body_and_unembed_params(m) == \
        roofline.body_and_unembed_params(cfg)
    for kind, B, S in (("train", 4, 4096), ("prefill", 1, 3000),
                       ("decode", 32, 8240)):
        cell = ShapeCell("c", S, B, kind)
        assert frozen.model_flops(m, kind, B, S) == \
            roofline.model_flops(cfg, cell)


def test_moe_capacity():
    from repro_torch.models.moe import capacity_for
    for m in (CONFIGS[1], MOE):
        cfg = model_config(m)
        for T in (16384, 4096, 64, 3):
            for f in (1.25, 2.0, 0.5):
                assert frozen.moe_capacity(T, m["num_experts"],
                                           m["experts_per_token"], f) == \
                    capacity_for(T, cfg, f)


@pytest.mark.parametrize("seed,step,B,S", [
    (0, 0, 2, 16), (3000000001, 5, 4, 1024), (2**31 + 7, 17, 4, 64)])
@pytest.mark.parametrize("m", CONFIGS, ids=lambda m: m["name"])
def test_batch_at(m, seed, step, B, S):
    cfg = model_config(m)
    ours = data.batch_at(m["vocab_size"], B, S, seed, step)
    theirs = batch_at(cfg, DataConfig(seed=seed, seq_len=S, global_batch=B),
                      step, "cpu")
    for k in ("tokens", "labels"):
        assert torch.equal(ours[k], theirs[k])


def _profile_tool():
    path = BENCH.parent / "tools" / "torch_session_profile.py"
    spec = importlib.util.spec_from_file_location("_tsp", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


NAMES = ["void flash_attention_tc_kernel<128>(Params)",
         "attn_bwd_dkdv_tc_kernel<128>", "attn_bwd_delta_kernel",
         "rmsnorm_kernel<3072>", "rmsnorm_bwd_rows_kernel",
         "rmsnorm_bwd_dw_kernel", "hopper_tc::gate_up_kernel",
         "hopper_tc::dw_kernel", "void moe_swiglu_mma<1>()",
         "sm90_xmma_gemm_bf16bf16_bf16f32", "nvjet_tst_128x256",
         "ampere_sgemm_128x64_nn", "void at::native::elementwise_kernel",
         "Memcpy HtoD (Pageable -> Device)", "wkv6_chunk::chunk_state",
         "rglru_bwd_chunk", "sweep_kernel"]


def test_groups_equal_the_profile_tools():
    tool = _profile_tool()
    dev = {n: 1.0 + i for i, n in enumerate(NAMES)}
    theirs = tool._groups({n: {"device_us": v} for n, v in dev.items()})
    assert groups.groups(dev) == theirs
