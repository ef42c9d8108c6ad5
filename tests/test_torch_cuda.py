"""Tests that need a CUDA card: the hand-written kernels (the sweep and
the single-split Li-GD steps, RMSNorm and flash attention with their
backward kernels, the fused expert SwiGLU, the RG-LRU scan, WKV6, each
with its backward kernel) against their plain PyTorch versions on the
same card tensors, a reduced model of every family through its loss
backward with no plain-version call, the sweep also on the fault path's
unreachable
hop counts (bit for bit), the admission / chaos sessions and the
closed-loop serving sessions card against CPU.  They skip without a
card.  On the machine with the card (no JAX there, so without the
repository's conftest):

    python -m pytest --noconftest -q -m cuda tests/test_torch_cuda.py

The sweep's two versions evaluate the same float32 ops in the same order,
each rounded on its own (the kernel's divisions take their fast path only
where it is the correctly rounded quotient, which a test below holds on
the card), so they are held to 1e-5; the language-model kernels'
tolerances are given beside their tests."""
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import costs as tcosts                     # noqa: E402
from repro_torch.configs.chain_cnns import nin, vgg16            # noqa: E402
from repro_torch.core.profile import profile_of                  # noqa: E402
from repro_torch.kernels import ligd_step as tsweep              # noqa: E402

from torch_diff import (assert_discrete, assert_iters, assert_rel,  # noqa
                        near_ties, np_of, sweep_columns)

KW = dict(lr=0.15, eps=1e-5, max_iters=60)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run on the machine with the card)")
    return torch.device("cuda", 0)


def _card_inputs(joint, X, profile, device, unreachable=False):
    """Sweep inputs on the card; ``unreachable`` gives them the fault
    path's rows: every third lane's hop count clamped to HOP_UNREACHABLE
    (a dead candidate's), and for MLi-GD every second lane's relay-back
    hops at HOP_UNREACHABLE (EVACUATE / DRAIN rows)."""
    dev, orig = sweep_columns(joint, X)
    if unreachable:
        from repro_torch.core.faults import HOP_UNREACHABLE
        dev["hops"][::3] = HOP_UNREACHABLE
        if joint:
            orig["hops_back"][::2] = HOP_UNREACHABLE
    td = tcosts.rows_to_device(dev, device)
    te = tcosts.edge_dict(tcosts.EdgeParams(), device)
    to = None if orig is None else tcosts.rows_to_device(orig, device)
    feat = tsweep.pack_sweep_features(
        td, te, float(profile.result_bits), X, orig=to,
        hops_back=None if to is None else to["hops_back"])
    K = 4 if joint else 2
    x0 = torch.full((K, X), 0.5, dtype=torch.float32, device=device)
    return feat, x0, tsweep.table_tensor(tsweep.sweep_tables(profile),
                                         device)


def _hold_to_plain_version(feat, x0, tab, joint, **kw):
    """One launch of the kernel against the plain version on the same card
    tensors, at this file's tolerances; returns the plain version's
    per-split iteration counts."""
    kw = dict(KW, **kw)
    init = (0.5,) * x0.shape[0]
    name = "mligd_sweep" if joint else "ligd_sweep"
    before = tsweep.LAUNCHES[name]
    u, xB, xr, it, best = tsweep.sweep_cuda(
        feat, x0, tab, joint=joint, warm_start=True, init=init, **kw)
    torch.cuda.synchronize()
    assert tsweep.LAUNCHES[name] == before + 1
    ref_fn = tsweep.mligd_sweep_ref if joint else tsweep.ligd_sweep_ref
    ur, xs, itr, bs, bx, bu = ref_fn(feat, x0, tab, init=init, chunk=1,
                                     **kw)
    assert_rel(u, ur, "U per layer", rtol=1e-5)
    assert_rel(best[1], bu, "best U", rtol=1e-5)
    np.testing.assert_allclose(np_of(xB), np_of(xs[0]), atol=1e-5)
    np.testing.assert_allclose(np_of(xr), np_of(xs[1]), atol=1e-5)
    assert_iters(np_of(it).T, np_of(itr).T)
    ties = near_ties(np_of(ur).T, 1e-5) if ur.shape[0] > 1 else \
        np.zeros(ur.shape[1], bool)
    assert_discrete(np_of(best[0]).astype(np.int64),
                    np_of(bs).astype(np.int64), ties, "best split")
    return itr


@pytest.mark.cuda
@pytest.mark.parametrize("model", [nin, vgg16])
@pytest.mark.parametrize("joint", [False, True])
def test_cuda_kernel_matches_plain_version(joint, model, cuda):
    profile = profile_of(model())
    feat, x0, tab = _card_inputs(joint, 4099, profile, cuda)   # ragged
    _hold_to_plain_version(feat, x0, tab, joint)


@pytest.mark.cuda
def test_cuda_kernel_divergent_synthetic_mligd(cuda):
    """chip_smoke.py's synthetic MLi-GD case (megafleet_100k's topology,
    random original strategies) at 20,000 lanes: lanes hit the iteration
    cap on different splits, so threads refill with new lanes at
    different times."""
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    import chip_smoke
    feat, x0, tab = chip_smoke.sweep_inputs(profile_of(nin()), 20_000, True,
                                            seed=7, device=cuda)
    itr = _hold_to_plain_version(feat, x0, tab, True)
    assert (itr >= KW["max_iters"]).float().mean().item() > 0.1


@pytest.mark.cuda
def test_cuda_kernel_serving_plan_single_lane(cuda):
    """X = 1: the serving plan's sweep over starcoder2-3b's 31 split points
    with ``max_iters`` 200, as launch/serve_split.py plans it."""
    from repro_torch.configs import get_config
    from repro_torch.core.ligd import init_block
    from repro_torch.core.profile import profile_transformer
    from repro_torch.launch import serve_split
    profile = profile_transformer(get_config(serve_split.ARCH), seq=1024,
                                  batch=4, mode="prefill")
    devs = tcosts.rows_to_device(tcosts.device_columns(
        [tcosts.DeviceParams(c_dev=serve_split.C_DEV)]), cuda, 1)
    feat = tsweep.pack_sweep_features(
        devs, tcosts.edge_dict(tcosts.EdgeParams(), cuda),
        float(profile.result_bits), 1)
    tab = tsweep.table_tensor(tsweep.sweep_tables(profile), cuda)
    assert tab.shape[0] == 31
    _hold_to_plain_version(feat, init_block((0.5, 0.5), 1, cuda), tab, False,
                           max_iters=200)


@pytest.mark.cuda
@pytest.mark.parametrize("joint", [False, True])
def test_cuda_kernel_ragged_lanes_on_both_division_paths(joint, cuda):
    """1,037 lanes (not a multiple of 32), every third with a noise floor
    that puts q/B under 1/16 (those lanes take CUDA's division intrinsics,
    the others the fast paths), the plain version's answer on all."""
    profile = profile_of(vgg16())
    feat, x0, tab = _card_inputs(joint, 1037, profile, cuda)
    n0 = tsweep.SWEEP_FIELDS.index("N0")
    feat[n0, ::3] *= 1e6
    q_over_B = feat[tsweep.SWEEP_FIELDS.index("c1")] / feat[n0] \
        / feat[tsweep.SWEEP_FIELDS.index("B_max")]
    assert (q_over_B[::3] < 1 / 16).all() and (q_over_B[1::3] > 1).all()
    _hold_to_plain_version(feat, x0, tab, joint)


@pytest.mark.cuda
def test_cuda_fast_paths_equal_the_intrinsics(cuda):
    """The sweep's fast division, reciprocal, exp2 and log2 equal CUDA's
    div.rn, rcp.rn, exp2f and log2f bit for bit over the ranges the kernel
    admits them (dividends and divisors 2^-100..2^100, quotients
    2^-110..2^110, exponents -126..126, logarithms of 2^-100..2^100),
    including divisors with all-ones and all-zeros mantissas."""
    from repro_torch.kernels.ligd_step import kernel as sweep_kernel
    g = torch.Generator(device=cuda).manual_seed(0)
    n = 1 << 22

    def uniform(lo, hi):
        return torch.rand(n, generator=g, device=cuda,
                          dtype=torch.float64) * (hi - lo) + lo

    def signs():
        return torch.where(torch.rand(n, generator=g, device=cuda) < 0.5,
                           -1.0, 1.0).double()

    for mantissa in (None, 0x7fffff, 0):
        eb = uniform(-100, 100)
        eq = torch.maximum(torch.minimum(uniform(-110, 110), 100 - eb),
                           -100 - eb)
        b = (torch.exp2(eb) * signs()).float()
        if mantissa is not None:
            bits = b.view(torch.int32)
            b = ((bits & ~0x7fffff) | mantissa).view(torch.float32)
        a = (torch.exp2(eb + eq) * signs()).float()
        c = uniform(-126, 126).float()
        out = sweep_kernel.fast_path_check(a, b, c)
        torch.cuda.synchronize()
        bits = out.view(torch.int32)
        for fast, exact, what in ((0, 4, "a/b"), (1, 5, "1/b"),
                                  (2, 6, "2^c"), (3, 7, "log2|b|")):
            differ = (bits[fast] != bits[exact]).sum().item()
            assert differ == 0, f"{what}: {differ} of {n} differ"


@pytest.mark.cuda
def test_cuda_ops_dispatch_launches_the_kernel(cuda):
    profile = profile_of(nin())
    feat, x0, tab = _card_inputs(False, 512, profile, cuda)
    before = tsweep.LAUNCHES["ligd_sweep"]
    res = tsweep.ligd_sweep(feat, x0, tab, **KW)
    assert tsweep.LAUNCHES["ligd_sweep"] == before + 1
    assert res.best_s.device == cuda and res.best_s.dtype == torch.int32


@pytest.mark.cuda
def test_cuda_wrapper_rejects_bad_inputs(cuda):
    profile = profile_of(nin())
    feat, x0, tab = _card_inputs(False, 64, profile, cuda)
    kw = dict(joint=False, warm_start=True, init=(0.5, 0.5), **KW)
    with pytest.raises(TypeError, match="float32"):
        tsweep.sweep_cuda(feat.double(), x0, tab, **kw)
    with pytest.raises(ValueError, match="contiguous"):
        tsweep.sweep_cuda(feat.t().contiguous().t(), x0, tab, **kw)
    with pytest.raises(ValueError, match="shape"):
        tsweep.sweep_cuda(feat, x0[:1], tab, **kw)


@pytest.mark.cuda
@pytest.mark.parametrize("joint", [False, True])
def test_cuda_kernel_unreachable_hops_bit_for_bit(joint, cuda):
    """Lanes whose relay terms run ~2^20 times a live lane's (their
    operands leave the fast paths' 2^-50..2^50 range) still give the
    plain version's answer bit for bit, as every other lane does."""
    feat, x0, tab = _card_inputs(joint, 3001, profile_of(nin()), cuda,
                                 unreachable=True)
    kw = dict(KW, warm_start=True, init=(0.5,) * x0.shape[0])
    u, xB, xr, it, best = tsweep.sweep_cuda(feat, x0, tab, joint=joint,
                                            **kw)
    ref = tsweep.mligd_sweep_ref if joint else tsweep.ligd_sweep_ref
    ur, xs, itr, bs, bx, bu = ref(feat, x0, tab, chunk=1, **kw)
    torch.cuda.synchronize()
    for name, a, b in (("U", u, ur), ("xB", xB, xs[0]), ("xr", xr, xs[1]),
                       ("iters", it, itr), ("best split", best[0], bs),
                       ("best U", best[1], bu),
                       *((f"best x{i}", best[2 + i], bx[i])
                         for i in range(x0.shape[0]))):
        assert torch.equal(a, b.to(a.dtype)), name
    assert torch.isfinite(u).all()


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["capacitated_k3", "chaos_singlefail_k3",
                                  "chaos_churn"])
def test_cuda_admission_session_matches_the_cpu(name, cuda):
    """The capacitated and chaos worlds at their preset sizes, card
    against CPU, to chip_smoke.py's session tolerances (a lane on the
    |dU| < eps edge may stop one GD step apart on the two devices)."""
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    import chip_smoke
    from repro_torch.api import Session, get_scenario
    fleets = {}
    for dev in ("cuda", "cpu"):
        s = Session(get_scenario(name), device=dev)
        m = s.run()
        up = s.topo.server_available()
        offl = s.fleet.split < s.profile.num_layers
        assert not np.any(~up[s.fleet.server] & offl)
        fleets[dev] = (s.fleet, m)
    chip_smoke.compare_fleets(fleets["cuda"][0], fleets["cpu"][0])
    np.testing.assert_array_equal(fleets["cuda"][1].handoffs,
                                  fleets["cpu"][1].handoffs)


@pytest.mark.cuda
@pytest.mark.parametrize("name, cut", [
    ("serve_chaos_k3", {"num_users": 150, "steps": 2}),
    ("serve_hotspot_k3", {"num_users": 64, "steps": 3}),
])
def test_cuda_dataplane_matches_the_cpu(name, cut, cuda):
    """A small closed loop (the serving presets cut as the CPU tests cut
    them, each with its own reduced engines) on the card against the
    CPU: the engines run on the card, counts in ``metrics().serving``
    are equal, floats and the telemetry multipliers within
    chip_smoke.py's SERVE_CROSS_RTOL (SERVE_HORIZON_RTOL of the virtual
    horizon for differences of virtual times)."""
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    import chip_smoke
    from repro_torch.api import Session, get_scenario
    sc = get_scenario(name).replace(**cut)
    ms = {}
    for dev in ("cuda", "cpu"):
        s = Session(sc, device=dev)
        ms[dev] = s.run()
        engines = [p.engine for p in s.dataplane.pools
                   if p.engine is not None]
        assert engines and all(e.device.type == dev for e in engines)
        chip_smoke.check_serving(ms[dev].serving, f"{name} {dev}",
                                 failovers=sc.faults is not None)
    atol = chip_smoke.SERVE_HORIZON_RTOL * \
        ms["cpu"].serving["virtual_time_s"]
    for f in ("serving", "telemetry"):
        chip_smoke.compare_serving(getattr(ms["cuda"], f),
                                   getattr(ms["cpu"], f), f, atol)


# ---------------------------------------------------------------------------
# RMSNorm (row 4) and flash attention (row 3): kernel against plain
# version on the card.  RMSNorm: 1e-5 in float32 (another summation
# order, rsqrtf), one bf16 rounding (5e-2) in bfloat16.  Attention: 2e-5
# in float32 (another summation order) elementwise and on the error's
# RMS over the output's RMS; in bfloat16 1e-2 elementwise and 1e-3 on
# that RMS ratio: outputs of long causal rows are ~0.05, so the reference
# kernel tests' 3e-2 could pass a dropped kv tile there.  Both sides
# round the same f32 value to bfloat16, so they differ by one ulp on a
# few elements only.
# ---------------------------------------------------------------------------
from repro_torch.kernels import flash_attention as tflash        # noqa: E402
from repro_torch.kernels import rmsnorm as trms                  # noqa: E402


def _randn(shape, dtype, device, seed):
    g = torch.Generator(device=device).manual_seed(seed)
    return torch.randn(shape, generator=g, device=device).to(dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("rows,d", [(8, 3072), (1000, 384), (3, 200)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_rmsnorm_matches_plain_version(rows, d, dtype, cuda):
    dt = getattr(torch, dtype)
    x, w = _randn((rows, d), dt, cuda, 0), _randn((d,), dt, cuda, 1)
    before = trms.LAUNCHES["rmsnorm"]
    y = trms.rmsnorm_cuda(x, w, 1e-6)
    torch.cuda.synchronize()
    assert trms.LAUNCHES["rmsnorm"] == before + 1
    tol = 1e-5 if dtype == "float32" else 5e-2
    torch.testing.assert_close(y.float(), trms.rmsnorm_ref(x, w).float(),
                               atol=tol, rtol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("B,Hq,Hkv,S,hd,causal,window", [
    (1, 4, 2, 128, 64, True, 0),
    (2, 8, 1, 200, 32, True, 0),        # MQA, ragged
    (1, 24, 2, 333, 128, True, 0),      # starcoder2 heads, ragged
    (1, 24, 2, 6, 128, True, 0),        # the closed loop's prompt
    (1, 24, 2, 11, 128, True, 0),       # its longest re-prefill
    (1, 2, 2, 192, 32, True, 32),
    (2, 4, 2, 96, 64, False, 0),
    (1, 4, 4, 160, 128, False, 48),
    (1, 16, 1, 300, 256, True, 64),     # recurrentgemma: MQA, windowed
    (2, 4, 1, 130, 256, True, 0),
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_flash_attention_matches_plain_version(B, Hq, Hkv, S, hd, causal,
                                                    window, dtype, cuda):
    dt = getattr(torch, dtype)
    q = _randn((B, S, Hq, hd), dt, cuda, 2)
    k = _randn((B, S, Hkv, hd), dt, cuda, 3)
    v = _randn((B, S, Hkv, hd), dt, cuda, 4)
    before = tflash.LAUNCHES["flash_attention"]
    out = tflash.flash_attention_cuda(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert tflash.LAUNCHES["flash_attention"] == before + 1
    ref = tflash.attention_ref(q, k, v, causal=causal, window=window).float()
    tol, rms_tol = (2e-5, 2e-5) if dtype == "float32" else (1e-2, 1e-3)
    torch.testing.assert_close(out.float(), ref, atol=tol, rtol=tol)
    rms = lambda t: t.square().mean().sqrt().item()               # noqa: E731
    assert rms(out.float() - ref) <= rms_tol * rms(ref)


def _attention_case(B, Hq, Hkv, S, hd, causal, window, dtype, device,
                    Skv=None):
    """One call of the kernel against its plain version, at the tolerances
    above (``Skv`` keys, default S); returns the launch counts'
    increments."""
    dt = getattr(torch, dtype)
    Skv = S if Skv is None else Skv
    q = _randn((B, S, Hq, hd), dt, device, 60)
    k = _randn((B, Skv, Hkv, hd), dt, device, 61)
    v = _randn((B, Skv, Hkv, hd), dt, device, 62)
    before = dict(tflash.LAUNCHES)
    out = tflash.flash_attention_cuda(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    counts = {n: tflash.LAUNCHES[n] - before[n] for n in before}
    ref = tflash.attention_ref(q, k, v, causal=causal, window=window).float()
    tol, rms_tol = (2e-5, 2e-5) if dtype == "float32" else (1e-2, 1e-3)
    torch.testing.assert_close(out.float(), ref, atol=tol, rtol=tol)
    rms = lambda t: t.square().mean().sqrt().item()               # noqa: E731
    assert rms(out.float() - ref) <= rms_tol * rms(ref)
    return counts


@pytest.mark.cuda
@pytest.mark.parametrize("B,Hq,Hkv,S,hd,window", [
    (4, 24, 2, 1024, 128, 0),           # starcoder2-3b prefill
    (4, 16, 8, 1024, 64, 0),            # granite-moe-1b-a400m prefill
    (4, 16, 1, 2560, 256, 2048),        # recurrentgemma-9b local layers
    (4, 32, 8, 1024, 128, 0),           # qwen3-8b prefill
    (4, 56, 8, 1024, 128, 0),           # yi-34b prefill
    (4, 32, 16, 2048, 128, 1024),       # gemma3-27b local layers
    (4, 14, 2, 1024, 64, 0),            # internvl2-1b prefill
])
def test_cuda_flash_attention_bf16_at_the_serving_shapes(B, Hq, Hkv, S, hd,
                                                         window, cuda):
    counts = _attention_case(B, Hq, Hkv, S, hd, True, window, "bfloat16",
                             cuda)
    assert counts == {"flash_attention": 1, "flash_attention_tc": 1}


@pytest.mark.cuda
@pytest.mark.parametrize("S", [1, 5, 63, 64, 65, 127, 129, 191, 200])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_cuda_flash_attention_ragged_lengths(S, causal, dtype, cuda):
    """S below one kv tile (64 keys), S = 1, and S off the q tile (64 rows
    a warpgroup, 128 or 192 a block) and the kv tile."""
    _attention_case(2, 6, 2, S, 128, causal, 0, dtype, cuda)


@pytest.mark.cuda
@pytest.mark.parametrize("Sq", [1, 16, 200])
@pytest.mark.parametrize("Skv", [129, 1000])
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_cuda_flash_attention_cross_shapes(Sq, Skv, dtype, cuda):
    """Non-causal attention with Sq != Skv, as the encoder-decoder's cross
    attention launches it (seamless-m4t: 16/16 heads of 64): a decode
    step's one query and a prompt's 16 against ragged source lengths,
    off the 64-key tile."""
    _attention_case(2, 16, 16, Sq, 64, False, 0, dtype, cuda, Skv=Skv)


@pytest.mark.cuda
@pytest.mark.parametrize("hd", [32, 64, 128, 256])
@pytest.mark.parametrize("ratio", [1, 2, 4, 7, 8, 12, 16])
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_cuda_flash_attention_gqa_ratios(hd, ratio, dtype, cuda):
    Hkv = 2 if ratio <= 8 else 1
    _attention_case(1, ratio * Hkv, Hkv, 150, hd, True, 0, dtype, cuda)


@pytest.mark.cuda
@pytest.mark.parametrize("window", [1, 17, 63, 64, 100, 130])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("hd", [64, 256])
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_cuda_flash_attention_windows(window, causal, hd, dtype, cuda):
    """Windows below one kv tile and off its multiples, causal and not
    (non-causal windows keep every later key)."""
    _attention_case(1, 4, 1, 300, hd, causal, window, dtype, cuda)


@pytest.mark.cuda
def test_cuda_flash_attention_counts_the_body_that_ran(cuda):
    assert _attention_case(1, 4, 2, 80, 64, True, 0, "bfloat16", cuda) == {
        "flash_attention": 1, "flash_attention_tc": 1}
    assert _attention_case(1, 4, 2, 80, 64, True, 0, "float32", cuda) == {
        "flash_attention": 1, "flash_attention_tc": 0}


#: every d_model of the registry's transformers, and the qk-norm's head_dim
def _rms_widths():
    from repro_torch.configs import ARCH_IDS, get_config
    return sorted({get_config(a).d_model for a in ARCH_IDS} | {128})


@pytest.mark.cuda
@pytest.mark.parametrize("d", _rms_widths())
@pytest.mark.parametrize("rows", [1, 3, 4096, 4097])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_rmsnorm_at_every_model_width(d, rows, dtype, cuda):
    dt = getattr(torch, dtype)
    x, w = _randn((rows, d), dt, cuda, 63), _randn((d,), dt, cuda, 64)
    before = trms.LAUNCHES["rmsnorm"]
    y = trms.rmsnorm_cuda(x, w, 1e-6)
    torch.cuda.synchronize()
    assert trms.LAUNCHES["rmsnorm"] == before + 1
    tol = 1e-5 if dtype == "float32" else 5e-2
    torch.testing.assert_close(y.float(), trms.rmsnorm_ref(x, w).float(),
                               atol=tol, rtol=tol)


@pytest.mark.cuda
def test_cuda_lm_ops_dispatch_launch_the_kernels(cuda):
    x = _randn((2, 5, 64), torch.bfloat16, cuda, 5)
    w = _randn((64,), torch.bfloat16, cuda, 6)
    before = trms.LAUNCHES["rmsnorm"]
    assert trms.rmsnorm(x, w).shape == x.shape
    assert trms.LAUNCHES["rmsnorm"] == before + 1
    q = _randn((1, 16, 4, 32), torch.bfloat16, cuda, 7)
    before = tflash.LAUNCHES["flash_attention"]
    assert tflash.flash_attention(q, q[:, :, :2].contiguous(),
                                  q[:, :, 2:].contiguous()).shape == q.shape
    assert tflash.LAUNCHES["flash_attention"] == before + 1


@pytest.mark.cuda
def test_cuda_lm_wrappers_reject_bad_inputs(cuda):
    x = _randn((4, 64), torch.float32, cuda, 8)
    w = _randn((64,), torch.float32, cuda, 9)
    with pytest.raises(TypeError, match="dtype"):
        trms.rmsnorm_cuda(x.double(), w.double())
    with pytest.raises(TypeError, match="dtype"):
        trms.rmsnorm_cuda(x, w.bfloat16())
    with pytest.raises(ValueError, match="contiguous"):
        trms.rmsnorm_cuda(x.t().contiguous().t(), w)
    with pytest.raises(ValueError, match="CUDA"):
        trms.rmsnorm_cuda(x.cpu(), w.cpu())
    xb = _randn((3, 100), torch.bfloat16, cuda, 12)     # 200-byte rows
    with pytest.raises(ValueError, match="16-byte"):
        trms.rmsnorm_cuda(xb, _randn((100,), torch.bfloat16, cuda, 13))
    with pytest.raises(ValueError, match="16-byte"):     # offset by 4 bytes
        trms.rmsnorm_cuda(x.view(-1)[1:65].view(1, 64), w)
    q = _randn((1, 16, 4, 32), torch.float32, cuda, 10)
    k = _randn((1, 12, 2, 32), torch.float32, cuda, 11)
    with pytest.raises(ValueError, match="causal"):
        tflash.flash_attention_cuda(q, k, k, causal=True)
    with pytest.raises(ValueError, match="head_dim"):
        tflash.flash_attention_cuda(q[..., :16].contiguous(),
                                    q[:, :, :2, :16].contiguous(),
                                    q[:, :, :2, :16].contiguous())
    with pytest.raises(TypeError, match="dtype"):
        tflash.flash_attention_cuda(q, q.bfloat16(), q)
    with pytest.raises(ValueError, match="contiguous"):
        tflash.flash_attention_cuda(q.transpose(1, 2), q.transpose(1, 2),
                                    q.transpose(1, 2))


# ---------------------------------------------------------------------------
# Fused expert SwiGLU (row 5) and WKV6 (row 7): kernel against plain
# version on the card.  MoE: 1e-5 in float32 (the reference kernel tests'
# figure; the same float32 products summed in another order); in
# bfloat16 both sides round the same float32 value once (the tensor-core
# path keeps h as bf16 hi + lo, ~16 bits), 2e-2 elementwise and 1e-3 on
# the error's RMS over the output's RMS.  WKV6: 2e-4, the
# reference kernel tests' figure, on y and on the final state.
# ---------------------------------------------------------------------------
from repro_torch.kernels import moe_gemm as tmoe                 # noqa: E402
from repro_torch.kernels import wkv6 as twkv                     # noqa: E402


@pytest.mark.cuda
@pytest.mark.parametrize("E,C,d,ff", [
    (32, 4, 1024, 512),         # granite decode: bf16 mma.sync, 8 ff slices
    (32, 1280, 1024, 512),      # granite prefill: bf16 wgmma
    (4, 37, 1024, 1408),        # ragged C
    (4, 37, 1024, 1000),        # ragged C and ff tail (1000 = 15·64 + 40)
    (32, 300, 128, 96),         # ragged ff tail
    (3, 20, 64, 40),            # d below one wgmma column tile
    (2, 17, 2048, 96),          # d > 1024
    (64, 480, 2048, 1408),      # moonshot prefill: bf16 wgmma
    (64, 1, 2048, 1408),        # moonshot decode: bf16 mma.sync, one
    (64, 4, 2048, 1408),        # m16 tile a block at d 2048
    (64, 16, 2048, 1408),
    (3, 8, 64, 40)])            # CUDA-core path in bf16 too (d % 128)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_moe_swiglu_matches_plain_version(E, C, d, ff, dtype, cuda):
    dt = getattr(torch, dtype)
    x = _randn((E, C, d), dt, cuda, 20)
    wg = (_randn((E, d, ff), torch.float32, cuda, 21) * d ** -0.5).to(dt)
    wu = (_randn((E, d, ff), torch.float32, cuda, 22) * d ** -0.5).to(dt)
    wd = (_randn((E, ff, d), torch.float32, cuda, 23) * ff ** -0.5).to(dt)
    body = tmoe.kernel.body_for(dt, C, d, ff)
    before = dict(tmoe.LAUNCHES)
    y = tmoe.moe_swiglu_cuda(x, wg, wu, wd)
    torch.cuda.synchronize()
    assert tmoe.LAUNCHES["moe_swiglu"] == before["moe_swiglu"] + 1
    assert (tmoe.LAUNCHES["moe_swiglu_" + body]
            == before["moe_swiglu_" + body] + 1)
    ref = tmoe.moe_swiglu_ref(x, wg, wu, wd).float()
    tol = 1e-5 if dtype == "float32" else 2e-2
    torch.testing.assert_close(y.float(), ref, atol=tol, rtol=tol)
    if dtype == "bfloat16":
        rms = lambda t: t.square().mean().sqrt().item()           # noqa: E731
        assert rms(y.float() - ref) <= 1e-3 * rms(ref)


@pytest.mark.cuda
@pytest.mark.parametrize("C", [1, 16])
def test_cuda_moe_swiglu_mma_at_d_2048_gives_the_same_bits(C, cuda):
    """The mma.sync body at moonshot-v1-16b-a3b's width (one m16 tile a
    block) sums its ff slices in a fixed order: two launches on the same
    inputs give the same bits."""
    E, d, ff, dt = 64, 2048, 1408, torch.bfloat16
    x = _randn((E, C, d), dt, cuda, 24)
    wg = (_randn((E, d, ff), torch.float32, cuda, 25) * d ** -0.5).to(dt)
    wu = (_randn((E, d, ff), torch.float32, cuda, 26) * d ** -0.5).to(dt)
    wd = (_randn((E, ff, d), torch.float32, cuda, 27) * ff ** -0.5).to(dt)
    before = tmoe.LAUNCHES["moe_swiglu_mma"]
    a = tmoe.moe_swiglu_cuda(x, wg, wu, wd)
    b = tmoe.moe_swiglu_cuda(x, wg, wu, wd)
    torch.cuda.synchronize()
    assert tmoe.LAUNCHES["moe_swiglu_mma"] == before + 2
    assert torch.equal(a, b)


def _wkv_inputs(B, S, H, n, dt, device):
    r, k, v = (_randn((B, S, H, n), dt, device, 30 + i) for i in range(3))
    w = torch.rand((B, S, H, n), generator=torch.Generator(
        device=device).manual_seed(33), device=device) * 0.65 + 0.3
    u = _randn((H, n), torch.float32, device, 34)
    s0 = _randn((B, H, n, n), torch.float32, device, 35) * 0.5
    return r, k, v, w, u, s0


@pytest.mark.cuda
@pytest.mark.parametrize("B,S,H,n", [(2, 100, 3, 64), (1, 33, 2, 32),
                                     (3, 1, 40, 64), (2, 130, 2, 32),
                                     (1, 65, 3, 64)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_wkv6_matches_plain_version(B, S, H, n, dtype, cuda):
    r, k, v, w, u, s0 = _wkv_inputs(B, S, H, n, getattr(torch, dtype), cuda)
    body = twkv.kernel.body_for(S, n)
    before = dict(twkv.LAUNCHES)
    y, s = twkv.wkv6_cuda(r, k, v, w, u, s0)
    torch.cuda.synchronize()
    assert twkv.LAUNCHES["wkv6"] == before["wkv6"] + 1
    assert twkv.LAUNCHES["wkv6_" + body] == before["wkv6_" + body] + 1
    ry, rs = twkv.wkv6_ref(r, k, v, w, u, s0)
    torch.testing.assert_close(y, ry, atol=2e-4, rtol=2e-4)
    torch.testing.assert_close(s, rs, atol=2e-4, rtol=2e-4)
    y0, _ = twkv.wkv6_cuda(r, k, v, w, u)                    # zero state
    torch.testing.assert_close(y0, twkv.wkv6_ref(r, k, v, w, u)[0],
                               atol=2e-4, rtol=2e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("E,C,ff", [(32, 1280, 512), (32, 320, 512),
                                    (4, 37, 1408), (4, 37, 1000)])
def test_cuda_moe_prefill_runs_the_wgmma_body(E, C, ff, cuda, monkeypatch):
    """bf16 prefill shapes (granite's prefill, an engine prefill, ragged
    C and ff) through ``ops.moe_swiglu``: the wgmma body launches, as its
    counter shows, and the plain version is never reached."""
    from repro_torch.kernels.moe_gemm import ops as moe_ops
    d = 1024
    x = _randn((E, C, d), torch.bfloat16, cuda, 24)
    wg = (_randn((E, d, ff), torch.float32, cuda, 25) * d ** -0.5).bfloat16()
    wu = (_randn((E, d, ff), torch.float32, cuda, 26) * d ** -0.5).bfloat16()
    wd = (_randn((E, ff, d), torch.float32, cuda, 27)
          * ff ** -0.5).bfloat16()
    ref = tmoe.moe_swiglu_ref(x, wg, wu, wd).float()

    def no_plain(*a, **k):
        raise AssertionError("a CUDA tensor reached the plain version")
    monkeypatch.setattr(moe_ops, "moe_swiglu_ref", no_plain)
    before = dict(tmoe.LAUNCHES)
    y = moe_ops.moe_swiglu(x, wg, wu, wd).float()
    torch.cuda.synchronize()
    assert tmoe.LAUNCHES["moe_swiglu_wgmma"] == \
        before["moe_swiglu_wgmma"] + 1
    assert tmoe.LAUNCHES["moe_swiglu"] == before["moe_swiglu"] + 1
    torch.testing.assert_close(y, ref, atol=2e-2, rtol=2e-2)
    rms = lambda t: t.square().mean().sqrt().item()               # noqa: E731
    assert rms(y - ref) <= 1e-3 * rms(ref)


@pytest.mark.cuda
@pytest.mark.parametrize("B,S", [(4, 1024), (1, 777)])
def test_cuda_wkv6_chunked_at_the_models_decays(B, S, cuda, monkeypatch):
    """The chunked body at rwkv6-3b's width, ragged S, decays drawn as
    the model forms them (some exactly 0), from a state that is also the
    output (aliased, as decode passes it): 2e-4 elementwise and 1e-6 on
    the error's RMS over the result's, as ``chip_smoke.py`` holds it; the
    plain version is never reached for CUDA tensors."""
    from repro_torch.kernels.wkv6 import ops as wkv_ops
    H, n = 40, 64
    r, k, v = (_randn((B, S, H, n), torch.bfloat16, cuda, 60 + i)
               for i in range(3))
    w = torch.exp(-torch.exp(torch.clamp(
        _randn((B, S, H, n), torch.float32, cuda, 63) * 6.0 + 1.0,
        -20.0, 10.0)))
    assert bool((w == 0).any())
    u = _randn((H, n), torch.float32, cuda, 64) * 0.5
    s0 = _randn((B, H, n, n), torch.float32, cuda, 65) * 0.5
    ry, rs = twkv.wkv6_ref(r, k, v, w, u, s0)

    def no_plain(*a, **kw):
        raise AssertionError("a CUDA tensor reached the plain version")
    monkeypatch.setattr(wkv_ops, "wkv6_ref", no_plain)
    state = s0.clone()
    before = dict(twkv.LAUNCHES)
    y, s = wkv_ops.wkv6(r, k, v, w, u, state, state_out=state)
    torch.cuda.synchronize()
    assert twkv.LAUNCHES["wkv6_chunked"] == before["wkv6_chunked"] + 1
    assert twkv.LAUNCHES["wkv6_serial"] == before["wkv6_serial"]
    assert s.data_ptr() == state.data_ptr()
    rms = lambda t: t.square().mean().sqrt().item()               # noqa: E731
    for got, want in ((y, ry), (state, rs)):
        torch.testing.assert_close(got, want, atol=2e-4, rtol=2e-4)
        assert rms(got - want) <= 1e-6 * rms(want)


@pytest.mark.cuda
def test_cuda_wkv6_state_may_alias(cuda):
    """Decode: the cache's own state is s0 and the output, one tensor."""
    r, k, v, w, u, s0 = _wkv_inputs(4, 1, 40, 64, torch.bfloat16, cuda)
    ry, rs = twkv.wkv6_ref(r, k, v, w, u, s0)
    state = s0.clone()
    y, s = twkv.wkv6(r, k, v, w, u, state, state_out=state)
    torch.cuda.synchronize()
    assert s.data_ptr() == state.data_ptr()
    torch.testing.assert_close(y, ry, atol=2e-4, rtol=2e-4)
    torch.testing.assert_close(state, rs, atol=2e-4, rtol=2e-4)


@pytest.mark.cuda
def test_cuda_moe_wkv_wrappers_reject_bad_inputs(cuda):
    x = _randn((2, 4, 64), torch.float32, cuda, 40)
    wg = _randn((2, 64, 32), torch.float32, cuda, 41)
    wd = _randn((2, 32, 64), torch.float32, cuda, 42)
    with pytest.raises(TypeError, match="dtype"):
        tmoe.moe_swiglu_cuda(x, wg.bfloat16(), wg, wd)
    with pytest.raises(ValueError, match="contiguous"):
        tmoe.moe_swiglu_cuda(x.transpose(1, 2).contiguous().transpose(1, 2),
                             wg, wg, wd)
    with pytest.raises(ValueError, match="d="):
        big = _randn((1, 2, 4096), torch.float32, cuda, 43)
        tmoe.moe_swiglu_cuda(big, big.new_zeros((1, 4096, 8)),
                             big.new_zeros((1, 4096, 8)),
                             big.new_zeros((1, 8, 4096)))
    r, k, v, w, u, s0 = _wkv_inputs(1, 4, 2, 64, torch.float32, cuda)
    with pytest.raises(TypeError, match="dtype"):
        twkv.wkv6_cuda(r, k, v, w.bfloat16(), u)
    with pytest.raises(ValueError, match="head size"):
        twkv.wkv6_cuda(*(t[..., :16].contiguous() for t in (r, k, v, w)),
                       u[:, :16].contiguous())
    with pytest.raises(ValueError, match="CUDA"):
        twkv.wkv6_cuda(r, k, v, w, u.cpu())


# ---------------------------------------------------------------------------
# RG-LRU scan (row 6) and single-split Li-GD steps (row 2): kernel against
# plain version on the card.  The scan: 1e-5, the reference kernel tests'
# figure (the same float32 recurrence; the kernel fuses a·h + b into one
# FMA).  The steps: the reference test's tolerances, x 1e-5 and U atol
# 1e-5 / rtol 1e-4 (closed-form gradient against autograd).
# ---------------------------------------------------------------------------
from repro_torch.kernels import rglru as trglru                  # noqa: E402


@pytest.mark.cuda
@pytest.mark.parametrize("B,S,C", [(4, 300, 4096), (3, 33, 130), (1, 1, 5)])
def test_cuda_rglru_scan_matches_plain_version(B, S, C, cuda):
    g = torch.Generator(device=cuda).manual_seed(50)
    a = torch.rand((B, S, C), generator=g, device=cuda) * 0.5 + 0.499
    b = torch.randn((B, S, C), generator=g, device=cuda) * 0.3
    before = trglru.LAUNCHES["rglru_scan"]
    h = trglru.rglru_scan_cuda(a, b)
    torch.cuda.synchronize()
    assert trglru.LAUNCHES["rglru_scan"] == before + 1
    torch.testing.assert_close(h, trglru.rglru_scan_ref(a, b), atol=1e-5,
                               rtol=1e-5)
    assert torch.equal(trglru.rglru_scan(a, b), h)       # ops -> kernel
    assert trglru.LAUNCHES["rglru_scan"] == before + 2


@pytest.mark.cuda
def test_cuda_ligd_steps_matches_plain_version(cuda):
    from repro_torch.kernels.ligd_step import steps as tsteps
    rng = np.random.default_rng(51)
    X = 5000
    profile = profile_of(vgg16())
    f_l, f_e, w = profile.prefix_tables()
    s = rng.integers(0, len(f_l), X)
    dev = tcosts.rows_to_device(tcosts.device_columns(tcosts.DeviceFleet(
        c_dev=rng.uniform(3e9, 60e9, X),
        hops=rng.integers(1, 6, X).astype(np.float64))), cuda, X)
    col = lambda v: torch.tensor(v, dtype=torch.float32, device=cuda)  # noqa
    feat = tsweep.pack_features(col(f_l[s]), col(f_e[s]), col(w[s]),
                                col(np.full(X, profile.result_bits)),
                                col((f_e[s] > 0).astype(np.float64)), dev)
    x0 = col(rng.uniform(0, 1, (X, 2)))
    edge = tcosts.edge_dict(tcosts.EdgeParams(), cuda)
    before = tsteps.LAUNCHES["ligd_steps"]
    x, u = tsweep.ligd_steps(feat, x0, edge, iters=64)
    torch.cuda.synchronize()
    assert tsteps.LAUNCHES["ligd_steps"] == before + 1
    xr, ur = tsweep.ligd_steps_ref(feat, x0, edge, iters=64)
    torch.testing.assert_close(x, xr, atol=1e-5, rtol=0)
    torch.testing.assert_close(u, ur, atol=1e-5, rtol=1e-4)


@pytest.mark.cuda
def test_cuda_rglru_and_steps_wrappers_reject_bad_inputs(cuda):
    from repro_torch.kernels.ligd_step import steps as tsteps
    a = torch.rand((2, 3, 8), device=cuda)
    with pytest.raises(TypeError, match="dtype"):
        trglru.rglru_scan_cuda(a.bfloat16(), a.bfloat16())
    with pytest.raises(ValueError, match="contiguous"):
        trglru.rglru_scan_cuda(a.transpose(1, 2), a.transpose(1, 2))
    with pytest.raises(ValueError, match="equal"):
        trglru.rglru_scan_cuda(a, a[:, :2].contiguous())
    feat = torch.rand((10, 16), device=cuda)
    et = tsweep.edge_tuple_of(tcosts.edge_dict(tcosts.EdgeParams(), cuda))
    with pytest.raises(ValueError, match="shape"):
        tsteps.ligd_steps_cuda(feat[:, :15].contiguous(),
                               torch.rand((10, 2), device=cuda), et)
    with pytest.raises(ValueError, match="rows"):
        tsteps.ligd_steps_cuda(feat, torch.rand((9, 2), device=cuda), et)
    with pytest.raises(TypeError, match="dtype"):
        tsteps.ligd_steps_cuda(feat.double(),
                               torch.rand((10, 2), device=cuda), et)


# ---------------------------------------------------------------------------
# Row 2, every server's group in one launch (ligd_steps_grouped): each group
# against the plain version at the reference test's tolerances, on
# ref.steps_interior_case's interior optima (4 servers) and on the random
# vgg16 fleet of the test above as a fifth group with the default edge.
# ---------------------------------------------------------------------------
def _grouped_steps_inputs(cuda):
    feat, x0, offsets, edges = tsweep.steps_interior_case(20_000, 4, 52,
                                                          cuda)
    rng = np.random.default_rng(53)
    X = 3001
    profile = profile_of(vgg16())
    f_l, f_e, w = profile.prefix_tables()
    s = rng.integers(0, len(f_l), X)
    dev = tcosts.rows_to_device(tcosts.device_columns(tcosts.DeviceFleet(
        c_dev=rng.uniform(3e9, 60e9, X),
        hops=rng.integers(1, 6, X).astype(np.float64))), cuda, X)
    col = lambda v: torch.tensor(v, dtype=torch.float32, device=cuda)  # noqa
    vfeat = tsweep.pack_features(col(f_l[s]), col(f_e[s]), col(w[s]),
                                 col(np.full(X, profile.result_bits)),
                                 col((f_e[s] > 0).astype(np.float64)), dev)
    edge = {k: float(v) for k, v in
            tcosts.edge_dict(tcosts.EdgeParams(), "cpu").items()}
    return (torch.cat([feat, vfeat]),
            torch.cat([x0, col(rng.uniform(0, 1, (X, 2)))]),
            offsets + [offsets[-1] + X], edges + [edge])


@pytest.mark.cuda
def test_cuda_ligd_steps_grouped_matches_plain_version_per_group(cuda):
    from repro_torch.kernels.ligd_step import steps as tsteps
    feat, x0, offsets, edges = _grouped_steps_inputs(cuda)
    before = tsteps.LAUNCHES["ligd_steps"]
    x, u = tsweep.ligd_steps_grouped(feat, x0, offsets, edges, iters=64)
    torch.cuda.synchronize()
    assert tsteps.LAUNCHES["ligd_steps"] == before + 1
    for a, b, e in zip(offsets, offsets[1:], edges):
        xr, ur = tsweep.ligd_steps_ref(feat[a:b], x0[a:b], e, iters=64)
        torch.testing.assert_close(x[a:b], xr, atol=1e-5, rtol=0)
        torch.testing.assert_close(u[a:b], ur, atol=1e-5, rtol=1e-4)


@pytest.mark.cuda
def test_cuda_ligd_steps_one_group_equals_its_rows_of_the_grouped_launch(
        cuda):
    feat, x0, offsets, edges = _grouped_steps_inputs(cuda)
    x, u = tsweep.ligd_steps_grouped(feat, x0, offsets, edges, iters=48)
    for j in (0, len(edges) - 1):
        a, b = offsets[j], offsets[j + 1]
        xg, ug = tsweep.ligd_steps(feat[a:b], x0[a:b], edges[j], iters=48)
        assert torch.equal(xg, x[a:b]) and torch.equal(ug, u[a:b])


@pytest.mark.cuda
def test_cuda_ligd_steps_interior_lanes(cuda):
    """Lanes that end strictly inside (0, 1)^2, where no clamp hides the
    body's arithmetic: nearly all of the interior case, each within the
    tolerances."""
    feat, x0, offsets, edges = _grouped_steps_inputs(cuda)
    n = offsets[4]                       # the four interior groups
    x, u = tsweep.ligd_steps_grouped(feat[:n], x0[:n], offsets[:5],
                                     edges[:4], iters=64)
    xr, ur = tsweep.ligd_steps_grouped_ref(feat[:n], x0[:n], offsets[:5],
                                           edges[:4], iters=64)
    inner = tsweep.interior_lanes(xr, feat[:n])
    assert inner.float().mean().item() > 0.95
    torch.testing.assert_close(x[inner], xr[inner], atol=1e-5, rtol=0)
    torch.testing.assert_close(u[inner], ur[inner], atol=1e-5, rtol=1e-4)
    assert (xr[inner] - x0[:n][inner]).abs().max().item() > 0.1


@pytest.mark.cuda
def test_cuda_ligd_steps_grouped_wrapper_refuses_bad_input(cuda):
    from repro_torch.kernels.ligd_step import steps as tsteps
    feat = torch.rand((10, 16), device=cuda)
    x0 = torch.rand((10, 2), device=cuda)
    et = tsweep.edge_tuple_of(tcosts.edge_dict(tcosts.EdgeParams(), cuda))
    before = tsteps.LAUNCHES["ligd_steps"]
    with pytest.raises(ValueError, match="monotone"):
        tsteps.ligd_steps_grouped_cuda(feat, x0, [0, 6, 4, 10], [et] * 3)
    with pytest.raises(ValueError, match="groups"):
        tsteps.ligd_steps_grouped_cuda(
            feat, x0, [0] * (tsteps.MAX_GROUPS + 1) + [10],
            [et] * (tsteps.MAX_GROUPS + 1))
    with pytest.raises(ValueError, match="edge records"):
        tsteps.ligd_steps_grouped_cuda(feat, x0, [0, 4, 10], [et])
    with pytest.raises(ValueError, match="expected 0..10"):
        tsteps.ligd_steps_grouped_cuda(feat, x0, [0, 4, 9], [et, et])
    with pytest.raises(ValueError, match="host"):
        tsteps.ligd_steps_grouped_cuda(
            feat, x0, torch.tensor([0, 10], device=cuda), [et])
    assert tsteps.LAUNCHES["ligd_steps"] == before


# ---------------------------------------------------------------------------
# The chain-CNN split executor and the autodiff oracle on the card
# ---------------------------------------------------------------------------
@pytest.mark.cuda
@pytest.mark.parametrize("name", ["nin", "yolov2", "vgg16"])
def test_cuda_chain_cnn_split_and_card_against_cpu(name, cuda):
    """On the card split execution equals unsplit bit for bit at every
    split; with cuDNN's TF32 off the card equals the CPU to rtol 1e-4 /
    atol 1e-5 (float32 sums in another order), chip_smoke.py's
    CNN_RTOL / CNN_ATOL."""
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    import chip_smoke
    from repro_torch.configs import get_config
    from repro_torch.models import chain_cnn
    cfg = get_config(name)
    params = chain_cnn.init_cnn(cfg, torch.Generator().manual_seed(0), cuda)
    x = torch.randn((8, cfg.in_hw, cfg.in_hw, cfg.in_ch),
                    generator=torch.Generator().manual_seed(1)).to(cuda)
    full = chain_cnn.forward(cfg, params, x)
    for s in range(cfg.num_layers + 1):
        assert torch.equal(chain_cnn.split_inference(cfg, params, x, s)[1],
                           full), f"split {s}"
    with chip_smoke.cudnn_tf32(False):
        got = chain_cnn.forward(cfg, params, x).cpu()
    want = chain_cnn.forward(cfg, chip_smoke.to_tree(params, device="cpu"),
                             x.cpu())
    torch.testing.assert_close(got, want, rtol=chip_smoke.CNN_RTOL,
                               atol=chip_smoke.CNN_ATOL)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["nin_hetero_warm", "nin_hetero_cold",
                                  "vgg16_shared", "mligd_relay_back",
                                  "mligd_resolve"])
def test_cuda_autodiff_oracle_matches_the_sweep(name, cuda):
    """The oracle (torch.autograd on the card) against the sweep kernel
    on the reference tests' fleets, at the reference's tolerances (split
    and R exact, B, r, U to 1e-4, iteration counts within 1)."""
    import dataclasses
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    import chip_smoke
    case = {c["name"]: c for c in chip_smoke.ORACLE_CASES}[name]
    fn, args, cfg = chip_smoke.oracle_args(case, cuda)
    before = dict(tsweep.LAUNCHES)
    fused = fn(*args, cfg)
    oracle = fn(*args, dataclasses.replace(cfg, solver="autodiff"))
    torch.cuda.synchronize()
    assert sum(tsweep.LAUNCHES.values()) == sum(before.values()) + 1
    err, breaches = chip_smoke.oracle_errors(fused, oracle)
    assert not breaches, (err, breaches)


# ---------------------------------------------------------------------------
# Rows 3 and 4's backward kernels against float32 autograd through their
# plain versions, at chip_smoke.py's GRAD_TOL / GRAD_RMS_TOL (its
# comment gives the reasons), and bit for bit from one run to the next.
# ---------------------------------------------------------------------------
def _chip_smoke():
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    import chip_smoke
    return chip_smoke


def _attention_bwd_case(B, Hq, Hkv, S, hd, causal, window, dtype, device,
                        Skv=None, key_offset=0.0):
    """The backward kernel on the forward kernel's output (bf16: with the
    training forward's LSE and residual, whose ``out`` must equal the
    serving forward's bit for bit) against float32 autograd through
    ``attention_ref``, twice for the same bits; the keys are randn +
    ``key_offset`` (a component they share, which D from bf16 out would
    let into dq).  Returns the backward's launch increments."""
    cs = _chip_smoke()
    dt = getattr(torch, dtype)
    Skv = S if Skv is None else Skv
    q = _randn((B, S, Hq, hd), dt, device, 70)
    k = (_randn((B, Skv, Hkv, hd), torch.float32, device, 71)
         + key_offset).to(dt)
    v = _randn((B, Skv, Hkv, hd), dt, device, 72)
    dout = _randn((B, S, Hq, hd), dt, device, 73)
    kw = dict(causal=causal, window=window)
    stats = {}
    out = tflash.flash_attention_cuda(q, k, v, **kw)
    if dtype == "bfloat16":
        out_t, lse, lo = tflash.flash_attention_cuda(q, k, v, stats=True,
                                                     **kw)
        assert torch.equal(out_t, out)
        stats = dict(lse=lse, out_lo=lo)
    before = dict(tflash_bwd.LAUNCHES)
    got = tflash.flash_attention_bwd_cuda(q, k, v, out, dout, **kw, **stats)
    again = tflash.flash_attention_bwd_cuda(q, k, v, out, dout, **kw,
                                            **stats)
    torch.cuda.synchronize()
    counts = {n: tflash_bwd.LAUNCHES[n] - before[n] for n in before}
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    assert [t.dtype for t in got] == [dt] * 3
    leaves = [t.float().requires_grad_() for t in (q, k, v)]
    want = torch.autograd.grad(tflash.attention_ref(*leaves, **kw), leaves,
                               dout.float())
    for name, g, w in zip("qkv", got, want):
        if not w.any():
            # one key a row (S = 1): dS = dP - D = 0, so dq is zero up to
            # the float32 rounding of dP and D, and has no RMS to compare
            assert g.abs().max().item() <= 1e-5, f"d{name}"
            continue
        err, rr, ok = cs.grad_errors(g, w, dtype)
        assert ok, f"d{name}: max {err:.3g}, rel RMS {rr:.3g}"
    return counts


from repro_torch.kernels.flash_attention import backward as tflash_bwd  # noqa
from repro_torch.kernels.rmsnorm import backward as trms_bwd          # noqa


def _bwd_counts(dtype, calls=2):
    tc = calls if dtype == "bfloat16" else 0
    return {"flash_attention_bwd": calls, "flash_attention_bwd_tc": tc}


@pytest.mark.cuda
@pytest.mark.parametrize("B,S,Hq,Hkv,hd,window,dtype", [
    (4, 1024, 24, 2, 128, 0, "bfloat16"),     # starcoder2-3b
    (4, 1024, 32, 8, 128, 0, "bfloat16"),     # qwen3-8b's ratio 4
    (4, 1024, 16, 8, 64, 0, "bfloat16"),
    (1, 2048, 32, 16, 128, 1024, "bfloat16"),  # gemma3-27b's local layer
    (2, 1024, 24, 2, 128, 0, "float32"),
])
def test_cuda_flash_attention_bwd_at_the_train_shapes(B, S, Hq, Hkv, hd,
                                                      window, dtype, cuda):
    counts = _attention_bwd_case(B, Hq, Hkv, S, hd, True, window, dtype,
                                 cuda)
    assert counts == _bwd_counts(dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("Hq,Hkv", [(24, 2), (32, 8)])
@pytest.mark.parametrize("key_offset", [2.0, 4.0])
def test_cuda_flash_attention_bwd_keys_with_an_offset(Hq, Hkv, key_offset,
                                                      cuda):
    """Keys randn + c at starcoder2-3b's shape and at 32/8 heads of 128:
    with D from bf16 out, dq breaches GRAD_RMS_TOL at c = 2 and 4
    (tests/test_torch_attn_bwd_rounding.py); the float32 D and dS as hi +
    lo in dS·K hold it."""
    counts = _attention_bwd_case(4, Hq, Hkv, 1024, 128, True, 0, "bfloat16",
                                 cuda, key_offset=key_offset)
    assert counts == _bwd_counts("bfloat16")


@pytest.mark.cuda
@pytest.mark.parametrize("Hq,Hkv", [(4, 4), (4, 2), (8, 2), (7, 1)])
@pytest.mark.parametrize("causal,window", [(True, 0), (True, 17),
                                           (False, 0), (False, 40)])
@pytest.mark.parametrize("hd", [32, 64, 128])
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_cuda_flash_attention_bwd_gqa_masks_head_dims(Hq, Hkv, causal,
                                                      window, hd, dtype,
                                                      cuda):
    """GQA ratios 1, 2, 4 and 7, causal, windowed and non-causal, at a
    ragged length (off the 64-row tiles)."""
    _attention_bwd_case(2, Hq, Hkv, 150, hd, causal, window, dtype, cuda)


@pytest.mark.cuda
@pytest.mark.parametrize("causal,window", [(True, 0), (True, 17),
                                           (False, 40)])
@pytest.mark.parametrize("hd", [32, 64, 128])
@pytest.mark.parametrize("key_offset", [2.0, 4.0])
def test_cuda_flash_attention_bwd_bf16_offset_keys(causal, window, hd,
                                                   key_offset, cuda):
    """The bf16 grid with keys randn + c: GQA 16/1 (the widest ratio the
    port's configurations have), causal, windowed and non-causal, ragged."""
    _attention_bwd_case(2, 16, 1, 150, hd, causal, window, "bfloat16", cuda,
                        key_offset=key_offset)


@pytest.mark.cuda
@pytest.mark.parametrize("S", [1, 5, 64, 65, 129])
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_cuda_flash_attention_bwd_ragged_lengths(S, dtype, cuda):
    _attention_bwd_case(1, 6, 2, S, 64, True, 0, dtype, cuda)


@pytest.mark.cuda
@pytest.mark.parametrize("S", [5, 65, 129])
def test_cuda_flash_attention_bwd_ragged_offset_keys(S, cuda):
    _attention_bwd_case(1, 6, 2, S, 128, True, 0, "bfloat16", cuda,
                        key_offset=4.0)


@pytest.mark.cuda
@pytest.mark.parametrize("Sq,Skv", [(1, 129), (16, 100), (200, 70)])
def test_cuda_flash_attention_bwd_cross_shapes(Sq, Skv, cuda):
    """Non-causal Sq != Skv, the encoder-decoder's cross attention."""
    _attention_bwd_case(2, 4, 4, Sq, 64, False, 0, "float32", cuda,
                        Skv=Skv)


@pytest.mark.cuda
@pytest.mark.parametrize("Sq,Skv", [(1, 129), (16, 100), (200, 70)])
@pytest.mark.parametrize("key_offset", [0.0, 4.0])
def test_cuda_flash_attention_bwd_cross_shapes_bf16(Sq, Skv, key_offset,
                                                    cuda):
    _attention_bwd_case(2, 4, 4, Sq, 64, False, 0, "bfloat16", cuda,
                        Skv=Skv, key_offset=key_offset)


@pytest.mark.cuda
def test_cuda_flash_attention_bwd_refuses_other_head_dims(cuda):
    q = _randn((1, 8, 2, 96), torch.bfloat16, cuda, 74)
    with pytest.raises(ValueError, match="head_dim 96"):
        tflash.flash_attention_bwd_cuda(q, q, q, q, q)


@pytest.mark.cuda
@pytest.mark.parametrize("B,S,Hq,Hkv,causal,window,dtype,key_offset", [
    (2, 2560, 16, 1, True, 2048, "bfloat16", 2.0),  # recurrentgemma-9b
    (2, 2560, 16, 1, True, 2048, "bfloat16", 0.0),
    (2, 150, 4, 1, True, 17, "bfloat16", 4.0),
    (2, 150, 4, 2, False, 0, "bfloat16", 0.0),
    (1, 33, 2, 1, True, 0, "bfloat16", 0.0),
    (2, 150, 4, 1, True, 17, "float32", 0.0),
    (1, 100, 2, 2, False, 40, "float32", 2.0),
])
def test_cuda_flash_attention_bwd_head_dim_256(B, S, Hq, Hkv, causal,
                                               window, dtype, key_offset,
                                               cuda):
    """Head_dim 256: bf16 runs the tensor-core body (two warpgroups a
    block) with the training forward's LSE and residual, float32 the
    CUDA-core body (32-row tiles); ragged lengths and keys randn + c."""
    counts = _attention_bwd_case(B, Hq, Hkv, S, 256, causal, window, dtype,
                                 cuda, key_offset=key_offset)
    assert counts == _bwd_counts(dtype)


@pytest.mark.cuda
def test_cuda_flash_attention_bwd_takes_the_stats_its_body_needs(cuda):
    """bf16 refuses a call without the training forward's LSE and
    residual, float32 one with them; the forward gives both for bf16 and
    the LSE alone for float32 (the serving merge's), within 2e-5 of the
    plain version's."""
    q = _randn((1, 8, 2, 64), torch.bfloat16, cuda, 74)
    with pytest.raises(ValueError, match="lse"):
        tflash.flash_attention_bwd_cuda(q, q, q, q, q)
    f = q.float()
    with pytest.raises(ValueError, match="float32"):
        tflash.flash_attention_bwd_cuda(f, f, f, f, f, lse=f, out_lo=f)
    out, lse, lo = tflash.flash_attention_cuda(f, f, f, stats=True)
    assert lo is None
    from repro_torch.kernels.flash_attention.ref import attention_ref
    _, want, _ = attention_ref(f.cpu(), f.cpu(), f.cpu(), stats=True)
    torch.testing.assert_close(lse.cpu(), want, rtol=2e-5, atol=2e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("hd", [32, 64, 128, 256])
def test_cuda_flash_attention_bwd_smem_matches_the_library(hd, cuda):
    for kernel in ("dkdv", "dq"):
        assert tflash_bwd.library_smem_bytes(hd, kernel) == \
            tflash_bwd.smem_bytes(hd, kernel)


def _rms_bwd_case(rows, d, dtype, device):
    cs = _chip_smoke()
    dt = getattr(torch, dtype)
    x, w = _randn((rows, d), dt, device, 75), _randn((d,), dt, device, 76)
    g = _randn((rows, d), dt, device, 77)
    before = trms_bwd.LAUNCHES["rmsnorm_bwd"]
    got = trms_bwd.rmsnorm_bwd_cuda(x, w, g, 1e-6)
    again = trms_bwd.rmsnorm_bwd_cuda(x, w, g, 1e-6)
    torch.cuda.synchronize()
    assert trms_bwd.LAUNCHES["rmsnorm_bwd"] == before + 2
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    xf, wf = x.float().requires_grad_(), w.float().requires_grad_()
    want = torch.autograd.grad(trms.rmsnorm_ref(xf, wf, 1e-6), (xf, wf),
                               g.float())
    for name, a, b in zip(("dx", "dw"), got, want):
        err, rr, ok = cs.grad_errors(a, b, dtype)
        assert ok, f"{name}: max {err:.3g}, rel RMS {rr:.3g}"


@pytest.mark.cuda
@pytest.mark.parametrize("rows,d,dtype", [
    (4096, 3072, "bfloat16"),           # starcoder2-3b's norms
    (131072, 128, "bfloat16"),          # qwen3-8b's qk-norm rows
    (4096, 3072, "float32"),
    (3, 7168, "bfloat16"),              # yi-34b, fewer rows than blocks
    (1000, 64, "float32"),              # a smoke model
    (777, 5376, "bfloat16"),            # gemma3-27b
])
def test_cuda_rmsnorm_bwd_matches_plain_version(rows, d, dtype, cuda):
    _rms_bwd_case(rows, d, dtype, cuda)


@pytest.mark.cuda
@pytest.mark.parametrize("d", _rms_widths())
@pytest.mark.parametrize("rows", [1, 3, 4097])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_rmsnorm_bwd_at_every_model_width(d, rows, dtype, cuda):
    _rms_bwd_case(rows, d, dtype, cuda)


@pytest.mark.cuda
@pytest.mark.parametrize("d,dtype", [(8, "bfloat16"), (4, "float32"),
                                     (40, "bfloat16"), (14336, "bfloat16"),
                                     (7168, "float32")])
def test_cuda_rmsnorm_bwd_at_the_forwards_extreme_widths(d, dtype, cuda):
    """One vector a row, a row that ends inside a thread's vectors, and the
    widest rows the forward takes (256 threads x 7 vectors)."""
    _rms_bwd_case(33, d, dtype, cuda)


@pytest.mark.cuda
def test_cuda_lm_ops_backward_runs_the_kernels(cuda):
    """A gradient through ``ops.rmsnorm`` and ``ops.flash_attention`` on
    the card launches the backward kernels, once each."""
    x = _randn((2, 40, 64), torch.bfloat16, cuda, 78).requires_grad_()
    w = _randn((64,), torch.bfloat16, cuda, 79).requires_grad_()
    b_rms = trms_bwd.LAUNCHES["rmsnorm_bwd"]
    b_att = tflash_bwd.LAUNCHES["flash_attention_bwd"]
    b_tc = tflash_bwd.LAUNCHES["flash_attention_bwd_tc"]
    h = trms.rmsnorm(x, w).reshape(2, 40, 2, 32)
    out = tflash.flash_attention(h, h[:, :, :1].contiguous(),
                                 h[:, :, 1:].contiguous())
    out.float().square().sum().backward()
    torch.cuda.synchronize()
    assert trms_bwd.LAUNCHES["rmsnorm_bwd"] == b_rms + 1
    assert tflash_bwd.LAUNCHES["flash_attention_bwd"] == b_att + 1
    assert tflash_bwd.LAUNCHES["flash_attention_bwd_tc"] == b_tc + 1
    assert x.grad is not None and w.grad is not None
    assert x.grad.abs().sum().item() > 0 and w.grad.abs().sum().item() > 0


@pytest.mark.cuda
def test_cuda_rows_5_to_7_give_a_gradient(cuda):
    """A gradient through ``ops.moe_swiglu``, ``ops.rglru_scan`` and
    ``ops.wkv6`` launches each backward kernel once and reaches every
    input; under ``no_grad`` (serving) the same calls launch no backward
    kernel and give the same bits as the recorded forward."""
    x = _randn((2, 8, 64), torch.float32, cuda, 80).requires_grad_()
    w = (_randn((2, 64, 64), torch.float32, cuda, 81) / 8).requires_grad_()
    a = torch.rand((1, 5, 32), device=cuda).requires_grad_()
    r = _randn((1, 5, 2, 32), torch.float32, cuda, 82).requires_grad_()
    u = _randn((2, 32), torch.float32, cuda, 83).requires_grad_()
    wd = torch.rand((1, 5, 2, 32), device=cuda).requires_grad_()
    before = {n: m.LAUNCHES[n] for n, m in (
        ("moe_swiglu_bwd", tmoe_bwd), ("rglru_scan_bwd", trglru_bwd),
        ("wkv6_bwd", twkv_bwd))}
    y_moe = tmoe.moe_swiglu(x, w, w, w)
    h = trglru.rglru_scan(a, a)
    y_wkv, _ = twkv.wkv6(r, r, r, wd, u)
    (y_moe.square().sum() + h.square().sum()
     + y_wkv.square().sum()).backward()
    torch.cuda.synchronize()
    for n, m in (("moe_swiglu_bwd", tmoe_bwd),
                 ("rglru_scan_bwd", trglru_bwd), ("wkv6_bwd", twkv_bwd)):
        assert m.LAUNCHES[n] == before[n] + 1, n
    for t in (x, w, a, r, u, wd):
        assert t.grad is not None and t.grad.abs().sum().item() > 0
    with torch.no_grad():
        assert torch.equal(tmoe.moe_swiglu(x, w, w, w), y_moe)
        assert torch.equal(trglru.rglru_scan(a, a), h)
        assert torch.equal(twkv.wkv6(r, r, r, wd, u)[0], y_wkv)
    for n, m in (("moe_swiglu_bwd", tmoe_bwd),
                 ("rglru_scan_bwd", trglru_bwd), ("wkv6_bwd", twkv_bwd)):
        assert m.LAUNCHES[n] == before[n] + 1, n


from repro_torch.kernels.moe_gemm import backward as tmoe_bwd        # noqa
from repro_torch.kernels.rglru import backward as trglru_bwd         # noqa
from repro_torch.kernels.wkv6 import backward as twkv_bwd            # noqa


def _hold_grads(names, got, want, dtype):
    cs = _chip_smoke()
    for name, g, w in zip(names, got, want):
        if not w.any():
            # da at S 1 (h_{-1} = 0): zero in both, no RMS to compare
            assert not g.any(), name
            continue
        err, rr, ok = cs.grad_errors(g, w, dtype)
        assert ok, f"{name}: max {err:.3g}, rel RMS {rr:.3g}"


def _twice(fn, counter, name):
    """Two calls of a backward kernel: one launch count each, the same
    bits."""
    before = counter[name]
    got, again = fn(), fn()
    torch.cuda.synchronize()
    assert counter[name] == before + 2
    assert all((a is None and b is None) or torch.equal(a, b)
               for a, b in zip(got, again))
    return got


@pytest.mark.cuda
@pytest.mark.parametrize("E,C,d,ff,dtype", [
    (32, 1280, 1024, 512, "bfloat16"),     # granite-moe's training shape
    (32, 4, 1024, 512, "bfloat16"),        # a decode-sized capacity
    (3, 70, 136, 200, "bfloat16"),         # C, d and ff off the tiles
    (4, 300, 2048, 1408, "bfloat16"),      # moonshot-v1-16b-a3b's widths
    (2, 16, 136, 200, "bfloat16"),         # the largest mma.sync capacity
    (2, 17, 136, 200, "bfloat16"),         # the smallest wgmma one
    (4, 100, 64, 128, "float32"),
    (2, 1, 72, 24, "float32"),
])
def test_cuda_moe_swiglu_bwd_matches_plain_version(E, C, d, ff, dtype,
                                                   cuda):
    """bf16 above 16 capacity rows runs the wgmma + TMA body (counted as
    moe_swiglu_bwd_tc), up to 16 the mma.sync tiles; float32 the CUDA
    cores."""
    dt = getattr(torch, dtype)
    x = _randn((E, C, d), dt, cuda, 90)
    wg = (_randn((E, d, ff), torch.float32, cuda, 91) * d ** -0.5).to(dt)
    wu = (_randn((E, d, ff), torch.float32, cuda, 92) * d ** -0.5).to(dt)
    wd = (_randn((E, ff, d), torch.float32, cuda, 93) * ff ** -0.5).to(dt)
    dy = _randn((E, C, d), dt, cuda, 94)
    tc = tmoe_bwd.LAUNCHES["moe_swiglu_bwd_tc"]
    got = _twice(lambda: tmoe_bwd.moe_swiglu_bwd_cuda(x, wg, wu, wd, dy),
                 tmoe_bwd.LAUNCHES, "moe_swiglu_bwd")
    wgmma = tmoe_bwd.body_for(dt, C, d, ff) == "wgmma"
    assert wgmma == (dtype == "bfloat16" and C > 16)
    assert tmoe_bwd.LAUNCHES["moe_swiglu_bwd_tc"] == tc + (2 if wgmma else 0)
    assert [t.dtype for t in got] == [dt] * 4
    leaves = [t.float().requires_grad_() for t in (x, wg, wu, wd)]
    want = torch.autograd.grad(tmoe.moe_swiglu_ref(*leaves), leaves,
                               dy.float())
    _hold_grads(("dx", "dwg", "dwu", "dwd"), got, want, dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("B,S,C,a_near", [
    (2, 2560, 4096, 1.0),                   # recurrentgemma-9b, a ~ 1
    (2, 2560, 4096, 0.0),                   # a ~ 0
    (1, 37, 100, 0.5),                      # S off the chunks, C ragged
    (3, 1, 64, 1.0),
    (2, 300, 1000, 0.5),                    # S not a multiple of the chunk
    (1, 100, 4096, 1.0),                    # S shorter than one chunk
    (3, 129, 4096, 1.0),                    # B 3, one step past a chunk
])
def test_cuda_rglru_scan_bwd_matches_plain_version(B, S, C, a_near, cuda):
    """Time split across blocks in chunks of 128 steps, the carries
    chained between them, against float32 autograd through the plain
    scan."""
    g = torch.Generator(device=cuda).manual_seed(95)
    jitter = torch.rand((B, S, C), generator=g, device=cuda) * 1e-3
    a = (1.0 - jitter if a_near == 1.0 else jitter if a_near == 0.0
         else torch.rand((B, S, C), generator=g, device=cuda))
    b = _randn((B, S, C), torch.float32, cuda, 96)
    dh = _randn((B, S, C), torch.float32, cuda, 97)
    h = trglru.rglru_scan_cuda(a, b)
    got = _twice(lambda: trglru_bwd.rglru_scan_bwd_cuda(a, h, dh),
                 trglru_bwd.LAUNCHES, "rglru_scan_bwd")
    leaves = [a.clone().requires_grad_(), b.clone().requires_grad_()]
    want = torch.autograd.grad(trglru.rglru_scan_ref(*leaves), leaves, dh)
    _hold_grads(("da", "db"), got, want, "float32")


def _wkv_bwd_inputs(B, S, H, n, dtype, device, seed):
    g = torch.Generator(device=device).manual_seed(seed)
    dt = getattr(torch, dtype)

    def rn(shape, scale=1.0):
        return (torch.randn(shape, generator=g, device=device) * scale)

    r, k, v = (rn((B, S, H, n), 0.5).to(dt) for _ in range(3))
    w = torch.rand((B, S, H, n), generator=g, device=device)
    w[..., ::7] = 0.0                       # exp(-e^10) in float32
    w[..., 3::11] = 1.0                     # exp(-e^-20)
    u = rn((H, n), 0.5)
    dy = rn((B, S, H, n))
    return r, k, v, w, u, dy


@pytest.mark.cuda
@pytest.mark.parametrize("B,S,H,n,dtype,with_s0", [
    (4, 1024, 40, 64, "bfloat16", False),   # rwkv6-3b's training shape
    (2, 100, 4, 64, "bfloat16", True),      # from a state, with ds0
    (2, 37, 3, 32, "float32", True),        # S off the segments
    (1, 8, 2, 64, "float32", False),
    (1, 1, 2, 32, "float32", True),
    (2, 200, 3, 64, "float32", True),       # chunked, ragged, with ds0
    (1, 65, 2, 64, "float32", False),       # the first chunked length
    (1, 64, 2, 64, "float32", True),        # the last serial one
])
def test_cuda_wkv6_bwd_matches_plain_version(B, S, H, n, dtype, with_s0,
                                             cuda):
    """Against float32 autograd through the plain recurrence, with w = 0
    and w = 1 entries; from a nonzero s0, with the final state's gradient
    too, where ``with_s0``.  The body is the forward's (chunked past 64
    steps at head size 64), as its counter shows."""
    r, k, v, w, u, dy = _wkv_bwd_inputs(B, S, H, n, dtype, cuda, 98)
    s0 = ds = None
    if with_s0:
        s0 = _randn((B, H, n, n), torch.float32, cuda, 99)
        ds = _randn((B, H, n, n), torch.float32, cuda, 100)
    body = twkv_bwd.body_for(S, n)
    assert body == ("chunked" if S > 64 and n == 64 else "serial")
    before = twkv_bwd.LAUNCHES["wkv6_bwd_" + body]
    got = _twice(lambda: twkv_bwd.wkv6_bwd_cuda(r, k, v, w, u, s0, dy, ds),
                 twkv_bwd.LAUNCHES, "wkv6_bwd")
    assert twkv_bwd.LAUNCHES["wkv6_bwd_" + body] == before + 2
    assert (got[5] is None) == (s0 is None)
    leaves = [t.float().requires_grad_() for t in (r, k, v, w, u)]
    if s0 is not None:
        leaves.append(s0.clone().requires_grad_())
    y, s_fin = twkv.wkv6_ref(*leaves[:5], leaves[5] if s0 is not None
                             else None)
    outs, grads = [y], [dy]
    if ds is not None:
        outs.append(s_fin)
        grads.append(ds)
    want = torch.autograd.grad(outs, leaves, grads)
    names = ("dr", "dk", "dv", "dw", "du", "ds0")
    _hold_grads(names, [t for t in got if t is not None], want, dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("B,S,dtype", [(1, 777, "float32"),
                                       (2, 300, "bfloat16")])
def test_cuda_wkv6_bwd_chunked_at_the_models_decays(B, S, dtype, cuda):
    """The chunked backward at rwkv6-3b's heads, ragged S, decays drawn as
    the model forms them (exactly 0 in places), from a state with the
    final state's gradient, against float32 autograd through the plain
    recurrence."""
    H, n = 40, 64
    dt = getattr(torch, dtype)
    r, k, v = (_randn((B, S, H, n), torch.float32, cuda, 101 + i) * 0.5
               for i in range(3))
    r, k, v = r.to(dt), k.to(dt), v.to(dt)
    w = torch.exp(-torch.exp(torch.clamp(
        _randn((B, S, H, n), torch.float32, cuda, 104) * 6.0 + 1.0,
        -20.0, 10.0)))
    assert bool((w == 0).any())
    u = _randn((H, n), torch.float32, cuda, 105) * 0.5
    dy = _randn((B, S, H, n), torch.float32, cuda, 106)
    s0 = _randn((B, H, n, n), torch.float32, cuda, 107) * 0.5
    ds = _randn((B, H, n, n), torch.float32, cuda, 108)
    before = twkv_bwd.LAUNCHES["wkv6_bwd_chunked"]
    got = _twice(lambda: twkv_bwd.wkv6_bwd_cuda(r, k, v, w, u, s0, dy, ds),
                 twkv_bwd.LAUNCHES, "wkv6_bwd")
    assert twkv_bwd.LAUNCHES["wkv6_bwd_chunked"] == before + 2
    leaves = [t.float().requires_grad_() for t in (r, k, v, w, u)]
    leaves.append(s0.clone().requires_grad_())
    y, s_fin = twkv.wkv6_ref(*leaves)
    want = torch.autograd.grad([y, s_fin], leaves, [dy, ds])
    _hold_grads(("dr", "dk", "dv", "dw", "du", "ds0"), got, want, dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["granite-moe-1b-a400m", "rwkv6-3b",
                                  "recurrentgemma-9b",
                                  "seamless-m4t-large-v2"])
def test_cuda_loss_fn_backward_every_family(arch, cuda):
    """A reduced bf16 model of each family that ``loss_fn`` took from the
    port's later slices: every kernel of its path, forward and backward,
    is a launch (recomputed forwards under remat), no plain version runs,
    and every parameter leaf gets a finite, non-zero gradient."""
    from repro_torch import _tree
    from repro_torch.configs import get_config, reduced
    from repro_torch.models import transformer as ttfm
    from repro_torch.runtime.data import DataConfig, batch_at
    cs = _chip_smoke()
    cfg = reduced(get_config(arch), layers=2, d_model=256, heads=4,
                  kv_heads=1 if arch == "recurrentgemma-9b" else 2)
    assert cfg.dtype == "bfloat16"
    params = ttfm.init_lm(cfg, torch.Generator(cuda).manual_seed(0), cuda)
    batch = batch_at(cfg, DataConfig(seq_len=96, global_batch=2), 0, cuda)
    flat = _tree.leaves(params)
    for p in flat:
        p.requires_grad_(True)
    counters = cs.kernel_counters()
    cs.zero_counters(counters)
    with cs.plain_version_calls() as plain:
        total, metrics = ttfm.loss_fn(cfg, params, batch)
        grads = torch.autograd.grad(total, flat)
        torch.cuda.synchronize()
    launches = cs.all_launches(counters)
    assert not any(plain.values()), plain
    want = cs.train_launches_per_step(cfg, 2, 96)
    assert {k: v for k, v in launches.items() if v} == want
    assert torch.isfinite(total)
    if cfg.num_experts:
        assert float(metrics["aux"]) > 0
    for g in grads:
        assert torch.isfinite(g).all() and g.abs().max().item() > 0


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["qwen3-8b", "gemma3-27b", "internvl2-1b"])
def test_cuda_loss_fn_backward_runs_no_plain_version(arch, cuda):
    """A reduced bf16 model's loss and gradients on the card (qk-norm,
    sliding windows, a patch prefix): every attention and RMSNorm forward
    and backward is a kernel launch, no plain version runs, and every
    parameter leaf gets a finite, non-zero gradient."""
    import dataclasses
    from repro_torch import _tree
    from repro_torch.configs import get_config, reduced
    from repro_torch.models import transformer as ttfm
    from repro_torch.runtime.data import DataConfig, batch_at
    cs = _chip_smoke()
    cfg = reduced(get_config(arch), layers=2, d_model=256, heads=4,
                  kv_heads=2)
    assert cfg.head_dim == 64 and cfg.dtype == "bfloat16"
    params = ttfm.init_lm(cfg, torch.Generator(cuda).manual_seed(0), cuda)
    batch = batch_at(cfg, DataConfig(seq_len=96, global_batch=2), 0, cuda)
    flat = _tree.leaves(params)
    for p in flat:
        p.requires_grad_(True)
    counters = cs.kernel_counters()
    cs.zero_counters(counters)
    with cs.plain_version_calls() as plain:
        total, _ = ttfm.loss_fn(cfg, params, batch)
        grads = torch.autograd.grad(total, flat)
        torch.cuda.synchronize()
    launches = cs.all_launches(counters)
    assert not any(plain.values()), plain
    L = cfg.num_layers
    norms = 2 + (2 if cfg.qk_norm else 0)
    assert launches["flash_attention"] == 2 * L       # remat: recomputed
    assert launches["flash_attention_bwd"] == L
    assert launches["flash_attention_bwd_tc"] == L    # bf16: tensor cores
    assert launches["rmsnorm"] == 2 * L * norms + 1
    assert launches["rmsnorm_bwd"] == L * norms + 1
    assert torch.isfinite(total)
    for g in grads:
        assert torch.isfinite(g).all() and g.abs().max().item() > 0
