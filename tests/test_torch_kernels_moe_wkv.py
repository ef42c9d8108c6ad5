"""The port's fused expert SwiGLU (kernel row 5) and WKV6 recurrence
(kernel row 7) on the CPU, against the JAX package: their plain PyTorch
versions (what ``ops`` runs for a CPU tensor and what the CUDA kernels
are held against on the card) and the per-head group norm.

Inputs are drawn with numpy from a seed and go through both packages.
Tolerances, with their reasons:

* MoE SwiGLU, float32: 1e-5, the reference kernel tests' figure
  (tests/test_kernels.py); both sides compute the same float32 products,
  summed in another order.  bfloat16 in, bfloat16 out: one bf16 rounding
  of the same float32 value, 1e-2 (values are below 2).  The prefill
  body's model (h through bf16 hi + lo): ``chip_smoke.py``'s MOE_TOL and
  MOE_RMS_TOL, 2e-2 elementwise and 1e-3 on the error's RMS over the
  output's.
* WKV6, float32: 2e-5 on y and on the state.  The same per-step float32
  ops as ``wkv6_scan``, whose einsum sums in another order; the
  reference's own kernel bound is 2e-4 (tests/test_kernels.py), which
  the Pallas kernel (run in interpret mode) is held to here too.
* Group norm: 1e-6 in float32 (mean and variance in another order); one
  bf16 rounding in bfloat16.
"""
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.kernels.moe_gemm.kernel import moe_swiglu_tpu             # noqa
from repro.kernels.moe_gemm.ref import moe_swiglu_ref as j_moe_ref   # noqa
from repro.kernels.wkv6.kernel import wkv6_tpu                       # noqa
from repro.kernels.wkv6.ref import wkv6_ref as j_wkv6_ref            # noqa
from repro.models import layers as j_layers                          # noqa
from repro.models.rwkv import wkv6_scan                              # noqa
from repro_torch.kernels import _build                              # noqa
from repro_torch.kernels.moe_gemm import kernel as k_moe             # noqa
from repro_torch.kernels.moe_gemm import ops as t_moe                # noqa
from repro_torch.kernels.moe_gemm.ref import (moe_swiglu_ref,        # noqa
                                              moe_swiglu_split_ref)
from repro_torch.kernels.wkv6 import ops as t_wkv                    # noqa
from repro_torch.kernels.wkv6.ref import wkv6_ref                    # noqa
from repro_torch.models import layers as t_layers                    # noqa

from torch_diff import np_of                                         # noqa

MOE_TOL = 1e-5
WKV_TOL = 2e-5
WKV_PALLAS_TOL = 2e-4


def _moe_inputs(E, C, d, ff, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((E, C, d)).astype(np.float32) * 0.5
    wg, wu = (rng.standard_normal((E, d, ff)).astype(np.float32) * 0.1
              for _ in range(2))
    wd = rng.standard_normal((E, ff, d)).astype(np.float32) * 0.1
    return x, wg, wu, wd


# ---------------------------------------------------------------------------
# fused expert SwiGLU
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("E,C,d,ff,c_block,ff_block", [
    (2, 32, 16, 32, 128, 256),
    (4, 64, 32, 64, 128, 256),
    (3, 20, 16, 40, 8, 16),          # ragged C and ragged ff tail
    (4, 4, 64, 128, 128, 256),       # decode-sized capacity
])
def test_moe_swiglu_matches_reference_and_pallas(E, C, d, ff, c_block,
                                                 ff_block):
    ins = _moe_inputs(E, C, d, ff)
    got = np_of(t_moe.moe_swiglu(*(torch.from_numpy(a) for a in ins)))
    want = np.asarray(j_moe_ref(*(jnp.asarray(a) for a in ins)))
    pallas = np.asarray(moe_swiglu_tpu(*(jnp.asarray(a) for a in ins),
                                       c_block=c_block, ff_block=ff_block,
                                       interpret=True))
    np.testing.assert_allclose(got, want, atol=MOE_TOL, rtol=MOE_TOL)
    np.testing.assert_allclose(got, pallas, atol=MOE_TOL, rtol=MOE_TOL)


def test_moe_swiglu_bf16_rounds_once():
    ins = _moe_inputs(2, 12, 32, 48, seed=1)
    tb = [torch.from_numpy(a).to(torch.bfloat16) for a in ins]
    got = t_moe.moe_swiglu(*tb)
    assert got.dtype == torch.bfloat16
    want = np.asarray(j_moe_ref(*(jnp.asarray(np_of(t.float()),
                                              jnp.bfloat16) for t in tb)),
                      np.float32)
    np.testing.assert_allclose(np_of(got.float()), want, atol=1e-2,
                               rtol=1e-2)
    torch.testing.assert_close(got, moe_swiglu_ref(*tb), atol=0, rtol=0)


@pytest.mark.parametrize("E,C,d,ff", [
    (4, 160, 128, 64),              # granite's proportions, cut
    (2, 37, 64, 1000 // 8),         # ragged C; ff a multiple of 8 only
    (3, 300, 96, 40)])
def test_moe_split_model_holds_the_bf16_contract(E, C, d, ff):
    """The wgmma body's two-kernel split (h written as bf16 hi + lo and
    read back) against the float32-h plain version, on bf16 inputs at
    the card's tolerances; h rounded to bf16 alone is measurably worse
    in RMS."""
    rng = np.random.default_rng(E * C)
    x = torch.from_numpy(rng.standard_normal((E, C, d)).astype(np.float32))
    wg, wu = (torch.from_numpy(
        (rng.standard_normal((E, d, ff)) * d ** -0.5).astype(np.float32))
        for _ in range(2))
    wd = torch.from_numpy((rng.standard_normal((E, ff, d))
                           * ff ** -0.5).astype(np.float32))
    xb, gb, ub, db = (t.to(torch.bfloat16) for t in (x, wg, wu, wd))
    want = moe_swiglu_ref(xb, gb, ub, db).float()
    got = moe_swiglu_split_ref(xb, gb, ub, db)
    assert got.dtype == torch.bfloat16
    got = got.float()
    torch.testing.assert_close(got, want, atol=2e-2, rtol=2e-2)
    rms = lambda t: t.square().mean().sqrt().item()            # noqa: E731
    assert rms(got - want) <= 1e-3 * rms(want)
    # before the output's rounding, hi + lo stays far closer to float32 h
    # than hi alone
    x32 = xb.float()
    h = torch.nn.functional.silu(torch.bmm(x32, gb.float())) \
        * torch.bmm(x32, ub.float())
    hi = h.to(torch.bfloat16).float()
    lo = (h - hi).to(torch.bfloat16).float()
    y32 = torch.bmm(h, db.float())
    err_split = rms(torch.bmm(hi, db.float()) + torch.bmm(lo, db.float())
                    - y32)
    assert err_split < 0.1 * rms(torch.bmm(hi, db.float()) - y32)


def test_moe_body_plan():
    """bfloat16 prefill shapes (C above 16) take the wgmma body, decode
    (C 2-16) the mma.sync body, float32 and shapes neither takes the
    CUDA-core one; each body has its own launch counter."""
    bf, f32 = torch.bfloat16, torch.float32
    assert k_moe.DECODE_C == 16
    for C in (17, 37, 40, 320, 1280):                # engine + prefill
        assert k_moe.body_for(bf, C, 1024, 512) == "wgmma"
    assert k_moe.body_for(bf, 37, 1024, 1408) == "wgmma"
    assert k_moe.body_for(bf, 37, 1024, 1000) == "wgmma"
    assert k_moe.body_for(bf, 300, 2048, 1408) == "wgmma"
    for C in (2, 4, 16):                             # decode
        assert k_moe.body_for(bf, C, 1024, 512) == "mma"
    assert k_moe.body_for(bf, 4, 2048, 512) == "mma"    # d up to 2048
    for C in (1, 4, 16):                             # moonshot decode
        assert k_moe.body_for(bf, C, 2048, 1408) == "mma"
    assert k_moe.body_for(bf, 4, 2176, 512) == "cuda_cores"   # d > 2048
    assert k_moe.body_for(bf, 4, 64, 40) == "cuda_cores"      # d % 128
    assert k_moe.body_for(bf, 100, 1024, 100) == "cuda_cores"  # ff % 8
    for C in (4, 1280):
        assert k_moe.body_for(f32, C, 1024, 512) == "cuda_cores"
    assert set(k_moe.LAUNCHES) == {"moe_swiglu"} | {
        "moe_swiglu_" + b for b in k_moe.BODIES}


def test_library_name_hashes_the_shared_header(tmp_path, monkeypatch):
    """A source's library name covers the local headers it includes,
    followed recursively, so editing ``common/csrc/hopper.cuh`` rebuilds
    every library that uses it (attention's two through
    ``attention_tc.cuh``, the expert SwiGLU's two through
    ``moe_tc.cuh``)."""
    from repro_torch.kernels.flash_attention import backward as k_fa_bwd
    from repro_torch.kernels.flash_attention import kernel as k_fa
    from repro_torch.kernels.moe_gemm import backward as k_moe_bwd
    hdr = (_build.Path(k_fa.SOURCE).parents[2] / "common" / "csrc"
           / "hopper.cuh").resolve()
    attn_hdr = (_build.Path(k_fa.SOURCE).parent / "attention_tc.cuh") \
        .resolve()
    moe_hdr = (_build.Path(k_moe.SOURCE).parent / "moe_tc.cuh").resolve()
    assert _build.local_includes(k_fa.SOURCE) == [attn_hdr, hdr]
    assert _build.local_includes(k_fa_bwd.SOURCE) == [attn_hdr, hdr]
    assert _build.local_includes(k_moe.SOURCE) == [moe_hdr, hdr]
    assert _build.local_includes(k_moe_bwd.SOURCE) == [moe_hdr, hdr]
    src = tmp_path / "a" / "k.cu"
    src.parent.mkdir()
    inc = tmp_path / "h.cuh"
    inc.write_text('#include "g.cuh"\n')
    (tmp_path / "g.cuh").write_text("int g;\n")
    src.write_text('#include <cuda.h>\n#include "../h.cuh"\n')
    monkeypatch.setattr(_build, "nvcc_path", lambda: "/bin/nvcc")
    before = _build.library_path("k", src)
    (tmp_path / "g.cuh").write_text("int g2;\n")
    assert _build.library_path("k", src) != before


@pytest.mark.parametrize("bad", ["rank", "wg", "wd"])
def test_moe_swiglu_refuses_bad_shapes(bad):
    x, wg, wu, wd = (torch.from_numpy(a) for a in _moe_inputs(2, 4, 8, 16))
    if bad == "rank":
        x = x[0]
    elif bad == "wg":
        wg = wg[:, :4]
    else:
        wd = wd.transpose(1, 2)
    with pytest.raises(ValueError, match="moe_swiglu"):
        t_moe.moe_swiglu(x, wg, wu, wd)


# ---------------------------------------------------------------------------
# WKV6
# ---------------------------------------------------------------------------
def _wkv_inputs(B, S, H, n, seed=0, state=True):
    rng = np.random.default_rng(seed)
    r, k, v = (rng.standard_normal((B, S, H, n)).astype(np.float32)
               for _ in range(3))
    w = rng.uniform(0.3, 0.95, (B, S, H, n)).astype(np.float32)
    u = rng.standard_normal((H, n)).astype(np.float32)
    s0 = (rng.standard_normal((B, H, n, n)).astype(np.float32) * 0.5
          if state else None)
    return r, k, v, w, u, s0


def _t(a):
    return None if a is None else torch.from_numpy(a)


@pytest.mark.parametrize("B,S,H,n,state", [
    (1, 32, 1, 16, False), (2, 24, 2, 16, True), (1, 17, 2, 32, True),
    (3, 1, 2, 8, True)])
def test_wkv6_matches_model_scan(B, S, H, n, state):
    ins = _wkv_inputs(B, S, H, n, state=state)
    y, s = t_wkv.wkv6(*(_t(a) for a in ins))
    jy, js = wkv6_scan(*(None if a is None else jnp.asarray(a)
                         for a in ins))
    assert y.dtype == s.dtype == torch.float32
    np.testing.assert_allclose(np_of(y), np.asarray(jy), atol=WKV_TOL,
                               rtol=WKV_TOL)
    np.testing.assert_allclose(np_of(s), np.asarray(js), atol=WKV_TOL,
                               rtol=WKV_TOL)


def test_wkv6_two_halves_with_carried_state_equal_one_run():
    r, k, v, w, u, s0 = (_t(a) for a in _wkv_inputs(2, 30, 2, 16, seed=3))
    y, s = wkv6_ref(r, k, v, w, u, s0)
    y1, s1 = wkv6_ref(r[:, :13], k[:, :13], v[:, :13], w[:, :13], u, s0)
    y2, s2 = wkv6_ref(r[:, 13:], k[:, 13:], v[:, 13:], w[:, 13:], u, s1)
    torch.testing.assert_close(torch.cat([y1, y2], dim=1), y, atol=0,
                               rtol=0)
    torch.testing.assert_close(s2, s, atol=0, rtol=0)


@pytest.mark.parametrize("B,H,S,n,chunk", [(1, 1, 32, 16, 16),
                                           (2, 2, 48, 32, 16)])
def test_wkv6_matches_head_major_reference_and_pallas(B, H, S, n, chunk):
    """From a zero state, the model layout transposed to the reference
    kernel's head-major (B, H, S, n) one."""
    r, k, v, w, u, _ = _wkv_inputs(B, S, H, n, seed=4, state=False)
    y, _ = t_wkv.wkv6(*(_t(a) for a in (r, k, v, w, u)))
    hm = [jnp.asarray(a.transpose(0, 2, 1, 3)) for a in (r, k, v, w)]
    want = np.asarray(j_wkv6_ref(*hm, jnp.asarray(u))).transpose(0, 2, 1, 3)
    pallas = np.asarray(wkv6_tpu(*hm, jnp.asarray(u), chunk=chunk,
                                 interpret=True)).transpose(0, 2, 1, 3)
    np.testing.assert_allclose(np_of(y), want, atol=WKV_TOL, rtol=WKV_TOL)
    np.testing.assert_allclose(np_of(y), pallas, atol=WKV_PALLAS_TOL,
                               rtol=WKV_PALLAS_TOL)


def test_wkv6_state_out_may_alias_s0():
    """Decode passes the cache's own state as s0 and as the output: the
    result equals a run into a fresh tensor, and lands in that tensor."""
    r, k, v, w, u, s0 = (_t(a) for a in _wkv_inputs(3, 1, 2, 16, seed=5))
    want_y, want_s = t_wkv.wkv6(r, k, v, w, u, s0.clone())
    state = s0.clone()
    y, s = t_wkv.wkv6(r, k, v, w, u, state, state_out=state)
    assert s is state
    torch.testing.assert_close(y, want_y, atol=0, rtol=0)
    torch.testing.assert_close(state, want_s, atol=0, rtol=0)


def test_wkv6_bf16_inputs_are_read_as_float32():
    r, k, v, w, u, s0 = (_t(a) for a in _wkv_inputs(1, 9, 2, 16, seed=6))
    rb, kb, vb = (t.to(torch.bfloat16) for t in (r, k, v))
    y, s = t_wkv.wkv6(rb, kb, vb, w, u, s0)
    y32, s32 = t_wkv.wkv6(rb.float(), kb.float(), vb.float(), w, u, s0)
    assert y.dtype == torch.float32
    torch.testing.assert_close(y, y32, atol=0, rtol=0)
    torch.testing.assert_close(s, s32, atol=0, rtol=0)


@pytest.mark.parametrize("bad", ["k", "u", "s0"])
def test_wkv6_refuses_bad_shapes(bad):
    r, k, v, w, u, s0 = (_t(a) for a in _wkv_inputs(1, 4, 2, 8))
    if bad == "k":
        k = k[:, :3]
    elif bad == "u":
        u = u[:1]
    else:
        s0 = s0[:, :, :4]
    with pytest.raises(ValueError, match="wkv6"):
        t_wkv.wkv6(r, k, v, w, u, s0)


# ---------------------------------------------------------------------------
# group norm over heads (RWKV-6 ln_x)
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_group_norm_heads_matches_reference(dtype):
    rng = np.random.default_rng(7)
    x = rng.standard_normal((2, 5, 3, 16)).astype(np.float32) * 3 + 1
    w = rng.standard_normal((3, 16)).astype(np.float32)
    tdt = getattr(torch, dtype)
    got = t_layers.group_norm_heads(torch.from_numpy(x).to(tdt),
                                    torch.from_numpy(w))
    assert got.dtype == tdt
    want = j_layers.group_norm_heads(
        jnp.asarray(np_of(torch.from_numpy(x).to(tdt).float()),
                    getattr(jnp, dtype)), jnp.asarray(w))
    tol = 1e-6 if dtype == "float32" else 2e-2
    np.testing.assert_allclose(np_of(got.float()),
                               np.asarray(want, np.float32), atol=tol,
                               rtol=tol)


# ---------------------------------------------------------------------------
# chip_smoke.py's build report: instance names, spills, wgmma serialisation
# ---------------------------------------------------------------------------
def _chip_smoke():
    import importlib
    import sys
    from pathlib import Path
    root = str(Path(__file__).resolve().parents[1])
    if root not in sys.path:
        sys.path.insert(0, root)
    return importlib.import_module("chip_smoke")


@pytest.mark.parametrize("mangled,label", [
    ("_ZN46_GLOBAL__N__4ae306ff_13_moe_swiglu_cu_fe11f9479hopper_tc14"
     "gate_up_kernelE14CUtensorMap_stS1_S1_P13__nv_bfloat16S3_iiii",
     "gate_up_kernel"),
    ("_ZN39_GLOBAL__N__910ce58b_7_wkv6_cu_a79acc7311wkv6_kernelI13__nv_"
     "bfloat16Li64EEEvPKT_S4_S4_PKfS6_S6_PfS7_ii", "wkv6_kernel<bf16,64>"),
    ("_ZN12_GLOBAL__N_17chunked16chunk_out_kernelIfLi64EEEvPKT_",
     "chunk_out_kernel<f32,64>"),
    ("_ZN12_GLOBAL__N_12tc25flash_attention_tc_kernelILi128EEEvv",
     "flash_attention_tc_kernel<128>"),
    ("not_a_kernel_name", "not_a_kernel_name")])
def test_chip_smoke_kernel_label(mangled, label):
    assert _chip_smoke().kernel_label(mangled) == label


def test_chip_smoke_ptxas_report_and_body_of():
    cs = _chip_smoke()
    a = "_ZN12_GLOBAL__N_19hopper_tc11down_kernelEv"
    b = "_ZN12_GLOBAL__N_17chunked16chunk_out_kernelIfLi64EEEvv"
    log = "\n".join([
        f"ptxas info    : Compiling entry function '{a}' for 'sm_90a'",
        "ptxas info    : Used 154 registers, 1024 bytes smem",
        f"ptxas info    : (C7511) Potential Performance Loss: wgmma.mma_async"
        f" instructions are serialized in the function '{a}'",
        f"ptxas info    : Compiling entry function '{b}' for 'sm_90a'",
        "    8 bytes stack frame, 4 bytes spill stores, 4 bytes spill loads",
        "ptxas info    : Used 64 registers"])
    down, out = cs.ptxas_instances(log)
    assert down == dict(name="down_kernel", registers=154, spill_bytes=0,
                        smem_bytes=1024, wgmma_serialized=True)
    assert out == dict(name="chunk_out_kernel<f32,64>", registers=64,
                       spill_bytes=8, smem_bytes=0, wgmma_serialized=False)
    before = {"wkv6": 0, "wkv6_serial": 2, "wkv6_chunked": 5}
    after = {"wkv6": 1, "wkv6_serial": 2, "wkv6_chunked": 6}
    assert cs.body_of(after, before, "wkv6_") == "chunked"
    with pytest.raises(AssertionError, match="exactly one"):
        cs.body_of(before, before, "wkv6_")
