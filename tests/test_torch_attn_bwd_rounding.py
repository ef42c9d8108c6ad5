"""Why kernel row 3's tensor-core backward takes D in float32 and feeds dQ
= dS·K with dS as bf16 hi + lo, and the contract that carries it: the
training forward's LSE and output residual.

* The roundings of the backward (``csrc/flash_attention_bwd.cu``)
  simulated in float64 on bf16 inputs, keys randn + c (a component the
  keys share, as trained keys often have): D from the bf16 output lets
  dq's error grow with c past the card checks' ``GRAD_RMS_TOL`` (4e-3 in
  bf16, ``chip_smoke.py``); a float32 D with dS as hi + lo in dS·K holds
  dq at one bf16 rounding, with plain bf16 P in dV = Pᵀ·dO and plain bf16
  dS in dK = dSᵀ·Q (their sums run over query rows, which share no such
  component).  A float32 D with plain bf16 dS in dQ still breaches at c =
  4: both repairs are needed.
* The plain versions (``ref.py``) against the JAX package on the CPU: the
  forward's new outputs (LSE in base 2 against ``torch.logsumexp`` of
  the plain scores, O against the JAX attention), and the plain backward
  with the forward's LSE and residual against ``jax.grad`` of the
  reference's jnp attention, in float32 and on bf16 inputs with key
  offsets, where the backward without the residual breaches.
* The tensor-core body's host-side launch shape: the body a dtype runs,
  the shared memory a block takes, the split of a k/v head's query
  heads, and the RMSNorm backward's launch shape at every width the
  forward takes.  The kernels run only on the card
  (``tests/test_torch_cuda.py``, ``chip_smoke.py`` ``[train-kernels]``).
"""
import math
import re
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke                                               # noqa: E402

from repro.kernels.flash_attention.ref import attention_ref as j_attn  # noqa
from repro.models import attention as j_attention               # noqa: E402
from repro_torch.kernels.flash_attention import backward as fb  # noqa: E402
from repro_torch.kernels.flash_attention import ref as fref     # noqa: E402
from repro_torch.kernels.rmsnorm import backward as rb          # noqa: E402
from repro_torch.kernels.rmsnorm import kernel as rk            # noqa: E402

TOL = chip_smoke.GRAD_RMS_TOL["bfloat16"]          # 4e-3
HOLD = 2.5e-3                                      # what the design keeps


def _r16(x):
    return x.to(torch.bfloat16).double()


def _rel_rms(a, b) -> float:
    return ((a - b).square().mean().sqrt()
            / b.square().mean().sqrt()).item()


def _simulate(c: float, D_from: str, p_dv: str, ds_dk: str, ds_dq: str,
              seed: int = 0, S: int = 512, Hq: int = 8, Hkv: int = 2,
              hd: int = 128) -> dict:
    """One causal head group in float64 on bf16 inputs (keys randn + c):
    the backward with D from ``D_from`` ("bf16": the bf16 output; "f32":
    out + out_lo), P in dV and dS in dK and dQ each "exact", "bf16" or
    "hilo" (bf16 hi + lo), the outputs rounded to bf16 as the kernel
    stores them -> {"dq", "dk", "dv": error RMS over the exact
    gradient's RMS}."""
    g = torch.Generator().manual_seed(seed)
    rep, scale = Hq // Hkv, hd ** -0.5

    def randn(*shape):
        return torch.randn(*shape, generator=g, dtype=torch.float64)

    q = _r16(randn(Hq, S, hd))
    k = _r16(randn(Hkv, S, hd) + c)
    v = _r16(randn(Hkv, S, hd))
    do = _r16(randn(Hq, S, hd))
    K, V = k.repeat_interleave(rep, 0), v.repeat_interleave(rep, 0)
    s = q @ K.transpose(-1, -2) * scale
    i = torch.arange(S)
    p = torch.softmax(s.masked_fill(i[:, None] < i[None, :], -math.inf), -1)
    o = p @ V
    dp = do @ V.transpose(-1, -2)
    ds = p * (dp - (do * o).sum(-1, keepdim=True))
    exact = {"dq": scale * ds @ K, "dk": scale * ds.transpose(-1, -2) @ q,
             "dv": p.transpose(-1, -2) @ do}

    out16 = _r16(o)
    used = out16 if D_from == "bf16" else out16 + _r16(o - out16)
    ds_k = p * (dp - (do * used).sum(-1, keepdim=True))

    def rnd(x, how):
        if how == "exact":
            return x
        hi = _r16(x)
        return hi if how == "bf16" else hi + _r16(x - hi)

    got = {"dq": _r16(scale * rnd(ds_k, ds_dq) @ K),
           "dk": _r16(scale * rnd(ds_k, ds_dk).transpose(-1, -2) @ q),
           "dv": _r16(rnd(p, p_dv).transpose(-1, -2) @ do)}
    return {n: _rel_rms(got[n], exact[n]) for n in got}


@pytest.mark.parametrize("c", [2.0, 4.0])
def test_d_from_the_bf16_output_breaches_dq_when_keys_share_an_offset(c):
    """The first backward kernel's roundings: P and dS exact, D =
    rowsum(dO ⊙ bf16 out)."""
    err = _simulate(c, "bf16", "exact", "exact", "exact")
    assert err["dq"] > TOL, err
    assert err["dk"] < HOLD and err["dv"] < HOLD, err


def test_d_from_the_bf16_output_holds_zero_mean_keys():
    """The card checks' zero-mean keys hide the fault."""
    err = _simulate(0.0, "bf16", "exact", "exact", "exact")
    assert max(err.values()) < HOLD, err


@pytest.mark.parametrize("c", [0.0, 2.0, 4.0])
def test_float32_d_and_hi_lo_ds_in_dq_hold_every_offset(c):
    """The tensor-core design: D from out + out_lo, plain bf16 P in dV and
    dS in dK, dS as hi + lo in dQ."""
    err = _simulate(c, "f32", "bf16", "bf16", "hilo")
    assert max(err.values()) < HOLD, err


def test_float32_d_alone_still_breaches_with_plain_bf16_ds_in_dq():
    err = _simulate(4.0, "f32", "bf16", "bf16", "bf16")
    assert err["dq"] > TOL, err


# ---------------------------------------------------------------------------
# the plain versions' forward stats and backward against the JAX package
# ---------------------------------------------------------------------------
def _inputs(B, Sq, Skv, Hq, Hkv, hd, seed, c=0.0):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, Sq, Hq, hd)).astype(np.float32)
    k = (rng.standard_normal((B, Skv, Hkv, hd)) + c).astype(np.float32)
    v = rng.standard_normal((B, Skv, Hkv, hd)).astype(np.float32)
    g = rng.standard_normal((B, Sq, Hq, hd)).astype(np.float32)
    return q, k, v, g


@pytest.mark.parametrize("causal,window,Sq,Skv", [
    (True, 0, 40, 40), (True, 7, 40, 40), (False, 0, 24, 40)])
def test_forward_stats_match_logsumexp_and_the_jax_output(causal, window,
                                                          Sq, Skv):
    B, Hq, Hkv, hd = 2, 4, 2, 32
    q, k, v, _ = _inputs(B, Sq, Skv, Hq, Hkv, hd, seed=Sq + window)
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    out, lse, lo = fref.attention_ref(tq, tk, tv, causal=causal,
                                      window=window, stats=True)
    assert lse.shape == (B, Hq, Sq) and lse.dtype == torch.float32
    assert lo.shape == out.shape and not lo.any()     # float32: exact
    assert torch.equal(out, fref.attention_ref(tq, tk, tv, causal=causal,
                                               window=window))
    rep = Hq // Hkv
    s = (tq.transpose(1, 2) @ tk.transpose(1, 2).repeat_interleave(rep, 1)
         .transpose(-1, -2)) * hd ** -0.5
    i, j = torch.arange(Sq)[:, None], torch.arange(Skv)[None, :]
    keep = torch.ones(Sq, Skv, dtype=torch.bool)
    if causal:
        keep &= i >= j
    if window:
        keep &= (i - j) < window
    want = torch.logsumexp(s.masked_fill(~keep, -math.inf), -1) / math.log(2)
    torch.testing.assert_close(lse, want, atol=1e-5, rtol=1e-6)
    jo = j_attn(*(jnp.asarray(a.transpose(0, 2, 1, 3)) for a in (
        q, np.repeat(k, rep, 2), np.repeat(v, rep, 2))),
        causal=causal, window=window)
    np.testing.assert_allclose(out.numpy(), np.asarray(jo).transpose(
        0, 2, 1, 3), atol=2e-5, rtol=2e-5)


def test_forward_residual_carries_the_bf16_rounding():
    """bf16: out + out_lo is the float32 output to ~16 bits."""
    q, k, v, _ = _inputs(1, 64, 64, 4, 2, 64, seed=9)
    tq, tk, tv = (torch.from_numpy(a).bfloat16() for a in (q, k, v))
    out, _, lo = fref.attention_ref(tq, tk, tv, stats=True)
    o32 = fref.attention_ref(tq.float(), tk.float(), tv.float())
    err16 = _rel_rms(out.double(), o32.double())
    err32 = _rel_rms(out.double() + lo.double(), o32.double())
    assert err16 > 1e-3 and err32 < 1e-5, (err16, err32)


def _jax_grads(q, k, v, g, causal, window):
    def f(q, k, v):
        return jnp.sum(j_attention.flash_attention(
            q, k, v, causal=causal, window=window) * g)
    return [np.asarray(x) for x in jax.grad(f, argnums=(0, 1, 2))(q, k, v)]


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.sqrt(np.mean((a - b) ** 2)) / np.sqrt(np.mean(b ** 2)))


@pytest.mark.parametrize("c", [0.0, 4.0])
def test_plain_backward_with_the_forward_stats_matches_jax_on_bf16(c):
    """bf16 inputs (keys randn + c), the plain forward's stats into the
    plain backward, against jax.grad on the same bf16 values in float32,
    at GRAD_TOL / GRAD_RMS_TOL; the plain backward without the residual
    (D from the bf16 output) breaches dq at c = 4."""
    B, S, Hq, Hkv, hd = 1, 256, 8, 2, 128
    q, k, v, g = _inputs(B, S, S, Hq, Hkv, hd, seed=11, c=c)
    tq, tk, tv, tg = (torch.from_numpy(a).bfloat16() for a in (q, k, v, g))
    want = _jax_grads(*(t.float().numpy() for t in (tq, tk, tv, tg)),
                      causal=True, window=0)
    out, lse, lo = fref.attention_ref(tq, tk, tv, stats=True)
    got = fref.attention_bwd_ref(tq, tk, tv, out, tg, lse=lse, out_lo=lo)
    for name, a, b in zip("qkv", got, want):
        err, rr, ok = chip_smoke.grad_errors(a, torch.tensor(b),
                                             "bfloat16")
        assert ok, (name, err, rr)
    plain = fref.attention_bwd_ref(tq, tk, tv, out, tg)
    rr = _rel(plain[0].float().numpy(), want[0])
    assert (rr > TOL) == (c == 4.0), rr


@pytest.mark.parametrize("mask", ["causal", "window", "cross"])
def test_plain_backward_with_the_forward_stats_matches_jax_in_float32(mask):
    B, Hq, Hkv, hd = 2, 4, 2, 64
    Sq, Skv = (24, 40) if mask == "cross" else (40, 40)
    causal, window = mask != "cross", 7 if mask == "window" else 0
    q, k, v, g = _inputs(B, Sq, Skv, Hq, Hkv, hd, seed=4, c=2.0)
    want = _jax_grads(q, k, v, g, causal, window)
    tq, tk, tv, tg = (torch.from_numpy(a) for a in (q, k, v, g))
    out, lse, lo = fref.attention_ref(tq, tk, tv, causal=causal,
                                      window=window, stats=True)
    got = fref.attention_bwd_ref(tq, tk, tv, out, tg, causal=causal,
                                 window=window, lse=lse, out_lo=lo)
    for a, b in zip(got, want):
        assert _rel(a.numpy(), b) <= 1e-5
        np.testing.assert_allclose(a.numpy(), b, rtol=1e-4,
                                   atol=1e-5 * np.abs(b).max())


# ---------------------------------------------------------------------------
# host-side launch shape of the backward kernels
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("hd", fb.HEAD_DIMS)
def test_backward_body_follows_the_dtype(hd):
    """bf16 runs the tensor cores up to head_dim 128 and the CUDA cores at
    256 (recurrentgemma-9b's); float32 the CUDA cores."""
    assert fb.body_for(torch.bfloat16, hd) == (
        "tensor_cores" if hd in fb.TC_HEAD_DIMS else "cuda_cores")
    assert fb.body_for(torch.float32, hd) == "cuda_cores"
    with pytest.raises(TypeError, match="dtype"):
        fb.body_for(torch.float16, hd)


@pytest.mark.parametrize("hd", [16, 96, 512])
def test_backward_refuses_other_head_dims(hd):
    for dt in (torch.bfloat16, torch.float32):
        with pytest.raises(ValueError, match=f"head_dim {hd}"):
            fb.body_for(dt, hd)


def test_backward_cuda_core_tiles_fit_at_head_dim_256():
    """The CUDA-core body's tiles, as the source counts them
    (grad_smem: four float32 tiles of R rows x (hd + 4), the P / dS tile
    of R x 80 and two stats rows): 64-row tiles would not fit a block's
    232,448 bytes at head_dim 256, 32-row ones do."""
    def grad_smem(hd, rows):
        return 4 * (4 * rows * (hd + 4) + rows * 80 + 2 * rows)
    assert grad_smem(256, 64) > fb.SMEM_LIMIT >= grad_smem(256, 32)
    assert grad_smem(128, 64) <= fb.SMEM_LIMIT
    assert "HD > 128 ? 32 : 64" in fb.SOURCE.read_text()


def test_backward_body_codes_match_the_library():
    src = fb.SOURCE.read_text()
    pairs = set(re.findall(r"if \(dtype == (\d) && body == (\d)\)", src))
    assert pairs == {(str(fb.DTYPES[torch.float32]),
                      str(fb.BODIES["cuda_cores"])),
                     (str(fb.DTYPES[torch.bfloat16]),
                      str(fb.BODIES["cuda_cores"])),
                     (str(fb.DTYPES[torch.bfloat16]),
                      str(fb.BODIES["tensor_cores"]))}


@pytest.mark.parametrize("hd", fb.TC_HEAD_DIMS)
@pytest.mark.parametrize("kernel", ["dkdv", "dq"])
def test_backward_blocks_fit_two_to_an_sm(hd, kernel):
    """Each tensor-core block fits the H100's 232,448 bytes, and two fit
    one SM's 228 KiB with their 1 KiB reserve each (the design's
    occupancy)."""
    smem = fb.smem_bytes(hd, kernel)
    assert smem <= fb.SMEM_LIMIT
    assert 2 * (smem + 1024) <= 228 * 1024


def test_backward_split_at_the_train_shapes():
    """starcoder2-3b's 24/2 heads split 4 ways (512 blocks, the heaviest
    within a slot's mean); wider k/v groups need none."""
    split = fb.group_split
    assert split(4, 1024, 1024, 24, 2, True, 0) == 4
    assert split(4, 1024, 1024, 32, 8, True, 0) == 1
    assert split(4, 1024, 1024, 16, 8, True, 0) == 1
    assert split(2, 2048, 2048, 32, 16, True, 1024) == 1


@pytest.mark.parametrize("B,S,Hq,Hkv,causal,window", [
    (4, 1024, 24, 2, True, 0), (2, 150, 7, 1, True, 17),
    (2, 150, 16, 1, False, 40), (1, 5, 6, 2, True, 0),
    (2, 300, 12, 4, False, 0)])
def test_backward_split_divides_the_group_and_balances(B, S, Hq, Hkv, causal,
                                                       window):
    n = fb.group_split(B, S, S, Hq, Hkv, causal, window)
    rep = Hq // Hkv
    assert rep % n == 0
    tiles = fb.band_q_tiles(S, S, causal, window)
    if n < rep:
        assert max(tiles) * (rep // n) * fb.SLOTS <= B * Hq * sum(tiles)


def test_band_q_tiles_counts_the_kernels_band():
    """kv tile kt meets q tiles kt.. under a causal mask, and with a
    window only those below k_last + window."""
    assert fb.band_q_tiles(1024, 1024, True, 0) == list(range(16, 0, -1))
    assert fb.band_q_tiles(150, 150, False, 0) == [3, 3, 3]
    assert fb.band_q_tiles(2048, 2048, True, 1024)[:2] == [17, 17]
    assert fb.band_q_tiles(2048, 2048, True, 1024)[-1] == 1


def _rms_bwd_instances():
    """(threads a row, vectors a thread) pairs csrc/rmsnorm_bwd.cu has."""
    src = rb.SOURCE.read_text()
    body = src[src.index("int launch_shape("):]
    pairs = {(int(t), rb.V_GROUP) for t in
             re.findall(r"RMS_BWD_TPR\((\d+)\)", body)}
    pairs |= {(rb.THREADS, int(v)) for v in
              re.findall(r"RMS_BWD_WIDE\((\d+)\)", body)}
    return pairs


@pytest.mark.parametrize("element_size", [2, 4])
def test_rmsnorm_bwd_launch_shape_takes_every_width_the_forward_takes(
        element_size):
    """Every row width the forward kernel takes (every multiple of 16
    bytes up to its widest) gets an instance of the backward: the fewest
    threads (a power of two) that hold the row in V_GROUP vectors, or 256
    threads with up to 7; the shared memory of a block's dw partials stays
    under 48 KiB; the forward's refusals are the backward's."""
    instances = _rms_bwd_instances()
    n = 16 // element_size
    widest = rk.WIDE * rk.V_SETS[rk.WIDE][-1] * n
    for d in range(n, widest + 1, n):
        rk.launch_shape(d, element_size, 4096)      # the forward takes it
        tpr, v, nblocks = rb.launch_shape(4096, d, element_size)
        nvec = d // n
        assert (tpr, v) in instances, (d, tpr, v)
        assert tpr * v >= nvec
        assert tpr == 1 or (tpr // 2) * rb.V_GROUP < nvec
        assert 1 <= nblocks <= rb.MAX_BLOCKS
        if tpr < rb.THREADS:
            assert (rb.THREADS // tpr) * d * 4 <= 48 * 1024
    for d in (widest + n, n // 2 or 1, 0):
        with pytest.raises(ValueError):
            rk.launch_shape(d, element_size, 4096)
        with pytest.raises(ValueError):
            rb.launch_shape(4096, d, element_size)


def test_rmsnorm_bwd_launch_shape_at_the_train_shapes():
    assert rb.launch_shape(4096, 3072, 2) == (128, 4, 264)
    assert rb.launch_shape(131072, 128, 2) == (4, 4, 264)
    assert rb.launch_shape(4096, 3072, 4) == (256, 3, 264)
    assert rb.launch_shape(3, 7168, 2) == (256, 4, 3)


def test_rmsnorm_bwd_instances_are_the_ones_launch_shape_uses():
    used = set()
    for es in (2, 4):
        n = 16 // es
        for d in range(n, 14336 // (es // 2) + 1, n):
            tpr, v, _ = rb.launch_shape(4096, d, es)
            used.add((tpr, v))
    assert used == _rms_bwd_instances()
