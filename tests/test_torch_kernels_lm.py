"""The plain PyTorch versions of the port's language-model kernels —
RMSNorm (kernel row 4) and flash attention (row 3) — against the JAX
package's Pallas kernels run in interpret mode and their jnp oracles, on
the same numpy inputs and at the shapes of ``tests/test_kernels.py``;
plus the model-level primitives around them (``models/layers.py``,
``models/attention.py``) against their reference counterparts.

Tolerances are the reference tests' own: RMSNorm 1e-5 in float32 and
5e-2 in bfloat16 (one bf16 rounding of the output); attention 2e-5 in
float32 and 3e-2 in bfloat16.  The primitives in float32 are held to
1e-5 (sums in another order, and XLA's and ATen's sin/cos/pow differ by
ulps)."""
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.kernels.flash_attention.kernel import flash_attention_tpu  # noqa
from repro.kernels.flash_attention.ref import attention_ref as j_attn  # noqa
from repro.kernels.rmsnorm.kernel import rmsnorm_tpu                  # noqa
from repro.models import attention as j_attention                     # noqa
from repro.models import layers as j_layers                           # noqa
from repro_torch.kernels.flash_attention import ops as t_flash        # noqa
from repro_torch.kernels.flash_attention.ref import attention_ref     # noqa
from repro_torch.kernels.rmsnorm import ops as t_rms                  # noqa
from repro_torch.kernels.rmsnorm.ref import rmsnorm_ref               # noqa
from repro_torch.models import attention as t_attention               # noqa
from repro_torch.models import layers as t_layers                     # noqa

from torch_diff import np_of                                          # noqa


def _both(a: np.ndarray, bf16: bool = False):
    """The same values as a jax array and a CPU torch tensor (bf16: each
    rounds the float32 values to nearest even)."""
    j = jnp.asarray(a, jnp.bfloat16 if bf16 else jnp.float32)
    t = torch.from_numpy(np.asarray(a, np.float32))
    return j, (t.to(torch.bfloat16) if bf16 else t)


def _f32(t: "torch.Tensor") -> np.ndarray:
    return np_of(t.float())


# ---------------------------------------------------------------------------
# RMSNorm (row 4)
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("rows,d", [(8, 128), (128, 512), (64, 384)])
@pytest.mark.parametrize("bf16", [False, True])
def test_rmsnorm_matches_pallas_interpret(rows, d, bf16):
    rng = np.random.default_rng(rows + d)
    (jx, tx), (jw, tw) = (_both(rng.standard_normal((rows, d)), bf16),
                          _both(rng.standard_normal(d), bf16))
    ref = rmsnorm_tpu(jx, jw, interpret=True)
    out = t_rms.rmsnorm(tx, tw)
    assert out.dtype == tx.dtype and out.shape == tx.shape
    tol = 5e-2 if bf16 else 1e-5
    np.testing.assert_allclose(_f32(out), np.asarray(ref, np.float32),
                               atol=tol, rtol=tol)


def test_rmsnorm_uses_one_plus_w():
    """Norm weights start at zero in both packages, so a wrong (w vs 1+w)
    convention would pass a test on fresh weights: pin it directly."""
    x = torch.randn(4, 64, generator=torch.Generator().manual_seed(0))
    w = torch.full((64,), 0.5)
    base = rmsnorm_ref(x, torch.zeros(64))
    torch.testing.assert_close(rmsnorm_ref(x, w), base * 1.5)
    torch.testing.assert_close(t_layers.rms_norm(x, w, 1e-6), base * 1.5)


@pytest.mark.parametrize("shape", [(2, 5, 32), (3, 4, 2, 16)])
def test_rms_norm_layer_matches_reference(shape):
    rng = np.random.default_rng(1)
    (jx, tx), (jw, tw) = (_both(rng.standard_normal(shape)),
                          _both(rng.standard_normal(shape[-1])))
    np.testing.assert_allclose(np_of(t_layers.rms_norm(tx, tw, 1e-6)),
                               np.asarray(j_layers.rms_norm(jx, jw, 1e-6)),
                               atol=1e-5, rtol=1e-5)


# ---------------------------------------------------------------------------
# Flash attention (row 3)
# ---------------------------------------------------------------------------
def _attn_inputs(B, Hq, Hkv, Sq, Skv, hd, seed=0, bf16=False):
    """Head-major numpy inputs for the reference, model-layout tensors
    for the port."""
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, Hq, Sq, hd))
    k = rng.standard_normal((B, Hkv, Skv, hd))
    v = rng.standard_normal((B, Hkv, Skv, hd))
    pairs = [_both(a, bf16) for a in (q, k, v)]
    jq, jk, jv = (p[0] for p in pairs)
    tq, tk, tv = (p[1].transpose(1, 2).contiguous() for p in pairs)
    return (jq, jk, jv), (tq, tk, tv)


def _port_head_major(out):
    return _f32(out.transpose(1, 2))


@pytest.mark.parametrize("B,Hq,Hkv,S,hd", [
    (1, 2, 2, 128, 64),
    (2, 4, 2, 256, 64),     # GQA 2:1
    (1, 8, 1, 256, 32),     # MQA
    (2, 2, 2, 96, 64),      # ragged: S not a multiple of the block
])
@pytest.mark.parametrize("causal", [True, False])
def test_attention_matches_pallas_interpret(B, Hq, Hkv, S, hd, causal):
    (jq, jk, jv), (tq, tk, tv) = _attn_inputs(B, Hq, Hkv, S, S, hd)
    out = t_flash.flash_attention(tq, tk, tv, causal=causal)
    rep = Hq // Hkv
    ref = j_attn(jq, jnp.repeat(jk, rep, 1), jnp.repeat(jv, rep, 1),
                 causal=causal)
    np.testing.assert_allclose(_port_head_major(out), np.asarray(ref),
                               atol=2e-5, rtol=2e-5)
    if (B, Hq, S) == (1, 2, 128):       # one interpret-mode run per mask
        pal = flash_attention_tpu(jq, jk, jv, causal=causal, q_block=64,
                                  kv_block=64, interpret=True)
        np.testing.assert_allclose(_port_head_major(out), np.asarray(pal),
                                   atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize("window", [32, 64])
def test_attention_sliding_window(window):
    (jq, jk, jv), (tq, tk, tv) = _attn_inputs(1, 2, 2, 192, 192, 32)
    out = t_flash.flash_attention(tq, tk, tv, causal=True, window=window)
    pal = flash_attention_tpu(jq, jk, jv, causal=True, window=window,
                              q_block=64, kv_block=64, interpret=True)
    ref = j_attn(jq, jk, jv, causal=True, window=window)
    np.testing.assert_allclose(_port_head_major(out), np.asarray(pal),
                               atol=2e-5, rtol=2e-5)
    np.testing.assert_allclose(_port_head_major(out), np.asarray(ref),
                               atol=2e-5, rtol=2e-5)


def test_attention_bf16():
    (jq, jk, jv), (tq, tk, tv) = _attn_inputs(1, 2, 2, 128, 128, 64,
                                              bf16=True)
    out = t_flash.flash_attention(tq, tk, tv, causal=True)
    assert out.dtype == torch.bfloat16
    pal = flash_attention_tpu(jq, jk, jv, causal=True, q_block=64,
                              kv_block=64, interpret=True)
    ref = j_attn(jq.astype(jnp.float32), jk.astype(jnp.float32),
                 jv.astype(jnp.float32), causal=True)
    for want in (pal, ref):
        np.testing.assert_allclose(_port_head_major(out),
                                   np.asarray(want, np.float32),
                                   atol=3e-2, rtol=3e-2)


def test_attention_noncausal_cross_lengths():
    """Non-causal attention may have Sq != Skv (cross attention)."""
    (jq, jk, jv), (tq, tk, tv) = _attn_inputs(1, 4, 2, 40, 72, 32, seed=3)
    out = t_flash.flash_attention(tq, tk, tv, causal=False, window=0)
    ref = j_attn(jq, jnp.repeat(jk, 2, 1), jnp.repeat(jv, 2, 1),
                 causal=False)
    np.testing.assert_allclose(_port_head_major(out), np.asarray(ref),
                               atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize("bad", ["causal_lengths", "heads", "window",
                                 "rank"])
def test_attention_refuses_bad_inputs(bad):
    _, (tq, tk, tv) = _attn_inputs(1, 4, 2, 16, 16, 32)
    kw = dict(causal=True, window=0)
    if bad == "causal_lengths":
        # the kernel aligns q 0 with k 0; naive_attention aligns the ends
        tk, tv = tk[:, :12].contiguous(), tv[:, :12].contiguous()
    elif bad == "heads":
        tk, tv = (torch.cat([t, t[:, :, :1]], 2) for t in (tk, tv))
    elif bad == "window":
        kw["window"] = -1
    else:
        tq = tq[0]
    with pytest.raises(ValueError):
        t_flash.flash_attention(tq, tk, tv, **kw)


def test_attention_ref_is_the_kernel_contract():
    """The plain version equals the model-level naive attention whenever
    Sq == Skv (the only way prefill calls it)."""
    _, (tq, tk, tv) = _attn_inputs(2, 6, 2, 33, 33, 16, seed=5)
    for window in (0, 7):
        torch.testing.assert_close(
            attention_ref(tq, tk, tv, causal=True, window=window),
            t_attention.naive_attention(tq, tk, tv, causal=True,
                                        window=window),
            atol=2e-6, rtol=2e-5)


# ---------------------------------------------------------------------------
# Model-level primitives
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("Sq,Skv,causal,window", [
    (8, 8, True, 0), (3, 11, True, 0), (5, 9, False, 0), (8, 8, True, 3)])
def test_naive_attention_matches_reference(Sq, Skv, causal, window):
    rng = np.random.default_rng(Sq * Skv)
    (jq, tq), (jk, tk), (jv, tv) = (
        _both(rng.standard_normal(s)) for s in
        ((2, Sq, 4, 16), (2, Skv, 2, 16), (2, Skv, 2, 16)))
    out = t_attention.naive_attention(tq, tk, tv, causal=causal,
                                      window=window)
    ref = j_attention.naive_attention(jq, jk, jv, causal=causal,
                                      window=window)
    np.testing.assert_allclose(np_of(out), np.asarray(ref), atol=1e-5,
                               rtol=1e-5)


@pytest.mark.parametrize("vector_pos", [False, True])
def test_decode_attention_matches_reference(vector_pos):
    rng = np.random.default_rng(7)
    (jq, tq), (jk, tk), (jv, tv) = (
        _both(rng.standard_normal(s)) for s in
        ((3, 1, 6, 16), (3, 20, 2, 16), (3, 20, 2, 16)))
    pos = np.asarray([4, 11, 19]) if vector_pos else 9
    out = t_attention.decode_attention(tq, tk, tv, torch.as_tensor(pos))
    ref = j_attention.decode_attention(jq, jk, jv, jnp.asarray(pos))
    np.testing.assert_allclose(np_of(out), np.asarray(ref), atol=1e-5,
                               rtol=1e-5)


@pytest.mark.parametrize("pos_shape", ["batch", "shared"])
def test_rope_matches_reference(pos_shape):
    rng = np.random.default_rng(2)
    jx, tx = _both(rng.standard_normal((2, 7, 3, 16)) * 3)
    pos = (rng.integers(0, 900, (2, 7)) if pos_shape == "batch"
           else np.arange(7))
    out = t_layers.apply_rope(tx, torch.as_tensor(pos), 100_000.0)
    ref = j_layers.apply_rope(jx, jnp.asarray(pos), 100_000.0)
    np.testing.assert_allclose(np_of(out), np.asarray(ref), atol=1e-4,
                               rtol=1e-5)


def test_mlp_matches_reference():
    rng = np.random.default_rng(4)
    jx, tx = _both(rng.standard_normal((2, 5, 32)))
    w = {"wg": rng.standard_normal((32, 48)) / 6,
         "wu": rng.standard_normal((32, 48)) / 6,
         "wd": rng.standard_normal((48, 32)) / 7}
    jp = {k: jnp.asarray(v, jnp.float32) for k, v in w.items()}
    tp = {k: torch.from_numpy(v.astype(np.float32)) for k, v in w.items()}
    np.testing.assert_allclose(np_of(t_layers.apply_mlp(tp, tx)),
                               np.asarray(j_layers.apply_mlp(jp, jx)),
                               atol=1e-5, rtol=1e-5)


# ---------------------------------------------------------------------------
# Host logic of the CUDA wrappers (rows 3 and 4): which attention body a
# dtype runs, and the RMSNorm launch shape each width gets.  The kernels
# themselves run only on the card (tests/test_torch_cuda.py).
# ---------------------------------------------------------------------------
import re                                                             # noqa: E402

from repro_torch.configs import ARCH_IDS, get_config                  # noqa: E402
from repro_torch.kernels.flash_attention import kernel as t_flash_k   # noqa: E402
from repro_torch.kernels.rmsnorm import kernel as t_rms_k             # noqa: E402

#: every d_model of the registry's transformers, and the qk-norm's head_dim
_WIDTHS = sorted({get_config(a).d_model for a in ARCH_IDS} | {128})


@pytest.mark.parametrize("hd", t_flash_k.HEAD_DIMS)
def test_attention_body_follows_the_dtype(hd):
    assert t_flash_k.body_for(torch.bfloat16, hd) == "tensor_cores"
    assert t_flash_k.body_for(torch.float32, hd) == "cuda_cores"
    with pytest.raises(TypeError, match="dtype"):
        t_flash_k.body_for(torch.float16, hd)


@pytest.mark.parametrize("hd", [16, 48, 96, 512])
def test_attention_body_refuses_other_head_dims(hd):
    for dt in (torch.bfloat16, torch.float32):
        with pytest.raises(ValueError, match="head_dim"):
            t_flash_k.body_for(dt, hd)


def test_attention_body_codes_match_the_library():
    """The wrapper's (dtype, body) codes are the only pairings the
    library's C entry point takes."""
    src = t_flash_k.SOURCE.read_text()
    pairs = set(re.findall(r"if \(dtype == (\d) && body == (\d)\)", src))
    assert pairs == {(str(t_flash_k.DTYPES[torch.float32]),
                      str(t_flash_k.BODIES["cuda_cores"])),
                     (str(t_flash_k.DTYPES[torch.bfloat16]),
                      str(t_flash_k.BODIES["tensor_cores"]))}


def test_flash_attention_cpu_tensor_never_counts_a_launch():
    q = torch.randn(1, 8, 4, 32, dtype=torch.bfloat16)
    before = dict(t_flash_k.LAUNCHES)
    t_flash.flash_attention(q, q[:, :, :2], q[:, :, 2:])
    assert t_flash_k.LAUNCHES == before


@pytest.mark.parametrize("d", _WIDTHS)
@pytest.mark.parametrize("element_size", [2, 4])
@pytest.mark.parametrize("rows", [1, 4, 127, 128, 4096])
def test_rmsnorm_launch_shape_covers_every_width(d, element_size, rows):
    tpr, v = t_rms_k.launch_shape(d, element_size, rows)
    nvec = d * element_size // 16
    assert tpr * v >= nvec
    if nvec <= t_rms_k.WARP:                 # one vector a thread
        assert v == 1 and tpr >= nvec and tpr & (tpr - 1) == 0
        assert tpr == 1 or tpr // 2 < nvec
        return
    # the fewest vectors in the thread count's set that cover the row
    assert v in t_rms_k.V_SETS[tpr]
    assert all(tpr * u < nvec for u in t_rms_k.V_SETS[tpr] if u < v)
    if rows < t_rms_k.FEW_ROWS:              # decode: a block a row
        assert tpr == t_rms_k.WIDE
    elif nvec <= t_rms_k.WARP * t_rms_k.V_MAX_WARP:
        assert tpr == t_rms_k.WARP
    else:
        assert tpr == t_rms_k.WIDE


def test_rmsnorm_launch_shape_at_the_serving_widths():
    """starcoder2-3b's prefill rows get a warp each (12 vectors a lane);
    recurrentgemma-9b's d 4096 and decode's few rows a block each."""
    shape = t_rms_k.launch_shape
    assert shape(3072, 2, 4096) == (32, 12)
    assert shape(1024, 2, 4096) == (32, 4)
    assert shape(4096, 2, 10240) == (256, 2)
    assert shape(3072, 2, 4) == (256, 2)
    assert shape(128, 2, 4096 * 32) == (16, 1)


def test_rmsnorm_instances_are_the_registry_widths_shapes():
    """The library holds, at a warp and at 256 threads a row, exactly the
    vector counts launch_shape gives the registry's widths, in both types
    and at both prefill and decode row counts: no instance that no model
    launches."""
    used = {t_rms_k.WARP: set(), t_rms_k.WIDE: set()}
    for d in _WIDTHS:
        for size in (2, 4):
            for rows in (1, 4096):
                tpr, v = t_rms_k.launch_shape(d, size, rows)
                used.setdefault(tpr, set()).add(v)
    for tpr, vs in t_rms_k.V_SETS.items():
        assert used[tpr] == set(vs), tpr


def test_rmsnorm_launch_shapes_are_kernel_instances():
    """V_SETS lists the instances launch_v() in csrc/rmsnorm.cu has at 32
    and 256 threads a row, and launch_tpr() takes every thread count
    launch_shape can return."""
    src = t_rms_k.SOURCE.read_text()
    body = src[src.index("int launch_v("):src.index("int launch_tpr(")]
    warp = body[body.index("TPR == 32"):body.index("} else {")]
    wide = body[body.index("} else {"):]
    for tpr, part in ((t_rms_k.WARP, warp), (t_rms_k.WIDE, wide)):
        assert tuple(int(v) for v in re.findall(r"RMS_CASE\((\d+)\)",
                                                part)) == \
            t_rms_k.V_SETS[tpr], tpr
    for tpr in (1, 2, 4, 8, 16, t_rms_k.WARP, t_rms_k.WIDE):
        assert f"case {tpr}: return launch_v<T, {tpr}>" in src


@pytest.mark.parametrize("d,element_size", [(100, 2), (6, 4), (0, 2),
                                            (32768 + 8, 2), (16384 + 4, 4),
                                            (14336 + 8, 2), (7168 + 4, 4)])
def test_rmsnorm_launch_shape_refuses(d, element_size):
    with pytest.raises(ValueError, match="rmsnorm"):
        t_rms_k.launch_shape(d, element_size, 4096)


@pytest.mark.parametrize("rows", [1, 4096])
def test_rmsnorm_launch_shape_takes_the_widest_instance(rows):
    """bf16 d 14336 and f32 d 7168 are 256 threads x 7 vectors a row, the
    widest the library holds."""
    assert t_rms_k.launch_shape(14336, 2, rows) == (256, 7)
    assert t_rms_k.launch_shape(7168, 4, rows) == (256, 7)


def test_bf16_p_needs_hi_and_lo():
    """Why the tensor-core body feeds P·V with P as bf16 hi + lo: with P
    rounded to bf16 alone, bf16 attention's error RMS exceeds the 1e-3 of
    the output's RMS that the card checks allow; hi + lo stays far
    inside.  Simulated in float32 on the CPU (causal, S 256, hd 64, both
    sides' outputs rounded to bf16 as the kernel and its plain version
    round them)."""
    g = torch.Generator().manual_seed(0)
    S, H, hd = 256, 4, 64
    q, k, v = (torch.randn(H, S, hd, generator=g).bfloat16().float()
               for _ in range(3))
    s = q @ k.transpose(-1, -2) * hd ** -0.5
    i = torch.arange(S)
    s = s.masked_fill(i[:, None] < i[None, :], -1e30)
    p = torch.exp(s - s.amax(-1, keepdim=True))
    l = p.sum(-1, keepdim=True)
    ref = ((p @ v) / l).bfloat16().float()
    hi = p.bfloat16().float()
    lo = (p - hi).bfloat16().float()

    def rel_rms(pp):
        out = ((pp @ v) / l).bfloat16().float()
        return ((out - ref).square().mean().sqrt()
                / ref.square().mean().sqrt()).item()
    assert rel_rms(hi) > 1e-3
    assert rel_rms(hi + lo) < 2e-4
