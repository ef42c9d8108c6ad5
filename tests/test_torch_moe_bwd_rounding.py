"""Kernel row 5's backward (the fused expert SwiGLU,
``src/repro_torch/kernels/moe_gemm/csrc/moe_swiglu_bwd.cu``) before the
card: the roundings its bfloat16 bodies make, simulated in float64, and
the host-side launch shape of its three bodies.

* Both bf16 bodies (wgmma + TMA above 16 capacity rows, mma.sync up to
  16) recompute G = x·Wg, U = x·Wu and dH = dy·Wdᵀ in float32 from the
  bf16 operands, store H, dG and dU once in bf16, and feed those to dx =
  dG·Wgᵀ + dU·Wuᵀ, dWg = xᵀ·dG, dWu = xᵀ·dU and dWd = Hᵀ·dy, each summed
  in float32 and rounded to bf16 once.  Simulated in float64 at
  granite-moe-1b-a400m's expert widths (d 1024, ff 512) against the
  exact gradients of the same bf16 inputs, every gradient holds the card
  checks' ``GRAD_RMS_TOL["bfloat16"]`` (4e-3, ``chip_smoke.py``).
* The body a dtype and capacity run (``backward.body_for``), the
  library's body codes, and the wgmma body's shared memory.  The kernels
  run only on the card (``tests/test_torch_cuda.py``, ``chip_smoke.py``
  ``[train-kernels]``).
"""
import re
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke                                               # noqa: E402

from repro_torch.kernels.moe_gemm import backward as mb         # noqa: E402
from repro_torch.kernels.moe_gemm import kernel as mk           # noqa: E402

TOL = chip_smoke.GRAD_RMS_TOL["bfloat16"]          # 4e-3


def _r16(x):
    return x.to(torch.bfloat16).double()


def _rel_rms(a, b) -> float:
    return ((a - b).square().mean().sqrt()
            / b.square().mean().sqrt()).item()


def _inputs(E, C, d, ff, seed):
    """x, dy randn; the weights randn scaled by 1/sqrt(fan-in), as the card
    cases make them; all rounded to bf16 (float64 tensors)."""
    rng = np.random.default_rng(seed)

    def r(*shape, scale=1.0):
        return _r16(torch.from_numpy(rng.standard_normal(shape) * scale))

    return (r(E, C, d), r(E, d, ff, scale=d ** -0.5),
            r(E, d, ff, scale=d ** -0.5), r(E, ff, d, scale=ff ** -0.5),
            r(E, C, d))


def _grads(x, wg, wu, wd, dy, hidden_round):
    """(dx, dwg, dwu, dwd) in float64 with H, dG and dU passed through
    ``hidden_round`` before the products that read them."""
    g, u = x @ wg, x @ wu
    sig = torch.sigmoid(g)
    silu = g * sig
    dh = dy @ wd.transpose(1, 2)
    h = hidden_round(silu * u)
    dg = hidden_round(dh * u * (sig * (1 + g * (1 - sig))))
    du = hidden_round(dh * silu)
    xt = x.transpose(1, 2)
    return (dg @ wg.transpose(1, 2) + du @ wu.transpose(1, 2), xt @ dg,
            xt @ du, h.transpose(1, 2) @ dy)


@pytest.mark.parametrize("seed", [0, 1])
def test_bf16_roundings_hold_the_card_tolerance(seed):
    """H, dG, dU stored once in bf16 and every gradient rounded once to
    bf16, at d 1024, ff 512 (granite-moe-1b-a400m's experts)."""
    inputs = _inputs(2, 256, 1024, 512, seed)
    exact = _grads(*inputs, lambda t: t)
    got = [_r16(t) for t in _grads(*inputs, _r16)]
    err = {n: _rel_rms(a, b)
           for n, a, b in zip(("dx", "dwg", "dwu", "dwd"), got, exact)}
    assert max(err.values()) < TOL, err
    # the hidden roundings add to the output's own (2^-9 / sqrt(3))
    assert min(err.values()) > 1.1e-3, err


def test_the_exact_simulation_is_autograd_of_the_forward():
    """The simulation's exact gradients equal float64 autograd through
    (silu(x·Wg) ⊙ x·Wu)·Wd."""
    x, wg, wu, wd, dy = _inputs(2, 24, 64, 40, 3)
    leaves = [t.clone().requires_grad_() for t in (x, wg, wu, wd)]
    xl, gl, ul, dl = leaves
    y = (torch.nn.functional.silu(xl @ gl) * (xl @ ul)) @ dl
    want = torch.autograd.grad(y, leaves, dy)
    for a, b in zip(_grads(x, wg, wu, wd, dy, lambda t: t), want):
        torch.testing.assert_close(a, b, rtol=1e-12, atol=1e-12)


# ---------------------------------------------------------------------------
# host-side launch shape
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("C", [1, 4, 16, 17, 100, 1280])
def test_backward_body_follows_dtype_and_capacity(C):
    """bf16 above DECODE_C capacity rows runs the wgmma + TMA body, as the
    forward does; up to it the mma.sync tiles; float32 the CUDA cores."""
    bf, f32 = torch.bfloat16, torch.float32
    for d, ff in ((1024, 512), (2048, 1408), (136, 200)):
        body = mb.body_for(bf, C, d, ff)
        assert body == ("wgmma" if C > mb.DECODE_C else "mma")
        assert (body == "wgmma") == (mk.body_for(bf, C, d, ff) == "wgmma")
        assert mb.body_for(f32, C, d, ff) == "cuda_cores"
    assert mb.DECODE_C == mk.DECODE_C == 16


def test_backward_body_refuses_what_no_body_takes():
    with pytest.raises(TypeError, match="dtype"):
        mb.body_for(torch.float16, 100, 1024, 512)
    for d, ff in ((1020, 512), (1024, 500)):
        with pytest.raises(ValueError, match="multiples of 8"):
            mb.body_for(torch.bfloat16, 100, d, ff)


def test_backward_body_codes_match_the_library():
    src = mb.SOURCE.read_text()
    pairs = set(re.findall(r"if \(dtype == (\d) && body == (\d)\)", src))
    assert pairs == {(str(mb.DTYPES[torch.float32]),
                      str(mb.BODIES["cuda_cores"])),
                     (str(mb.DTYPES[torch.bfloat16]),
                      str(mb.BODIES["mma"])),
                     (str(mb.DTYPES[torch.bfloat16]),
                      str(mb.BODIES["wgmma"]))}
    assert mb.BODIES == mk.BODIES


def test_backward_wgmma_block_fits_one_to_an_sm():
    """The ring (4 stages of 48 KB) and the two warpgroups' 16 KB output
    blocks fit the H100's 232,448 bytes a block, one block an SM, as the
    source counts them."""
    assert mb.WGMMA_SMEM == 230_464
    assert mb.WGMMA_SMEM <= 232_448 < 2 * mb.WGMMA_SMEM
    src = mb.SOURCE.read_text()
    for decl in ("constexpr int STAGES = 4;", "constexpr int BN = 256;",
                 "constexpr int BM = 64 * NWG;", "constexpr int NWG = 2;",
                 "constexpr int BK = 64;",
                 "constexpr int OUT = STAGES * STAGE + 64;",
                 "constexpr int OUT_BYTES = 64 * 128 * 2;",
                 "constexpr int SMEM = OUT + NWG * OUT_BYTES + 1024;"):
        assert decl in src, decl


def test_backward_and_forward_share_the_hopper_helpers():
    """Ring, Tiles, tensor_map and the wgmma wrappers live once, in
    moe_tc.cuh, which both sources include."""
    fwd = mk.SOURCE.read_text()
    bwd = mb.SOURCE.read_text()
    header = (mb.SOURCE.parent / "moe_tc.cuh").read_text()
    for src in (fwd, bwd):
        assert '#include "moe_tc.cuh"' in src
        assert "struct Ring" not in src and "struct Tiles" not in src
        assert "cuTensorMapEncodeTiled" not in src
    for name in ("struct Ring", "struct Tiles", "inline int tensor_map",
                 "wgmma_ss_n256", "wgmma_ss_n128"):
        assert name in header, name
