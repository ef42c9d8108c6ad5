"""Frozen copies of the program's work arithmetic, so that later changes
to the program cannot move the yardstick.

* :func:`attention_pairs`, :func:`attention_fwd_cost`,
  :func:`attention_bwd_cost`: row 3's ``pairs``, ``_cost_forward`` and
  ``_cost_backward`` (``kernels/flash_attention/ops.py``), by shapes;
* :func:`moe_fwd_cost`, :func:`moe_bwd_cost`: row 5's
  (``kernels/moe_gemm/ops.py``);
* :func:`num_params`, :func:`num_active_params`,
  :func:`body_and_unembed_params`, :func:`model_flops`: the model counts
  of ``configs/base.py`` and ``launch/roofline.py`` for the attention
  families the benchmark runs (global or sliding-window attention,
  SwiGLU or routed experts).

``tests/test_perfbench_frozen.py`` pins each equal to the program's at a
few shapes.  The peaks are the H100 SXM data sheet's dense rates.
"""
from __future__ import annotations

import math

from reference.model import layer_windows

#: bf16 dense tensor-core FLOP/s and HBM3 bytes/s of one H100 SXM
PEAK_FLOPS = 989e12
HBM_BYTES_S = 3.35e12

#: row 3's backward works 2.5 times the forward's operations
ATTN_BWD_FACTOR = 2.5


def bound_s(flops: float, moved: float) -> float:
    """The least time one launch can take: the larger of its operations
    at the peak rate and its bytes at the HBM rate."""
    return max(flops / PEAK_FLOPS, moved / HBM_BYTES_S)


def attention_pairs(Sq: int, Skv: int, causal: bool, window: int,
                    q_offset: int = 0) -> int:
    """(query, key) pairs of one head that the masks leave."""
    off = int(q_offset or 0)

    def below(n: int) -> int:
        if causal:
            w = window if window > 0 else n
            w = min(w, n)
            return w * (w + 1) // 2 + (n - w) * w
        if not window:
            return n * Skv
        m = max(n - window, 0)
        c = min(m, Skv)
        return n * Skv - (c * (c + 1) // 2 + (m - c) * Skv)

    return below(off + Sq) - below(off)


def attention_fwd_cost(B: int, Sq: int, Skv: int, Hq: int, Hkv: int,
                       hd: int, es: int, causal: bool = True,
                       window: int = 0, stats: bool = False,
                       bf16: bool = True) -> tuple:
    """(flops, bytes) of one forward launch: 4·hd a pair a query head;
    q, k, v read and out written once; with ``stats`` the float32 LSE
    and, in bfloat16, the rounding residual written too."""
    q_numel = B * Sq * Hq * hd
    k_numel = B * Skv * Hkv * hd
    moved = (2 * q_numel + 2 * k_numel) * es
    if stats:
        moved += 4 * B * Hq * Sq + (q_numel * es if bf16 else 0)
    flops = 4.0 * B * Hq * hd * attention_pairs(Sq, Skv, causal, window)
    return flops, moved


def attention_bwd_cost(B: int, Sq: int, Skv: int, Hq: int, Hkv: int,
                       hd: int, es: int, causal: bool = True,
                       window: int = 0, bf16: bool = True) -> tuple:
    """(flops, bytes) of one backward call: 2.5 times the forward's
    operations; q, k, v, out, dout read and dq, dk, dv written, in
    bfloat16 the LSE and residual read too."""
    q_numel = B * Sq * Hq * hd
    k_numel = B * Skv * Hkv * hd
    moved = 4 * (q_numel + k_numel) * es
    if bf16:
        moved += 4 * B * Hq * Sq + q_numel * es
    flops = ATTN_BWD_FACTOR * 4.0 * B * Hq * hd * attention_pairs(
        Sq, Skv, causal, window)
    return flops, moved


def moe_fwd_cost(E: int, C: int, d: int, ff: int, es: int) -> tuple:
    """(flops, bytes) of one expert SwiGLU launch over an (E, C, d)
    buffer: 6·E·C·d·ff; x read, y written, the three weights read."""
    return 6.0 * E * C * d * ff, (2 * E * C * d + 3 * E * d * ff) * es


def moe_bwd_cost(E: int, C: int, d: int, ff: int, es: int) -> tuple:
    """(flops, bytes) of one backward call: 12·E·C·d·ff; x, dy and the
    weights read, their gradients written."""
    return (12.0 * E * C * d * ff,
            2 * (2 * E * C * d + 3 * E * d * ff) * es)


def moe_capacity(tokens: int, experts: int, top_k: int,
                 factor: float) -> int:
    """Rows an expert: ceil(tokens·k/E·factor), at least 1."""
    return max(1, math.ceil(tokens * top_k / experts * factor))


# ---------------------------------------------------------------------------
# Model counts.  ``m`` is a configuration's ``program`` dict: the fields of
# the program's ModelConfig that the attention families use.
# ---------------------------------------------------------------------------
def num_params(m: dict) -> int:
    """Every parameter: embedding, unembedding unless tied, and per block
    two norms, attention and the SwiGLU or the experts with their
    router."""
    d, ff, V = m["d_model"], m["d_ff"], m["vocab_size"]
    q_dim = m["num_heads"] * m["head_dim"]
    kv_dim = m["num_kv_heads"] * m["head_dim"]
    n = V * d
    if not m.get("tie_embeddings", False):
        n += V * d
    E = m.get("num_experts", 0)
    per = 2 * d + d * q_dim + 2 * d * kv_dim + q_dim * d
    if m.get("qk_norm", False):
        per += 2 * m["head_dim"]
    per += (d * E + E * 3 * d * ff) if E else 3 * d * ff
    return n + m["num_layers"] * per


def num_active_params(m: dict) -> int:
    """Parameters a token touches: the routed experts only."""
    E = m.get("num_experts", 0)
    if not E:
        return num_params(m)
    d, ff = m["d_model"], m["d_ff"]
    return num_params(m) - m["num_layers"] * (
        E * 3 * d * ff - m["experts_per_token"] * 3 * d * ff)


def body_and_unembed_params(m: dict) -> tuple:
    """(per-token body parameters, unembedding parameters): the lookup
    embedding does no product; a tied table is counted once, as the
    head."""
    unembed = m["vocab_size"] * m["d_model"]
    n = num_active_params(m)
    if not m.get("tie_embeddings", False):
        n -= unembed
    return n - unembed, unembed


def model_flops(m: dict, kind: str, batch: int, seq: int) -> float:
    """Model flops without attention's: ``train`` 6·(body + unembed) a
    token, ``prefill`` 2·body a token and the head at the last position,
    ``decode`` 2·(body + unembed) a row."""
    body, unembed = body_and_unembed_params(m)
    if kind == "train":
        return 6.0 * (body + unembed) * batch * seq
    if kind == "prefill":
        return 2.0 * body * batch * seq + 2.0 * unembed * batch
    return 2.0 * (body + unembed) * batch


def attention_flops(m: dict, pairs_of) -> float:
    """Forward attention flops over every layer: 4·Hq·hd a (query, key)
    pair (QK and PV), ``pairs_of(window)`` giving a layer's pairs summed
    over sequences under its window (0 for a global layer)."""
    return 4.0 * m["num_heads"] * m["head_dim"] * sum(
        pairs_of(W) for W in layer_windows(m))
