"""RG-LRU recurrent block (RecurrentGemma / Griffin, arXiv:2402.19427)
on one card.

The port of the JAX package's ``repro/models/rglru.py``:

    x -> [branch a: W_x -> causal depthwise conv (K taps) -> RG-LRU]
         [branch b: W_y -> GeLU]
    out = W_o (h ⊙ branch b)

with, per channel (gates block-diagonal per head, float32):

    r_t = sigmoid(x_t W_a),  i_t = sigmoid(x_t W_i)
    log a_t = -8 · softplus(Λ) · r_t
    h_t = a_t ⊙ h_{t-1} + sqrt(1 - a_t²) ⊙ (i_t ⊙ x_t)

The reference runs the recurrence of a sequence through
``lax.associative_scan``; the port runs it through the RG-LRU scan kernel
(:mod:`repro_torch.kernels.rglru`: CUDA on the card, a float32 loop on
the CPU), with the initial state folded into ``b[:, 0]``.  Decode is the
single-step update in plain PyTorch.  Rounding points are the
reference's: the conv accumulates in the input's dtype, tap by tap in
the reference's order; gates, ``a``, ``b`` and ``h`` are float32;
``jax.nn.gelu``'s default tanh form and ``jax.nn.softplus``'s form
without a threshold (``logaddexp(x, 0)``) are kept.

Tensor parallelism (``env``), the reference's specs
(:func:`rglru_specs`): each model rank holds d_rnn/tp channels of
``wx``, ``wy``, ``conv_w`` and ``a_param``, the matching rows of
``wo`` and num_heads/tp whole blocks of ``gate_a``/``gate_i``; it runs
the conv, the gates and the scan on them (at decode, the single-step
update of its channels of the state), and ``wo`` ends in an all-reduce
over the model axis (x enters through ``psum_grad``).

State per block: ``{"h": (B, d_rnn) float32, "conv": (B, K-1, d_rnn)}``
in the model's dtype.  Decode updates a given state in place and returns
it; sequence mode returns a new one.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.rglru import ops as rglru_ops
from repro_torch.runtime.meshenv import CPU_ENV, MeshEnv, P
from .layers import dense_init, param_dtype

Params = dict
C_RGLRU = 8.0


def init_rglru(cfg: ModelConfig, gen: torch.Generator, device) -> Params:
    d, r, H = cfg.d_model, cfg.d_rnn, cfg.num_heads
    rh = r // H
    dt, f32 = param_dtype(cfg), torch.float32
    # Λ such that a = 0.9..0.999 at r_gate = 1 (Griffin appendix)
    lin = torch.linspace(0.9, 0.999, r, dtype=f32)
    a_param = torch.log(torch.expm1(-torch.log(lin) / C_RGLRU))
    return {
        "wx": dense_init(gen, (d, r), d, dt, device),
        "wy": dense_init(gen, (d, r), d, dt, device),
        "wo": dense_init(gen, (r, d), r, dt, device),
        "conv_w": dense_init(gen, (cfg.conv_width, r), cfg.conv_width, dt,
                             device),
        "gate_a": dense_init(gen, (H, rh, rh), rh, f32, device),
        "gate_i": dense_init(gen, (H, rh, rh), rh, f32, device),
        "a_param": a_param.to(device=device, dtype=f32),
    }


def rglru_specs(cfg: ModelConfig, env: MeshEnv) -> dict:
    """The reference's RG-LRU specs: channels (and gate blocks) over the
    model axis; d_rnn and the heads must divide TP."""
    if env.tp > 1 and (cfg.d_rnn % env.tp or cfg.num_heads % env.tp):
        raise ValueError(f"RG-LRU: d_rnn {cfg.d_rnn} and heads "
                         f"{cfg.num_heads} must divide TP {env.tp}")
    return {"wx": P(None, "model"), "wy": P(None, "model"),
            "wo": P("model", None), "conv_w": P(None, "model"),
            "gate_a": P("model", None, None),
            "gate_i": P("model", None, None), "a_param": P("model")}


def _softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``: log(1 + exp(x)) with no linear threshold."""
    return torch.logaddexp(x, torch.zeros_like(x))


def _gates(p: Params, H: int, xc: torch.Tensor):
    """xc (..., r) -> (log_a, gated input), both float32; H heads (this
    rank's ``gate_a`` blocks under TP)."""
    shape = xc.shape
    r = shape[-1]
    xh = xc.float().reshape(*shape[:-1], H, r // H)
    r_gate = torch.sigmoid(torch.einsum("...hi,hij->...hj", xh, p["gate_a"]))
    i_gate = torch.sigmoid(torch.einsum("...hi,hij->...hj", xh, p["gate_i"]))
    log_a = -C_RGLRU * _softplus(p["a_param"]) * r_gate.reshape(shape)
    return log_a, i_gate.reshape(shape) * xc.float()


def rglru_scan(log_a: torch.Tensor, gated_x: torch.Tensor,
               h0: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The recurrence over axis 1: log_a, gated_x (B, S, r) float32, h0
    (B, r) or None -> h (B, S, r) float32."""
    a = torch.exp(log_a)
    beta = torch.sqrt(torch.clamp_min(1.0 - torch.exp(2.0 * log_a), 1e-12))
    b = beta * gated_x
    if h0 is not None:
        b[:, 0] += a[:, 0] * h0
    return rglru_ops.rglru_scan(a, b)


def _causal_conv(conv_w: torch.Tensor, x: torch.Tensor,
                 conv_state: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Depthwise causal conv over time.  x (B, S, r); conv_w (K, r);
    conv_state (B, K-1, r): the previous inputs, or None for zeros."""
    K = conv_w.shape[0]
    B, S, r = x.shape
    pad = (torch.zeros((B, K - 1, r), dtype=x.dtype, device=x.device)
           if conv_state is None else conv_state.to(x.dtype))
    xp = torch.cat([pad, x], dim=1)                     # (B, S+K-1, r)
    out = torch.zeros_like(x)
    for j in range(K):
        out = out + conv_w[K - 1 - j] * xp[:, j:j + S]
    return out


def _last_k(x: torch.Tensor, k: int) -> torch.Tensor:
    """The last k steps of (B, S, r), zero-padded on the left if S < k."""
    B, S, r = x.shape
    if S >= k:
        return x[:, S - k:].clone()
    return torch.cat([torch.zeros((B, k - S, r), dtype=x.dtype,
                                  device=x.device), x], dim=1)


def _gelu_branch(p: Params, x: torch.Tensor) -> torch.Tensor:
    y = x @ p["wy"]
    return F.gelu(y.float(), approximate="tanh").to(x.dtype)


def apply_rglru_seq(cfg: ModelConfig, p: Params, x: torch.Tensor,
                    state: Optional[dict] = None, *,
                    env: MeshEnv = CPU_ENV) -> Tuple[torch.Tensor, dict]:
    """Sequence mode.  x (B, S, d) -> (out (B, S, d), final state).  With
    ``env.tp > 1``, ``p`` holds this rank's channels and the output is
    summed over the model axis."""
    if env.tp > 1:
        x = env.psum_grad(x, env.model_axis)
    xi = x @ p["wx"]                                    # (B, S, r)
    conv_state = state["conv"] if state is not None else None
    xc = _causal_conv(p["conv_w"], xi, conv_state)
    log_a, gated = _gates(p, p["gate_a"].shape[0], xc)
    h = rglru_scan(log_a, gated, state["h"] if state is not None else None)
    out = (h.to(x.dtype) * _gelu_branch(p, x)) @ p["wo"]
    if env.tp > 1:
        out = env.psum(out, env.model_axis)
    K = cfg.conv_width
    tail = (torch.cat([conv_state.to(xi.dtype), xi], dim=1)[:, -(K - 1):]
            .clone() if conv_state is not None else _last_k(xi, K - 1))
    return out, {"h": h[:, -1].clone(), "conv": tail}


def apply_rglru_decode(cfg: ModelConfig, p: Params, x: torch.Tensor,
                       state: dict, *, env: MeshEnv = CPU_ENV
                       ) -> Tuple[torch.Tensor, dict]:
    """One token.  x (B, 1, d); state {"h": (B, r) float32, "conv":
    (B, K-1, r)}, updated in place and returned.  With ``env.tp > 1``,
    ``p`` and the state hold this rank's channels and the output is
    summed over the model axis."""
    if env.tp > 1:
        x = env.psum_grad(x, env.model_axis)
    xi = x @ p["wx"]                                    # (B, 1, r)
    window = torch.cat([state["conv"].to(xi.dtype), xi], dim=1)  # (B, K, r)
    # window[k] holds x_{t-(K-1-k)} and the sequence path applies w[m] to
    # x_{t-m}: tap m = K-1-k, so the kernel is flipped over the window
    xc = torch.einsum("bkr,kr->br", window, p["conv_w"].flip(0))[:, None]
    log_a, gated = _gates(p, p["gate_a"].shape[0], xc)
    a = torch.exp(log_a[:, 0])
    beta = torch.sqrt(torch.clamp_min(1.0 - torch.exp(2.0 * log_a[:, 0]),
                                      1e-12))
    h = a * state["h"] + beta * gated[:, 0]             # (B, r) float32
    out = (h[:, None].to(x.dtype) * _gelu_branch(p, x)) @ p["wo"]
    if env.tp > 1:
        out = env.psum(out, env.model_axis)
    state["h"].copy_(h)
    state["conv"].copy_(window[:, 1:])
    return out, state


def init_rglru_state(cfg: ModelConfig, batch: int, device) -> dict:
    r, K = cfg.d_rnn, cfg.conv_width
    return {"h": torch.zeros((batch, r), dtype=torch.float32, device=device),
            "conv": torch.zeros((batch, K - 1, r), dtype=param_dtype(cfg),
                                device=device)}


__all__ = ["C_RGLRU", "apply_rglru_decode", "apply_rglru_seq", "init_rglru",
           "init_rglru_state", "rglru_scan", "rglru_specs"]
