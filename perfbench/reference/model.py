"""Plain float32 decoder of the benchmark's configurations, written from
the block equations the program states (``models/transformer.py``,
``models/layers.py``, ``models/moe.py``), with no kernel, cache or
batching of the program.

Per block: ``h += wo·attn(rope(wq·x), rope(wk·x), wv·x)`` with ``x =
rms(h, ln1)``, causal grouped-query attention (query head i reads key
head i // (Hq / Hkv)), RoPE on split halves; a ``local`` layer sees only
the keys k with q - k < ``window_size`` and turns at ``rope_theta_local``
(the layer types: :func:`layer_windows`); then ``h += ffn(rms(h,
ln2))``: SwiGLU ``wd·(silu(wg·x) * wu·x)``, or the routed experts: a
float32 softmax router, the top k gates renormalised, a Switch dispatch
that keeps an expert's first ``capacity`` assignments in token order
(token t's j-th choice is assignment t·k + j) and drops the rest, and
the Switch load-balance loss E·Σ_e mean_t(p_e)·(assignments_e / (T·k)).
``rms(x, w) = x·rsqrt(mean(x²) + eps)·(1 + w)``.  The embedding is
scaled by sqrt(d); the head is ``rms(h, final_norm)`` times the
unembedding (the embedding's transpose when tied), the padded vocabulary
masked out.

``quant`` (the control) rounds both operands of every product of the
weights to float8 e4m3 with one scale a tensor (amax to 448), and passes
gradients straight through.  TF32 is off: :func:`strict_fp32`.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

#: the MoE load-balance loss's weight in the total, and the attention
#: query block of the blocked softmax
AUX_WEIGHT = 0.01
Q_BLOCK = 1024


def layer_windows(m: dict) -> list:
    """Each layer's attention window, 0 for a global layer: the
    ``pattern``'s remainder layers first, then whole repetitions of it."""
    pat = list(m.get("pattern", ["global"]))
    types = pat[:m["num_layers"] % len(pat)] + pat * (m["num_layers"]
                                                     // len(pat))
    for t in types:
        if t not in ("global", "local"):
            raise ValueError(f"the reference has no {t!r} layer")
    return [m.get("window_size", 0) if t == "local" else 0 for t in types]


def padded_vocab(V: int) -> int:
    """The vocab padded to a multiple of 128, as the program pads it on
    one process."""
    return -(-V // 128) * 128


def layout(m: dict) -> list:
    """The program's weight tree of the decoder families
    (``models/transformer.py``): ``embed`` (Vp, d), ``final_norm``,
    ``unembed`` (d, Vp) unless tied, and per block ``ln1``, ``mix`` {wq
    (d, Hq, hd), wk, wv (d, Hkv, hd), wo (Hq, hd, d)}, ``ln2`` and
    ``ffn`` {wg, wu (d, ff), wd (ff, d)} or the experts' {router (d, E)
    float32, wg, wu (E, d, ff), wd (E, ff, d)}; as leaves:
    (path, shape, fan_in or None for a norm, float32?) of every leaf, in
    the order of the harness's flat buffers."""
    d, ff = m["d_model"], m["d_ff"]
    Hq, Hkv, hd = m["num_heads"], m["num_kv_heads"], m["head_dim"]
    E = m.get("num_experts", 0)
    Vp = padded_vocab(m["vocab_size"])
    out = [(("embed",), (Vp, d), d, False), (("final_norm",), (d,), None,
                                              False)]
    if not m.get("tie_embeddings", False):
        out.append((("unembed",), (d, Vp), d, False))
    for i in range(m["num_layers"]):
        L = ("layers", i)
        out += [(L + ("ln1",), (d,), None, False),
                (L + ("mix", "wq"), (d, Hq, hd), d, False),
                (L + ("mix", "wk"), (d, Hkv, hd), d, False),
                (L + ("mix", "wv"), (d, Hkv, hd), d, False),
                (L + ("mix", "wo"), (Hq, hd, d), Hq * hd, False),
                (L + ("ln2",), (d,), None, False)]
        if E:
            out += [(L + ("ffn", "router"), (d, E), d, True),
                    (L + ("ffn", "wg"), (E, d, ff), d, False),
                    (L + ("ffn", "wu"), (E, d, ff), d, False),
                    (L + ("ffn", "wd"), (E, ff, d), ff, False)]
        else:
            out += [(L + ("ffn", "wg"), (d, ff), d, False),
                    (L + ("ffn", "wu"), (d, ff), d, False),
                    (L + ("ffn", "wd"), (ff, d), ff, False)]
    return out


def strict_fp32() -> None:
    """Float32 products in float32: TF32 off for cuBLAS and cuDNN."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


def fp8_round(x: torch.Tensor) -> torch.Tensor:
    """x rounded to float8 e4m3 with one scale (amax to 448), back in
    float32."""
    amax = x.detach().abs().amax().clamp_min(1e-30)
    s = 448.0 / amax
    return (x * s).to(torch.float8_e4m3fn).to(torch.float32) / s


class _FP8(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return fp8_round(x)

    @staticmethod
    def backward(ctx, g):
        return g


class Ref:
    """The reference for one configuration (``m``, the configuration's
    ``program`` dict); ``quant`` makes it the float8 control."""

    def __init__(self, m: dict, quant: bool = False):
        self.m = m
        self.quant = quant
        self.eps = m.get("norm_eps", 1e-6)

    # -- primitives ----------------------------------------------------
    def w(self, t: torch.Tensor) -> torch.Tensor:
        t = t.float()
        return _FP8.apply(t) if self.quant else t

    def mm(self, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        if self.quant:
            x = _FP8.apply(x)
        return x @ self.w(w)

    def rms(self, x, w):
        return (x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + self.eps)
                * (1.0 + w.float()))

    def rope(self, x, pos, theta: float):
        hd = x.shape[-1]
        inv = 1.0 / (theta ** (
            torch.arange(0, hd, 2, dtype=torch.float32, device=x.device)
            / hd))
        ang = pos.to(torch.float32)[..., None] * inv      # (B, S, hd/2)
        cos, sin = torch.cos(ang)[:, :, None], torch.sin(ang)[:, :, None]
        x1, x2 = x.chunk(2, dim=-1)
        return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], -1)

    def attention(self, q, k, v, pos_q, pos_k, window: int = 0):
        """Causal attention of q (B, Sq, Hq, hd) at positions pos_q (Sq,)
        over k, v (B, Sk, Hkv, hd) at pos_k (Sk,), within ``window``
        positions when it is not 0, in blocks of :data:`Q_BLOCK` query
        rows."""
        B, Sq, Hq, hd = q.shape
        rep = Hq // k.shape[2]
        k = k.repeat_interleave(rep, dim=2).transpose(1, 2)   # (B,Hq,Sk,hd)
        v = v.repeat_interleave(rep, dim=2).transpose(1, 2)
        q = q.transpose(1, 2)
        out = []
        for a in range(0, Sq, Q_BLOCK):
            qb = q[:, :, a:a + Q_BLOCK]
            s = (qb @ k.transpose(-1, -2)) * hd ** -0.5
            mask = pos_k[None, :] > pos_q[a:a + Q_BLOCK, None]
            if window > 0:
                mask |= pos_q[a:a + Q_BLOCK, None] - pos_k[None, :] >= window
            s = s.masked_fill(mask, float("-inf"))
            out.append(torch.softmax(s, dim=-1) @ v)
        return torch.cat(out, dim=2).transpose(1, 2)          # (B,Sq,Hq,hd)

    def mlp(self, p, x):
        return self.mm(F.silu(self.mm(x, p["wg"])) * self.mm(x, p["wu"]),
                       p["wd"])

    def moe(self, p, x, capacity_factor: float):
        """x (B, S, d) -> (y, aux): the routed experts over the batch's
        B·S tokens."""
        B, S, d = x.shape
        T = B * S
        E, k = self.m["num_experts"], self.m["experts_per_token"]
        xf = x.reshape(T, d)
        gates = torch.softmax(self.mm(xf, p["router"]), dim=-1)
        g_top, idx = torch.topk(gates, k, dim=-1)
        g_top = g_top / g_top.sum(-1, keepdim=True).clamp_min(1e-9)
        flat_e = idx.reshape(-1)                              # (T·k,)
        onehot = F.one_hot(flat_e, E)
        rank = (torch.cumsum(onehot, 0) - onehot).gather(
            1, flat_e[:, None])[:, 0]
        cap = max(1, math.ceil(T * k / E * capacity_factor))
        keep = rank < cap
        counts = onehot.sum(0).float()
        aux = E * torch.sum(gates.mean(0) * counts / (T * k))
        y = torch.zeros_like(xf)
        gate_flat = g_top.reshape(-1)
        for e in range(E):
            sel = torch.nonzero((flat_e == e) & keep)[:, 0]
            if sel.numel() == 0:
                continue
            tok = sel // k
            xe = xf[tok]
            he = F.silu(self.mm(xe, p["wg"][e])) * self.mm(xe, p["wu"][e])
            ye = self.mm(he, p["wd"][e]) * gate_flat[sel][:, None]
            y = y.index_add(0, tok, ye)
        return y.reshape(B, S, d), aux

    def block(self, p, h, pos, capacity_factor: float = 1.25,
              window: int = 0):
        """One block over h (B, S, d) at positions pos (S,) -> (h, aux);
        ``window`` 0 for a global layer."""
        B, S, d = h.shape
        x = self.rms(h, p["ln1"])
        mix = p["mix"]

        def proj(w):
            return self.mm(x, w.reshape(d, -1)).reshape(
                B, S, w.shape[1], w.shape[2])

        theta = self.m.get("rope_theta_local" if window else "rope_theta",
                           10_000.0)
        q = self.rope(proj(mix["wq"]), pos[None].expand(B, S), theta)
        k = self.rope(proj(mix["wk"]), pos[None].expand(B, S), theta)
        o = self.attention(q, k, proj(mix["wv"]), pos, pos, window)
        h = h + self.mm(o.reshape(B, S, -1), mix["wo"].reshape(-1, d))
        x = self.rms(h, p["ln2"])
        if self.m.get("num_experts", 0):
            y, aux = self.moe(p["ffn"], x, capacity_factor)
        else:
            y, aux = self.mlp(p["ffn"], x), h.new_zeros(())
        return h + y, aux

    def embed(self, params, tokens):
        return params["embed"].float()[tokens.long()] * math.sqrt(
            self.m["d_model"])

    def logits(self, params, h):
        """h (..., d) -> float32 logits over the real vocabulary."""
        h = self.rms(h, params["final_norm"])
        table = (params["embed"].t() if self.m.get("tie_embeddings")
                 else params["unembed"])
        return self.mm(h, table)[..., :self.m["vocab_size"]]

    # -- serving -------------------------------------------------------
    @torch.no_grad()
    def serve_logits(self, params, tokens: torch.Tensor,
                     at: torch.Tensor) -> torch.Tensor:
        """Logits (len(at), V) at positions ``at`` of one sequence
        ``tokens`` (S,), layer by layer (``params`` in any dtype; each
        leaf is used in float32)."""
        S = tokens.shape[0]
        pos = torch.arange(S, device=tokens.device)
        h = self.embed(params, tokens[None])
        for p, W in zip(params["layers"], layer_windows(self.m)):
            h, _ = self.block(p, h, pos, window=W)
        return self.logits(params, h[0, at])

    # -- training ------------------------------------------------------
    def loss(self, params, batch: dict, capacity_factor: float = 1.25,
             remat: bool = True, rows: Optional[slice] = None) -> tuple:
        """(total, loss, aux) of a batch: the mean token cross entropy
        plus AUX_WEIGHT times the blocks' summed aux; each block
        recomputed in the backward under ``remat``.  ``rows`` keeps only
        some rows of the batch (a planted fault)."""
        tokens, labels = batch["tokens"], batch["labels"]
        if rows is not None:
            tokens, labels = tokens[rows], labels[rows]
        B, S = tokens.shape
        pos = torch.arange(S, device=tokens.device)
        h = self.embed(params, tokens)
        aux = h.new_zeros(())
        for p, W in zip(params["layers"], layer_windows(self.m)):
            if remat:
                h, a = checkpoint(self.block, p, h, pos, capacity_factor, W,
                                  use_reentrant=False)
            else:
                h, a = self.block(p, h, pos, capacity_factor, W)
            aux = aux + a
        lg = self.logits(params, h)
        lse = torch.logsumexp(lg, dim=-1)
        ll = torch.gather(lg, -1, labels.long()[..., None])[..., 0]
        loss = (lse - ll).mean()
        return loss + AUX_WEIGHT * aux, loss, aux
