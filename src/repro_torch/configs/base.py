"""Model configurations: :class:`ModelConfig`, the layer-type tags and
:func:`reduced`.

A copy of the JAX package's ``repro/configs/base.py`` (plain dataclasses,
no tensors): the port imports nothing of that package, so it keeps its
own.  The shape cells (``ShapeCell``, ``ALL_CELLS``, ``supports_cell``)
are the reference's, unchanged: ``launch/steps.py`` builds a program for
each architecture x cell.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

# Layer-type tags.  A model is a sequence of blocks; each block has exactly
# one temporal-mixing flavour.
ATTN_GLOBAL = "global"        # full causal attention
ATTN_LOCAL = "local"          # sliding-window causal attention
RGLRU = "rglru"               # RG-LRU recurrent block (RecurrentGemma)
RWKV6 = "rwkv6"               # RWKV-6 "Finch" time-mix (attention free)

LAYER_TYPES = (ATTN_GLOBAL, ATTN_LOCAL, RGLRU, RWKV6)

# Families
DENSE = "dense"
MOE = "moe"
HYBRID = "hybrid"
SSM = "ssm"
VLM = "vlm"
AUDIO = "audio"
CNN = "cnn"


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """Static description of one architecture."""

    name: str
    family: str

    # Core transformer dims.
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    head_dim: int
    d_ff: int
    vocab_size: int

    # Layer pattern: ``pattern`` is the repeating unit of layer types; the
    # full per-layer type list is ``layer_types()`` (remainder layers come
    # FIRST, then ``num_layers // len(pattern)`` repetitions of the unit).
    pattern: Tuple[str, ...] = (ATTN_GLOBAL,)

    # Attention details.
    qk_norm: bool = False
    window_size: int = 0              # for ATTN_LOCAL layers
    rope_theta: float = 10_000.0
    rope_theta_local: float = 10_000.0
    logit_softcap: float = 0.0

    # MoE (0 experts == dense FFN).
    num_experts: int = 0
    experts_per_token: int = 0

    # RG-LRU (recurrentgemma).
    d_rnn: int = 0
    conv_width: int = 4

    # RWKV6.
    rwkv_head_dim: int = 64
    rwkv_decay_lora: int = 64
    d_ff_rwkv: int = 0

    # Encoder-decoder (seamless).
    enc_dec: bool = False
    num_enc_layers: int = 0

    # Modality frontend stub: None | "vit" | "audio".
    frontend: Optional[str] = None
    frontend_len: int = 0

    # Numerics.
    dtype: str = "bfloat16"
    norm_eps: float = 1e-6
    tie_embeddings: bool = False

    # ------------------------------------------------------------------
    def layer_types(self) -> Tuple[str, ...]:
        p = len(self.pattern)
        rem = self.num_layers % p
        return tuple(self.pattern[:rem]) + self.pattern * (self.num_layers // p)

    @property
    def q_dim(self) -> int:
        return self.num_heads * self.head_dim

    @property
    def kv_dim(self) -> int:
        return self.num_kv_heads * self.head_dim

    @property
    def rwkv_num_heads(self) -> int:
        return self.d_model // self.rwkv_head_dim

    def num_params(self) -> int:
        """Analytic parameter count (embedding + blocks + head)."""
        d, ff = self.d_model, self.d_ff
        n = self.vocab_size * d                      # embedding
        if not self.tie_embeddings:
            n += self.vocab_size * d                 # unembedding
        for lt in self.layer_types():
            n += 2 * d                               # two norms
            if lt in (ATTN_GLOBAL, ATTN_LOCAL):
                n += d * self.q_dim + 2 * d * self.kv_dim + self.q_dim * d
                if self.qk_norm:
                    n += 2 * self.head_dim
            elif lt == RGLRU:
                r = self.d_rnn
                n += 2 * d * r + r * d
                n += self.conv_width * r
                n += 2 * r * (r // self.num_heads) + r
            elif lt == RWKV6:
                h = self.d_model
                n += 4 * h * h + h * h
                n += 2 * h * self.rwkv_decay_lora
                n += 6 * h + self.rwkv_num_heads * self.rwkv_head_dim
                ffr = self.d_ff_rwkv or ff
                n += h * ffr + ffr * h + h * h
            if lt != RWKV6:
                if self.num_experts:
                    n += d * self.num_experts
                    n += self.num_experts * 3 * d * ff
                else:
                    n += 3 * d * ff
        if self.enc_dec:
            enc = self.num_enc_layers
            n += enc * (2 * d + d * self.q_dim + 2 * d * self.kv_dim
                        + self.q_dim * d + 3 * d * ff)
            n += self.num_layers * (d + d * self.q_dim + 2 * d * self.kv_dim
                                    + self.q_dim * d)
        return n


# ---------------------------------------------------------------------------
# Shape cells
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class ShapeCell:
    name: str
    seq_len: int
    global_batch: int
    kind: str                 # "train" | "prefill" | "decode"


TRAIN_4K = ShapeCell("train_4k", 4_096, 256, "train")
PREFILL_32K = ShapeCell("prefill_32k", 32_768, 32, "prefill")
DECODE_32K = ShapeCell("decode_32k", 32_768, 128, "decode")
LONG_500K = ShapeCell("long_500k", 524_288, 1, "decode")

ALL_CELLS = (TRAIN_4K, PREFILL_32K, DECODE_32K, LONG_500K)
CELLS_BY_NAME = {c.name: c for c in ALL_CELLS}


def supports_cell(cfg: ModelConfig, cell: ShapeCell) -> bool:
    """long_500k needs sub-quadratic attention state: a recurrent block
    or sliding-window attention; pure full-attention architectures are
    skipped."""
    if cell.name != "long_500k":
        return True
    types = set(cfg.layer_types())
    return bool(types & {RGLRU, RWKV6}) or (ATTN_LOCAL in types)


def reduced(cfg: ModelConfig, *, layers: int = 2, d_model: int = 64,
            heads: int = 2, kv_heads: Optional[int] = None, d_ff: int = 128,
            vocab: int = 257, experts: int = 0) -> ModelConfig:
    """A tiny same-family config for CPU smoke tests."""
    kv = kv_heads if kv_heads is not None else min(cfg.num_kv_heads, heads)
    head_dim = d_model // heads
    pat_period = len(cfg.pattern)
    n_layers = max(layers, pat_period)
    kw = dict(
        num_layers=n_layers, d_model=d_model, num_heads=heads,
        num_kv_heads=kv, head_dim=head_dim, d_ff=d_ff, vocab_size=vocab,
        window_size=min(cfg.window_size, 8) if cfg.window_size else 0,
        d_rnn=d_model if cfg.d_rnn else 0,
        rwkv_head_dim=d_model // heads,
        rwkv_decay_lora=8 if cfg.rwkv_decay_lora else 0,
        d_ff_rwkv=d_ff if cfg.d_ff_rwkv else 0,
        num_experts=(experts or (4 if cfg.num_experts else 0)),
        experts_per_token=2 if cfg.num_experts else 0,
        num_enc_layers=n_layers if cfg.enc_dec else 0,
        frontend_len=4 if cfg.frontend else 0,
    )
    return dataclasses.replace(cfg, name=cfg.name + "-smoke", **kw)
