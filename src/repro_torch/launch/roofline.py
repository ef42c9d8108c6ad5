"""Roofline terms of a cell from its counted costs.

The port of the JAX package's ``repro/launch/roofline.py``.  Three
terms, in seconds, each from a rank's numbers (the division by the
chip count cancels):

  compute    = flops a rank            / peak FLOP/s
  memory     = HBM bytes a rank        / HBM bytes/s
  collective = collective bytes a rank / link bytes/s

The hardware constants are one argument, :class:`Hardware`; the default
is :data:`H100`, the data-sheet figures of ``launch.mesh`` (989e12
bf16 FLOP/s, 3.35e12 B/s of HBM3, NVLink 4 at 450e9 B/s a direction).
The terms are bounds derived from those constants, not measurements.

The collective term divides by one link rate, as the reference divides
by its one ICI rate.  An 8-GPU HGX node joins its cards all to all by
NVLink; a model axis of 16 spans two nodes, whose traffic between them
crosses the slower network between hosts, so there the term is a lower
bound.

``matmul_params``, ``body_and_unembed_params``, ``kv_cache_bytes``,
``analytic_traffic_bytes`` and ``model_flops`` are the reference's
formulas, term for term and in its order, so they give its floats.
MODEL_FLOPS is 6·N·D for training and 2·N·D for inference cells, N the
active parameters whose matmuls run (embedding gather excluded, the
unembedding included, an MoE's routed experts only).  The port's
counted train flops include remat's second forward (about 8·N·D).
"""
from __future__ import annotations

import dataclasses
from typing import Dict

from repro_torch.configs.base import ModelConfig, ShapeCell
from .collective_stats import CollectiveStats
from .mesh import HBM_BW, NVLINK_BW, PEAK_BF16_FLOPS


@dataclasses.dataclass(frozen=True)
class Hardware:
    """One chip's peak rates: FLOP/s, HBM bytes/s, link bytes/s."""
    peak_flops: float
    hbm_bw: float
    link_bw: float


#: NVIDIA H100 SXM, data sheet (``launch.mesh``)
H100 = Hardware(PEAK_BF16_FLOPS, HBM_BW, NVLINK_BW)


def matmul_params(cfg: ModelConfig) -> int:
    """Active parameters that do matmul work per token."""
    n = cfg.num_active_params()
    if not cfg.tie_embeddings:
        n -= cfg.vocab_size * cfg.d_model      # lookup-only embedding table
    return n


def body_and_unembed_params(cfg: ModelConfig):
    """(per-token body params, unembed params).  The unembed projection
    runs at every position in training but only at the last position in
    prefill/decode."""
    unembed = cfg.vocab_size * cfg.d_model
    body = matmul_params(cfg) - unembed
    return body, unembed


def kv_cache_bytes(cfg: ModelConfig, batch: int, cache_len: int,
                   kv_elem_bytes: float = 2.0) -> int:
    """Total KV/recurrent-state bytes for one model instance."""
    total = 0
    for lt in cfg.layer_types():
        if lt == "global":
            total += int(2 * batch * cache_len * cfg.kv_dim * kv_elem_bytes)
        elif lt == "local":
            L = min(cfg.window_size or cache_len, cache_len)
            total += int(2 * batch * L * cfg.kv_dim * kv_elem_bytes)
        elif lt == "rglru":
            total += batch * cfg.d_rnn * 4 * (1 + cfg.conv_width)
        elif lt == "rwkv6":
            H = cfg.rwkv_num_heads
            total += batch * H * cfg.rwkv_head_dim ** 2 * 4
            total += 2 * batch * cfg.d_model * 4
    return total


def analytic_traffic_bytes(cfg: ModelConfig, cell: ShapeCell, chips: int,
                           tp: int, dp: int,
                           kv_elem_bytes: float = 2.0) -> float:
    """A rank's HBM traffic a step as a fused program would move it: the
    weight reads, optimizer state, activation saves at block boundaries
    and the KV-cache traffic (the reference's estimate)."""
    P2 = 2.0 * cfg.num_params()                # bf16 weight bytes, global
    d = cfg.d_model
    L = cfg.num_layers + (cfg.num_enc_layers if cfg.enc_dec else 0)
    B_loc = max(cell.global_batch // max(dp, 1), 1)
    if cell.kind == "train":
        S = cell.seq_len
        # fwd read + bwd read (remat re-reads) + param write
        w = 3.0 * P2 / tp
        # grads write+read (bf16) + AdamW m/v f32 read+write on 1/dp shard
        w += 2.0 * P2 / tp
        w += 2.0 * 2.0 * (4.0 * cfg.num_params()) / (tp * max(dp, 1))
        # activations: save 1 residual per layer + ~4 touches through bwd
        act = L * B_loc * S * d * 2.0 * 5.0 / max(tp, 1)
        return w + act
    if cell.kind == "prefill":
        S = cell.seq_len
        w = P2 / tp
        act = L * B_loc * S * d * 2.0 * 3.0 / max(tp, 1)
        cache = kv_cache_bytes(cfg, cell.global_batch, S,
                               kv_elem_bytes) / chips
        return w + act + cache
    # decode: every (active) weight + the whole cache, once per token
    w = 2.0 * cfg.num_active_params() / tp
    cache = 2.0 * kv_cache_bytes(cfg, cell.global_batch, cell.seq_len,
                                 kv_elem_bytes) / chips
    return w + cache


def model_flops(cfg: ModelConfig, cell: ShapeCell) -> float:
    body, unembed = body_and_unembed_params(cfg)
    B = cell.global_batch
    if cell.kind == "train":
        D = B * cell.seq_len
        return 6.0 * (body + unembed) * D
    if cell.kind == "prefill":
        D = B * cell.seq_len
        return 2.0 * body * D + 2.0 * unembed * B      # head: last pos only
    return 2.0 * (body + unembed) * B                  # decode: one token


@dataclasses.dataclass
class Roofline:
    compute_s: float
    memory_s: float                      # counted bytes a rank
    memory_est_s: float                  # analytic HBM-traffic estimate
    collective_s: float
    collective_link_s: float
    flops_per_device: float
    bytes_per_device: float
    bytes_est_per_device: float
    collective_bytes_per_device: float
    model_flops: float
    hlo_flops_global: float              # counted flops x chips
    useful_ratio: float                  # MODEL_FLOPS / counted flops
    bottleneck: str
    chips: int
    #: the chip's peak FLOP/s for :attr:`mfu` (not a field: ``row()``
    #: keeps the reference's keys)
    peak_flops: dataclasses.InitVar[float] = PEAK_BF16_FLOPS

    def __post_init__(self, peak_flops: float) -> None:
        self._peak_flops = peak_flops

    def row(self) -> Dict[str, float]:
        return dataclasses.asdict(self)

    @property
    def step_time_s(self) -> float:
        """Roofline step time = max of the three terms (perfect overlap);
        the memory term uses the fusion-aware analytic estimate."""
        return max(self.compute_s, self.memory_est_s, self.collective_link_s)

    @property
    def mfu(self) -> float:
        """Model-FLOPs utilization at the roofline step time."""
        t = self.step_time_s
        if t <= 0:
            return 0.0
        return self.model_flops / (t * self.chips * self._peak_flops)


def derive(cfg: ModelConfig, cell: ShapeCell, cost: Dict[str, float],
           stats: CollectiveStats, chips: int, *, tp: int = 1,
           dp: int = 1, kv_elem_bytes: float = 2.0,
           hw: Hardware = H100) -> Roofline:
    flops_dev = float(cost.get("flops", 0.0))
    bytes_dev = float(cost.get("bytes accessed", 0.0))
    coll_dev = float(stats.total_bytes)
    link_dev = float(stats.link_bytes)
    bytes_est = analytic_traffic_bytes(cfg, cell, chips, tp, dp,
                                       kv_elem_bytes)

    compute_s = flops_dev / hw.peak_flops
    memory_s = bytes_dev / hw.hbm_bw
    memory_est_s = bytes_est / hw.hbm_bw
    collective_s = coll_dev / hw.link_bw
    link_s = link_dev / hw.link_bw

    mf = model_flops(cfg, cell)
    hlo_global = flops_dev * chips
    terms = {"compute": compute_s, "memory": memory_est_s,
             "collective": link_s}
    bottleneck = max(terms, key=terms.get)
    return Roofline(
        compute_s=compute_s, memory_s=memory_s, memory_est_s=memory_est_s,
        collective_s=collective_s,
        collective_link_s=link_s, flops_per_device=flops_dev,
        bytes_per_device=bytes_dev, bytes_est_per_device=bytes_est,
        collective_bytes_per_device=coll_dev,
        model_flops=mf, hlo_flops_global=hlo_global,
        useful_ratio=(mf / hlo_global) if hlo_global else 0.0,
        bottleneck=bottleneck, chips=chips, peak_flops=hw.peak_flops)


__all__ = ["H100", "Hardware", "Roofline", "analytic_traffic_bytes",
           "body_and_unembed_params", "derive", "kv_cache_bytes",
           "matmul_params", "model_flops"]
