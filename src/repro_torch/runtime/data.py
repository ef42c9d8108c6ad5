"""Deterministic synthetic data + straggler-aware dispatch.

The port of the JAX package's ``repro/runtime/data.py``.  Token batches
are a pure function of (seed, step): restarting from a checkpoint's data
cursor reproduces the exact stream.  They are drawn with a CPU
``torch.Generator`` seeded from both and then moved to the device, so a
batch is the same on every device.  ``jax.random`` gives other bits from
the same seed, so the port's batches are not the reference's: the
differential tests draw the reference's batch and feed it, as numpy, to
both packages.

``StragglerAwareDispatcher`` is the reference's host-side numpy model,
copied as it is.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch._device import resolve_device
from repro_torch.configs.base import ModelConfig


# ---------------------------------------------------------------------------
# Synthetic LM stream
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class DataConfig:
    seed: int = 0
    seq_len: int = 512
    global_batch: int = 8


def _stream_seed(seed: int, step: int) -> int:
    """One 63-bit generator seed from (seed, step): distinct steps of one
    seed, and distinct seeds, give distinct streams."""
    return (int(seed) * 0x9E3779B97F4A7C15 + int(step)) % (1 << 63)


def batch_at(cfg: ModelConfig, dcfg: DataConfig, step: int,
             device=None) -> dict:
    """Deterministic batch for ``step`` (pure function — restart safe) on
    ``device`` (default the card): ``tokens`` and ``labels`` (B, S - P)
    int32, the Zipf-ish law ``min((u^-0.7 - 1)·40, V - 1)`` of the
    reference for u uniform in [1e-6, 1), labels the tokens shifted by
    one; ``patch_embeds`` (B, P, d) for a ``vit`` frontend (P =
    ``frontend_len``) and ``src_embeds`` (B, S, d) for an encoder-decoder,
    standard normal in the model's dtype."""
    dev = resolve_device(device)
    gen = torch.Generator().manual_seed(_stream_seed(dcfg.seed, step))
    B, S = dcfg.global_batch, dcfg.seq_len
    frontend = cfg.frontend_len if cfg.frontend == "vit" else 0
    u = torch.rand((B, S - frontend + 1), generator=gen) * (1.0 - 1e-6) \
        + 1e-6
    zipf = torch.clamp((u ** -0.7 - 1.0) * 40.0, max=cfg.vocab_size - 1)
    toks = zipf.to(torch.int32)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    dt = getattr(torch, cfg.dtype)
    if cfg.frontend == "vit":
        batch["patch_embeds"] = torch.randn(
            (B, frontend, cfg.d_model), generator=gen).to(dt)
    if cfg.enc_dec:
        batch["src_embeds"] = torch.randn((B, S, cfg.d_model),
                                          generator=gen).to(dt)
    return {k: v.contiguous().to(dev) for k, v in batch.items()}


# ---------------------------------------------------------------------------
# Straggler-aware microbatch dispatch (host-side control plane)
# ---------------------------------------------------------------------------
class StragglerAwareDispatcher:
    """Assigns ``num_microbatches`` per step across ``num_hosts``.

    Hosts get work inversely proportional to their EWMA step latency,
    bounded to ±max_skew of the fair share; a host flagged dead gets zero
    (its share is re-spread — crash handling works the same way)."""

    def __init__(self, num_hosts: int, num_microbatches: int, *,
                 ewma: float = 0.3, max_skew: float = 0.5):
        assert num_microbatches >= num_hosts
        self.num_hosts = num_hosts
        self.num_microbatches = num_microbatches
        self.ewma = ewma
        self.max_skew = max_skew
        self.latency = np.ones(num_hosts)
        self.alive = np.ones(num_hosts, bool)

    def report(self, host: int, step_latency: float):
        self.latency[host] = ((1 - self.ewma) * self.latency[host]
                              + self.ewma * step_latency)

    def mark_dead(self, host: int):
        self.alive[host] = False

    def mark_alive(self, host: int):
        self.alive[host] = True
        self.latency[host] = float(np.median(self.latency[self.alive]))

    def assignment(self) -> np.ndarray:
        """(num_hosts,) microbatch counts summing to num_microbatches."""
        speed = np.where(self.alive, 1.0 / self.latency, 0.0)
        if speed.sum() == 0:
            raise RuntimeError("no alive hosts")
        fair = self.num_microbatches / self.alive.sum()
        raw = self.num_microbatches * speed / speed.sum()
        lo = np.where(self.alive, np.floor(fair * (1 - self.max_skew)), 0)
        hi = np.where(self.alive, np.ceil(fair * (1 + self.max_skew)), 0)
        counts = np.clip(np.round(raw), lo, hi).astype(int)
        # repair rounding so counts sum exactly
        diff = self.num_microbatches - counts.sum()
        order = np.argsort(-speed)
        i = 0
        while diff != 0:
            h = order[i % len(order)]
            if self.alive[h]:
                step = 1 if diff > 0 else -1
                if lo[h] <= counts[h] + step <= hi[h] or (
                        diff > 0 and counts[h] + step <= hi[h]):
                    counts[h] += step
                    diff -= step
            i += 1
            if i > 10_000:
                counts[order[0]] += diff
                break
        return counts
