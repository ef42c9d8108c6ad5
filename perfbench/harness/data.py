"""A frozen copy of the program's token-batch generator
(``runtime/data.py``'s ``batch_at`` for a text-only model): batches are a
pure function of (seed, step), drawn with a CPU generator."""
from __future__ import annotations

import torch


def stream_seed(seed: int, step: int) -> int:
    """One 63-bit generator seed from (seed, step)."""
    return (int(seed) * 0x9E3779B97F4A7C15 + int(step)) % (1 << 63)


def batch_at(vocab_size: int, batch: int, seq: int, seed: int, step: int,
             device="cpu") -> dict:
    """``tokens`` and ``labels`` (batch, seq) int32 of step ``step``: the
    Zipf-like law min((u^-0.7 - 1)·40, V - 1) for u uniform in
    [1e-6, 1), the labels the tokens shifted by one."""
    gen = torch.Generator().manual_seed(stream_seed(seed, step))
    u = torch.rand((batch, seq + 1), generator=gen) * (1.0 - 1e-6) + 1e-6
    zipf = torch.clamp((u ** -0.7 - 1.0) * 40.0, max=vocab_size - 1)
    toks = zipf.to(torch.int32)
    return {"tokens": toks[:, :-1].contiguous().to(device),
            "labels": toks[:, 1:].contiguous().to(device)}
