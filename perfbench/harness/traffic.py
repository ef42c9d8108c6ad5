"""The one traffic generator: it reads a mix's parameters
(``traffic/<name>.json``) and the seed.

A serving mix (``"kind": "closed_loop"``) is a stream of requests in
submission order, made in rounds of ``round`` requests.  Every round
holds the same prompt lengths (``prompt_len``: ``round`` quantiles of
its distribution) and the same output lengths (``max_new``: likewise),
so every seed asks for the same work.  The order of each round (which
prompt length goes with which output length, and in which place) comes
from the mix's own ``schedule_seed``, so that every run submits the
same lengths in the same order and the tails it reads do not move with
the run's seed; the run's seed draws the prompts' token ids, uniformly
over the vocabulary.  A training mix
(``"kind": "train"``) is batch and sequence sizes; its batches come from
:func:`harness.data.batch_at`."""
from __future__ import annotations

import math

import numpy as np

from .data import stream_seed

#: the step index of the request stream's generator
REQUEST_STREAM = 1 << 41


def quantiles(spec: dict, n: int) -> np.ndarray:
    """``n`` integer quantiles, at (i + 1/2) / n, of a length
    distribution: ``log_uniform`` or ``uniform`` over [lo, hi]."""
    u = (np.arange(n) + 0.5) / n
    lo, hi = spec["lo"], spec["hi"]
    if spec["dist"] == "log_uniform":
        x = np.exp(math.log(lo) + u * (math.log(hi) - math.log(lo)))
    elif spec["dist"] == "uniform":
        x = lo + u * (hi - lo)
    else:
        raise ValueError(f"unknown length distribution {spec['dist']!r}")
    return np.clip(np.rint(x), lo, hi).astype(np.int64)


class RequestStream:
    """Requests of a closed-loop mix in submission order: ``next()``
    gives (prompt token ids, max_new)."""

    def __init__(self, mix: dict, vocab_size: int, seed: int):
        self.mix = mix
        self.vocab_size = vocab_size
        self.rng = np.random.Generator(np.random.PCG64(
            stream_seed(seed, REQUEST_STREAM)))
        self.order = np.random.Generator(np.random.PCG64(
            stream_seed(mix["schedule_seed"], REQUEST_STREAM)))
        self.n = mix["round"]
        self.prompts = quantiles(mix["prompt_len"], self.n)
        self.outs = quantiles(mix["max_new"], self.n)
        self._queue: list = []

    def _round(self) -> None:
        lens = self.prompts[self.order.permutation(self.n)]
        outs = self.outs[self.order.permutation(self.n)]
        for S, new in zip(lens, outs):
            toks = self.rng.integers(0, self.vocab_size, size=int(S),
                                     dtype=np.int64)
            self._queue.append((toks, int(new)))

    def next(self) -> tuple:
        if not self._queue:
            self._round()
        return self._queue.pop(0)
