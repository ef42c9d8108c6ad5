"""Deterministic fake engine implementing the data plane's engine
protocol (submit/admit/step/cancel/pop_result + cache export/import).

Token rule: ``next = last(prompt ++ out) + 1`` — pure, instant, and
migration-consistent: re-prefilling prompt + produced on another engine
continues the same arithmetic sequence, and so does importing the
"cache" (the fake cache carries no state the token rule needs, only a
payload whose size the data plane prices).  That makes this double a
drop-in for the differential failover tests: stream identity across
re-prefill AND migration holds by construction, so any divergence is a
data-plane bug, not a model artifact.

``cache_bytes_per_token`` tunes the priced payload (``export_cache``
returns ``pos * cache_bytes_per_token`` bytes), so tests can place the
migrate-vs-reprefill price comparison on either side of the boundary —
see tests/test_failover_modes.py.  Subclass to change it:

    class FatCache(FakeEngine):
        cache_bytes_per_token = 10**6

The port's copy of the JAX package's ``repro/testing/fake_engine.py``,
so the port's tests inject an engine of the port's own (tokens as plain
ints, the priced "cache" a numpy array, as there).
"""
from __future__ import annotations

import numpy as np

from repro_torch.serving.engine import CacheOverflowError


class _FakeReq:
    def __init__(self, rid, tokens, max_new):
        self.rid = rid
        self.tokens = np.asarray(tokens)
        self.max_new = max_new
        self.out = []

    @property
    def done(self):
        return len(self.out) >= self.max_new

    @property
    def last(self):
        return int(self.out[-1]) if self.out else int(self.tokens[-1])


class FakeEngine:
    """Next token = last(prompt ++ out) + 1: pure, instant, and
    migration-consistent (re-prefilling prompt + produced continues the
    same sequence)."""

    #: bytes of fake KV cache per cached position — what export_cache
    #: ships and the data plane prices (tune via subclass)
    cache_bytes_per_token = 64
    #: positions available per slot; import_cache raises
    #: CacheOverflowError past it (mirrors the real engine's cache_len)
    cache_len = 1 << 30

    def __init__(self, slots):
        self.slots = int(slots)
        self.requests = {}
        self._active = {}
        self._queue = []
        self._next_rid = 0

    @property
    def free_slots(self):
        return self.slots - len(self._active)

    def submit(self, tokens, max_new):
        rid = self._next_rid
        self._next_rid += 1
        self._queue.append(_FakeReq(rid, tokens, max_new))
        return rid

    def admit(self):
        admitted = []
        while self._queue and self.free_slots > 0:
            req = self._queue.pop(0)
            req.out.append(req.last + 1)       # prefill emits token #1
            self.requests[req.rid] = req
            if not req.done:
                self._active[req.rid] = req
            admitted.append(req.rid)
        return admitted

    def step(self):
        self.admit()
        emitted = []
        for rid, req in list(self._active.items()):
            req.out.append(req.last + 1)
            emitted.append((rid, req.out[-1]))
            if req.done:
                del self._active[rid]
        return emitted

    def cancel(self, rid):
        for i, req in enumerate(self._queue):
            if req.rid == rid:
                self._queue.pop(i)
                return list(req.out)
        self._active.pop(rid, None)
        return list(self.requests.pop(rid).out)

    def pop_result(self, rid):
        self._active.pop(rid, None)
        return list(self.requests.pop(rid).out)

    # -- cache migration (same contract as InferenceEngine) -------------
    def export_cache(self, rid):
        """(leaves, pos) for a running stream: pos mirrors the real
        engine — prompt + produced minus the last token, which is not
        yet written to cache."""
        req = self._active.get(rid) or self.requests.get(rid)
        if req is None:
            raise KeyError(f"rid {rid} has no active slot")
        pos = len(req.tokens) + len(req.out) - 1
        leaves = [np.zeros((pos, self.cache_bytes_per_token), np.uint8)]
        return leaves, pos

    def import_cache(self, tokens, max_new, leaves, pos):
        """Adopt a migrated stream: goes straight to active, emits NO
        admission token (the next token comes from the next step —
        exactly the real engine's import semantics)."""
        pos = int(pos)
        if max_new < 1:
            raise ValueError("import_cache needs max_new >= 1")
        if pos + max_new > self.cache_len:
            raise CacheOverflowError(
                f"migrated prefix (pos={pos}) + {max_new} decode "
                f"position(s) exceed cache_len={self.cache_len}")
        if self.free_slots <= 0:
            raise RuntimeError("import_cache: no free slot")
        rid = self._next_rid
        self._next_rid += 1
        req = _FakeReq(rid, tokens, max_new)
        self.requests[rid] = req
        self._active[rid] = req
        return rid
