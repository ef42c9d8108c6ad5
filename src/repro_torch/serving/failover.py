"""Failover accounting types of the serving layer.

The port of the JAX package's ``repro/serving/failover.py``.  Two
producers fill these records: the closed-loop data plane
(:mod:`repro_torch.serving.dataplane`), which prices each mid-stream
move as a KV-cache migration or a re-prefill, and
:meth:`repro_torch.serving.split.SplitServer.generate_with_failover`.
Plain Python and numpy: no tensor math happens here.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List

#: the two mid-stream failover mechanisms: ``reprefill`` ships the raw
#: token stream back and recomputes the KV cache on the target;
#: ``migrate`` ships the actual cache leaves.
REPREFILL = "reprefill"
MIGRATE = "migrate"
FAILOVER_MODES = (REPREFILL, MIGRATE)


class ServerLostError(RuntimeError):
    """The edge server disappeared mid-stream (crash / cut backhaul).

    Raised by the edge half of a split call when the server is down;
    ``server`` names the lost server."""

    def __init__(self, server: str):
        super().__init__(f"edge server {server!r} lost mid-stream")
        self.server = server


@dataclasses.dataclass
class FailoverEvent:
    """One mid-stream server loss, handled by relaying the stream.

    lost        : name of the server that died
    tokens_done : tokens already generated when it died (all preserved)
    relay_s     : relay-back transmission delay paid for this failover
    relay_bits  : size of the re-shipped payload (bits)
    mode        : ``"reprefill"`` or ``"migrate"``
    """
    lost: str
    tokens_done: int
    relay_s: float
    relay_bits: float
    mode: str = REPREFILL


@dataclasses.dataclass
class FailoverReport:
    """The failovers of one run (empty = clean run) and what they cost."""
    events: List[FailoverEvent] = dataclasses.field(default_factory=list)

    @property
    def retries(self) -> int:
        return len(self.events)

    @property
    def relay_s(self) -> float:
        return sum(e.relay_s for e in self.events)

    @property
    def tokens_preserved(self) -> int:
        return sum(e.tokens_done for e in self.events)

    @property
    def by_mode(self) -> Dict[str, int]:
        out = {m: 0 for m in FAILOVER_MODES}
        for e in self.events:
            out[e.mode] += 1
        return out

    @property
    def relay_s_by_mode(self) -> Dict[str, float]:
        out = {m: 0.0 for m in FAILOVER_MODES}
        for e in self.events:
            out[e.mode] += e.relay_s
        return out


def leaf_bits(leaves) -> float:
    """Total payload bits of a nest of dicts/lists/tuples whose leaves
    are tensors or numpy arrays (what
    :meth:`repro_torch.serving.engine.InferenceEngine.export_cache`
    returns)."""
    if isinstance(leaves, dict):
        return sum(leaf_bits(v) for v in leaves.values())
    if isinstance(leaves, (list, tuple)):
        return sum(leaf_bits(v) for v in leaves)
    if hasattr(leaves, "element_size"):                  # torch.Tensor
        return float(leaves.numel()) * float(leaves.element_size()) * 8.0
    return float(leaves.size) * float(leaves.dtype.itemsize) * 8.0


def migration_price(cache_bits: float, hops: float,
                    bandwidth_hz: float) -> float:
    """Seconds to ship a stream's KV-cache leaves to the target server:
    Eq. 41's H₂ relay pricing on the cache payload, no recompute."""
    from repro_torch.core.costs import relay_seconds
    return relay_seconds(cache_bits, hops, bandwidth_hz)


def reprefill_price(ctx_tokens: int, bits_per_token: float, hops: float,
                    bandwidth_hz: float, token_s: float) -> float:
    """Seconds to re-prefill a stream on the target server: the token
    activations relayed back (Eq. 41's H₂ path) plus the prefill
    recompute of the whole context at ``token_s`` per token."""
    from repro_torch.core.costs import relay_seconds
    return (relay_seconds(ctx_tokens * bits_per_token, hops, bandwidth_hz)
            + ctx_tokens * float(token_s))
