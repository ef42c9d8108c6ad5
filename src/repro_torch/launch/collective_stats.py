"""Collective traffic of a program from the collectives it emitted.

The counterpart of the JAX package's ``repro/launch/hlo_stats.py``.
The reference parses the compiled, post-SPMD HLO for every collective
and weights the ones inside loops by their trip counts.  The port has
no HLO: it emits its collectives itself, explicitly, through
``runtime.meshenv.MeshEnv``, and a ``RecordingEnv`` keeps a record of
each one the program emits (``(kind, bytes, group_size, phase)``, one
entry an emission, so a loop's collectives appear once an iteration and
need no trip count).  :func:`collect_stats` fills the reference's
:class:`CollectiveStats` from that record.

``bytes`` follows the reference's convention: an all-reduce moves its
tensor, an all-gather its output (every member's piece).  ``link_bytes``
weights each op by its ring factor on a ring of its group's size
(:func:`_ring_factor`, the reference's), the per-link load.  The port
emits only ``all-reduce`` and ``all-gather``; the other kinds keep the
reference's factors.  ``shape_bytes`` reads HLO shape strings and has no
counterpart here.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterable, List, Sequence

COLLECTIVE_KINDS = ("all-gather", "all-reduce", "reduce-scatter",
                    "all-to-all", "collective-permute")


@dataclasses.dataclass
class CollectiveOp:
    kind: str
    bytes: int                 # moved bytes (per device)
    computation: str           # "fwd" or "bwd": the phase that emitted it
    line: str                  # a readable description of the op


@dataclasses.dataclass
class CollectiveStats:
    ops: List[CollectiveOp]
    bytes_by_kind: Dict[str, int]
    total_bytes: int
    link_bytes: float                   # ring-weighted per-link traffic
    counts: Dict[str, int]

    def summary(self) -> str:
        parts = [f"{k}: {v / 1e6:.1f} MB ×{self.counts.get(k, 0)}"
                 for k, v in sorted(self.bytes_by_kind.items()) if v]
        return "; ".join(parts) or "none"


def _ring_factor(kind: str, n: int) -> float:
    if n <= 1:
        return 0.0
    if kind == "all-reduce":
        return 2.0 * (n - 1) / n
    if kind in ("all-gather", "reduce-scatter", "all-to-all"):
        return (n - 1) / n
    return 1.0                           # collective-permute


def collect_stats(record: Iterable[Sequence]) -> CollectiveStats:
    """The reference's statistics of a list of recorded collectives,
    each ``(kind, bytes, group size, "fwd" | "bwd")``.  Each entry names
    its group's size, so the reference's ``total_devices`` (the mesh's
    size, its fallback where HLO names no group) has no counterpart."""
    ops: List[CollectiveOp] = []
    bytes_by_kind: Dict[str, int] = {}
    counts: Dict[str, int] = {}
    link_bytes = 0.0
    for kind, nbytes, n, phase in record:
        ops.append(CollectiveOp(kind=kind, bytes=nbytes, computation=phase,
                                line=f"{kind} {nbytes} B over {n} "
                                     f"({phase})"))
        bytes_by_kind[kind] = bytes_by_kind.get(kind, 0) + nbytes
        counts[kind] = counts.get(kind, 0) + 1
        link_bytes += nbytes * _ring_factor(kind, n)
    return CollectiveStats(ops=ops, bytes_by_kind=bytes_by_kind,
                           total_bytes=sum(bytes_by_kind.values()),
                           link_bytes=link_bytes, counts=counts)


__all__ = ["COLLECTIVE_KINDS", "CollectiveOp", "CollectiveStats",
           "collect_stats"]
