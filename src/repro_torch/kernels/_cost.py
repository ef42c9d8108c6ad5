"""The kernel ops' cost reports, for a count over a program's run.

A count (``repro_torch.launch.costs.count``) counts a program's aten
ops through PyTorch's dispatch modes: flops by ``FlopCounterMode``,
bytes and live storage by its own mode.  A kernel op (RMSNorm, flash
attention, the MoE SwiGLU, the RG-LRU scan, WKV6, each forward and
backward) is one CUDA launch on the card, a plain version made of aten
ops on the CPU, and empty outputs on ``meta``; so that a program counts
the same on all three, :func:`run` executes the op's body with every
dispatch mode suspended and reports the CUDA route's own work instead:
its flops and HBM bytes by a formula of the shapes (each op's
``_cost_*``, the numerators of PERF.md §6's bounds), its fresh outputs
and the workspace its CUDA route allocates.  With no count active,
:func:`run` calls the body and nothing else.
"""
from __future__ import annotations

from typing import Callable, List, Optional

from torch.utils._python_dispatch import _disable_current_modes

#: the active counts, innermost last (``launch/costs.py`` pushes them)
ACTIVE: List[object] = []


def active() -> Optional[object]:
    """The innermost active count, or None."""
    return ACTIVE[-1] if ACTIVE else None


def run(name: str, cost: Callable[[], tuple], body: Callable, inputs=()):
    """``body()``, reported to the active count as kernel ``name``.

    ``cost()`` gives (flops, HBM bytes, workspace bytes) of the CUDA
    route at these shapes; ``inputs`` are the op's tensor arguments (an
    output that is one of them, written in place, is not new storage).
    """
    count = active()
    if count is None:
        return body()
    with _disable_current_modes():
        out = body()
        flops, moved, workspace = cost()
        return count.kernel(name, flops, moved, workspace, out, inputs)


__all__ = ["ACTIVE", "active", "run"]
