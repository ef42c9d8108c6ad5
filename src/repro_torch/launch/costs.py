"""A program's costs, counted over one run: flops, bytes, peak memory.

:func:`count` is one context manager over a run of a program (the dry
run's cell programs on ``meta``, or the same program on the card or the
CPU).  It gathers three things:

* **flops**: ``torch.utils.flop_counter.FlopCounterMode``'s total over
  the aten ops (the products and convolutions), plus each kernel op's
  report (:mod:`repro_torch.kernels._cost`);
* **bytes**: a dispatch mode adds each aten op's input and output bytes
  (tensors as their elements x element size; views and the ``empty``
  factories move nothing and count nothing), plus each kernel op's
  report.  The port runs eagerly, so this is the traffic its unfused
  ops move; XLA's "bytes accessed" of a fused program is another thing;
* **peak**: the live bytes of the storages the run creates, at their
  largest, above what existed before (the arguments): each new storage
  an aten op returns adds its size until it is freed (a
  ``weakref.finalize`` on the storage, whose Python object lives as long
  as the storage does); a kernel op adds its outputs and, while it
  runs, the workspace its CUDA route allocates.  On ``meta`` a storage
  has a size and no memory; the count follows creation and release,
  not an allocator, so it is the same on every device.

A kernel op runs with these modes suspended and reports the CUDA route's
work from its shapes, so the count of one program is the same on
``meta``, ``cpu`` and ``cuda``.  Autograd's backward (remat's second
forward in it) is counted as it runs.
"""
from __future__ import annotations

import contextlib
import dataclasses
import weakref
from typing import Dict

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.kernels import _cost

_aten = torch.ops.aten
#: factories whose output is not written: no traffic
_NO_TRAFFIC = {_aten.empty.memory_format, _aten.empty_like.default,
               _aten.empty_strided.default, _aten.new_empty.default,
               _aten.new_empty_strided.default}


def _tensors(tree, out=None) -> list:
    """The tensors of an op's arguments or outputs (tuples, lists and
    dicts of them), in order."""
    out = [] if out is None else out
    if isinstance(tree, torch.Tensor):
        out.append(tree)
    elif isinstance(tree, (tuple, list)):
        for x in tree:
            _tensors(x, out)
    elif isinstance(tree, dict):
        for x in tree.values():
            _tensors(x, out)
    return out


def _key(t: torch.Tensor) -> int:
    return t.untyped_storage()._cdata


@dataclasses.dataclass
class Count:
    """What :func:`count` gathered: ``flops`` (aten + kernels), ``bytes``
    (aten + kernels), ``peak`` and ``live`` bytes above the start, and,
    a kernel name each, ``kernels[name] = {"calls", "flops", "bytes"}``."""
    aten_flops: int = 0
    kernel_flops: float = 0.0
    bytes: float = 0.0
    peak: int = 0
    live: int = 0
    kernels: Dict[str, dict] = dataclasses.field(default_factory=dict)
    _tracked: Dict[int, int] = dataclasses.field(default_factory=dict,
                                                 repr=False)

    @property
    def flops(self) -> float:
        return self.aten_flops + self.kernel_flops

    # -- storage tracking ------------------------------------------------
    def _release(self, key: int, size: int) -> None:
        self.live -= size
        del self._tracked[key]

    def _add(self, t: torch.Tensor, size: int) -> None:
        key = _key(t)
        self._tracked[key] = size
        self.live += size
        self.peak = max(self.peak, self.live)
        weakref.finalize(t.untyped_storage(), self._release, key, size)

    def track(self, outs, ins) -> None:
        """Add each output storage that is new: not tracked already and
        not one of the op's inputs' (a view or an in-place write)."""
        seen = {_key(t) for t in ins}
        for t in outs:
            k = _key(t)
            if k in self._tracked or k in seen:
                continue
            seen.add(k)
            self._add(t, t.untyped_storage().nbytes())

    # -- kernel reports --------------------------------------------------
    def kernel(self, name: str, flops: float, moved: float, workspace: int,
               out, inputs):
        """A kernel op's report (``kernels._cost.run``, modes suspended):
        its work, its fresh outputs, each contiguous in storage of its
        own, as the CUDA route allocates them (a plain version's output
        that is a strided view, shares or outgrows its storage is
        copied), so that their bytes, lifetimes and later views are the
        CUDA route's, and its workspace on top of them."""
        rec = self.kernels.setdefault(name, {"calls": 0, "flops": 0.0,
                                             "bytes": 0.0})
        rec["calls"] += 1
        rec["flops"] += flops
        rec["bytes"] += moved
        self.kernel_flops += flops
        self.bytes += moved
        ins = {_key(t) for t in _tensors(inputs)}
        seen = set()

        def own(t):
            if not isinstance(t, torch.Tensor) or _key(t) in ins:
                return t
            size = t.numel() * t.element_size()
            if (_key(t) in seen or not t.is_contiguous()
                    or t.untyped_storage().nbytes() != size):
                t = t.clone(memory_format=torch.contiguous_format)
            seen.add(_key(t))
            self._add(t, size)
            return t

        out = (tuple(own(t) for t in out) if isinstance(out, tuple)
               else own(out))
        # the CUDA routes allocate the outputs first, then the workspace
        self.peak = max(self.peak, self.live + int(workspace))
        return out


class _Traffic(TorchDispatchMode):
    """Bytes and live storage of every aten op, into a :class:`Count`."""

    def __init__(self, c: Count):
        super().__init__()
        self.c = c

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        ins, outs = _tensors((args, kwargs)), _tensors(out)
        if func not in _NO_TRAFFIC and not func.is_view:
            self.c.bytes += sum(t.numel() * t.element_size()
                                for t in ins + outs)
        self.c.track(outs, ins)
        return out


@contextlib.contextmanager
def count():
    """Count the program run inside: yields a :class:`Count`, complete
    when the block exits."""
    c = Count()
    flops = FlopCounterMode(display=False)
    _cost.ACTIVE.append(c)
    try:
        with flops, _Traffic(c):
            yield c
    finally:
        _cost.ACTIVE.remove(c)
        c.aten_flops = int(flops.get_total_flops())


__all__ = ["Count", "count"]
