"""Batched serving engine: continuous-batching prefill/decode over slot
state, on one card.

The port of the JAX package's ``repro/serving/engine.py``.  The engine
owns a fixed pool of batch slots.  Requests are admitted into free slots
(FIFO); each admission prefills its prompt at its true length and emits
the first token; each :meth:`InferenceEngine.step` runs ONE decode for
all slots with per-slot positions; finished requests free their slots.
This is the edge-server role of the MCSA system: the planner decides
per-user splits and resource shares, the engine burns those compute
units.

The cache pool is a list with one cache tree per block, as
``transformer.init_caches`` builds it for ``slots`` rows: ``{"k", "v"}``
of (slots, L, Hkv, hd) for attention (L = cache_len, or a ring of
min(window, cache_len) slots for a sliding-window block), ``{"mix":
{"s", "tm"}, "ffn": {"cm"}}`` of recurrent state for RWKV-6 and
``{"mix": {"h", "conv"}}`` for RG-LRU.  Slot ``i`` is row ``i`` of every
leaf.  Decode and admission write into the pool in place.  A
cache migrates between engines with
:meth:`~InferenceEngine.export_cache` /
:meth:`~InferenceEngine.import_cache`: the k/v leaves cropped to the
stream's filled prefix (a ring that has wrapped is whole), state
leaves whole.

A request must fit its cache: :meth:`InferenceEngine.submit` refuses one
whose prompt and new tokens need more than ``cache_len`` positions (the
reference accepts it, drops the global cache's writes past the end and
so corrupts the stream), so a ring shorter than the window never wraps.

On a mesh (``env``, a ``runtime.meshenv.MeshEnv``; ``params`` this
rank's slices, ``interop.shard_lm_params``) every rank runs the same
host bookkeeping (queue, slot assignment, positions, finished requests)
and so returns the same results.  The pool is ``init_caches(env=)``'s:
the slots split over the batch axes when they divide them (the
reference's batch rule; else every data rank holds every slot) and each
leaf over the model axis by the reference's ``_kv_spec`` and state
specs (``transformer.cache_specs``).  Admission prefills the request
with ``prefill(env=)`` and only the rank that owns the slot writes its
rows (re-cut from the one-row prefill's layout when the two differ);
:meth:`~InferenceEngine.step` calls ``decode_step(env=, specs=)`` and
gathers the next tokens over the batch axes;
:meth:`~InferenceEngine.export_cache` gathers a slot whole and
:meth:`~InferenceEngine.import_cache` cuts it again.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Tuple

import numpy as np
import torch

from repro_torch._device import resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.models import transformer as tfm
from repro_torch.models.sharded_ops import sharded_argmax
from repro_torch.runtime.meshenv import CPU_ENV, MeshEnv, P

Params = dict


@dataclasses.dataclass
class Request:
    rid: int
    tokens: np.ndarray              # prompt (S,)
    max_new: int
    out: List[int] = dataclasses.field(default_factory=list)

    @property
    def done(self) -> bool:
        return len(self.out) >= self.max_new


@dataclasses.dataclass
class DecodeState:
    caches: List[dict]              # per block cache tree, slots rows
    last_token: torch.Tensor        # (slots, 1)
    pos: np.ndarray                 # (slots,) per-slot positions
    active: np.ndarray              # (slots,) bool


class CacheOverflowError(RuntimeError):
    """A migrated cache prefix does not fit the target slot's cache.

    Raised by :meth:`InferenceEngine.submit` when a request's positions
    (prompt + max_new - 1) exceed ``cache_len``, by
    :meth:`InferenceEngine.import_cache` when the imported prefix would
    leave no room for the remaining decode writes (``pos + max_new >
    cache_len``), and by the per-slot cache write when an incoming leaf
    exceeds the pool leaf along any axis.  Cropping
    either would corrupt the stream's KV state."""


class IncompleteRunError(RuntimeError):
    """``run_to_completion`` ran out of steps with work still in flight.

    Carries the surviving request ids; ``partial`` holds the outputs
    produced so far for every request the engine has seen."""

    def __init__(self, queued: List[int], active: List[int],
                 partial: Dict[int, List[int]]):
        super().__init__(
            f"run_to_completion exhausted max_steps with "
            f"{len(queued)} queued and {len(active)} active request(s)")
        self.queued = queued
        self.active = active
        self.partial = partial


def _bucket(n: int, buckets=(64, 128, 256, 512, 1024, 2048, 4096)) -> int:
    """Prefill length bucket of an ``n``-token prompt.  The reference pads
    prompts to it to bound its compile count; prefill still runs at the
    true length, so the bucket only sizes the padded prompt buffer."""
    for b in buckets:
        if n <= b:
            return b
    return -(-n // 4096) * 4096


#: the cache leaves that have a cache-length axis (axis 1); every other
#: leaf is recurrent state, which has none and ships whole
CACHE_LEN_LEAVES = ("k", "v")


def _leaf_pairs(pool: dict, *others: dict):
    """(pool leaf, each of ``others``' leaves at the same key path) for
    every leaf of one block's cache tree."""
    for key, sub in pool.items():
        if isinstance(sub, dict):
            yield from _leaf_pairs(sub, *(o[key] for o in others))
        else:
            yield (sub,) + tuple(o[key] for o in others)


def _export_tree(tree: dict, slot: int, pos: int) -> dict:
    """Copies of row ``slot`` of every leaf of a block's cache tree, the
    leaves with a cache-length axis cropped to ``pos`` positions.  Which
    leaves those are follows from their names, not from their sizes: the
    reference's ``_cache_axes`` takes the first axis after the slot axis
    whose size equals ``cache_len``, so it crops an RWKV state
    (slots, H, n, n) to ``pos`` rows of k when ``cache_len == n`` (and
    ``tm``/``cm`` when ``cache_len == d_model``)."""
    out = {}
    for key, sub in tree.items():
        if isinstance(sub, dict):
            out[key] = _export_tree(sub, slot, pos)
        else:
            row = sub[slot:slot + 1]
            out[key] = (row[:, :pos] if key in CACHE_LEN_LEAVES
                        else row).clone()
    return out


def _slot_write(pool: torch.Tensor, one: torch.Tensor, slot: int) -> None:
    """Write a single-request leaf (1, L', ...) into row ``slot`` of the
    pool leaf (slots, L, ...), zero-filling past L'.  A leaf longer than
    the pool along any axis raises :class:`CacheOverflowError` — cropping
    would throw away live KV state."""
    target = (1,) + tuple(pool.shape[1:])
    over = [i for i, (a, b) in enumerate(zip(one.shape, target)) if a > b]
    if over or one.dim() != pool.dim():
        raise CacheOverflowError(
            f"cache leaf {tuple(one.shape)} exceeds pool slot {target} on "
            f"axes {over}")
    row = pool[slot]
    row.zero_()
    row[tuple(slice(0, n) for n in one.shape[1:])] = one[0].to(pool.dtype)


def _row_spec(spec: P) -> P:
    """A cache leaf's spec with its slot (batch) entry dropped."""
    return P(None, *tuple(spec)[1:])


def _whole_shape(local: torch.Tensor, spec: P, env: MeshEnv) -> tuple:
    """The logical shape of one slot of a pool leaf from its local
    piece: each dim past the slot's times the size of its axes."""
    ent = tuple(spec) + (None,) * (local.dim() - len(spec))
    return (1,) + tuple(n * env.axis_size(e)
                        for n, e in zip(local.shape[1:], ent[1:]))


def _pad_to(one: torch.Tensor, shape: tuple) -> torch.Tensor:
    """``one`` (1, L', ...) zero-padded to ``shape``; raises
    :class:`CacheOverflowError` where it is longer."""
    over = [i for i, (a, b) in enumerate(zip(one.shape, shape)) if a > b]
    if over or one.dim() != len(shape):
        raise CacheOverflowError(
            f"cache leaf {tuple(one.shape)} exceeds pool slot {shape} on "
            f"axes {over}")
    if tuple(one.shape) == tuple(shape):
        return one
    out = one.new_zeros(shape)
    out[tuple(slice(0, n) for n in one.shape)] = one
    return out


class InferenceEngine:
    """Continuous batching over ``slots`` slots of ``cache_len`` positions
    on ``device`` (``None`` means the card, and raises without one;
    ``"cpu"`` takes the plain PyTorch path).  ``params`` must live on
    that device: the whole tree on one process, this rank's slices
    under ``env`` on a mesh (the module says how the pool and the steps
    split there)."""

    def __init__(self, cfg: ModelConfig, params: Params, *, device=None,
                 slots: int = 4, cache_len: int = 512,
                 env: MeshEnv = CPU_ENV):
        tfm.check_supported(cfg, env)
        if cfg.enc_dec:
            raise ValueError(f"{cfg.name}: InferenceEngine serves decoder-only "
                             "stacks (its prefill takes tokens only, as "
                             "the reference's does)")
        self.device = resolve_device(device)
        if params["embed"].device.type != self.device.type:
            raise ValueError(f"params on {params['embed'].device}, engine "
                             f"on {self.device}")
        self.cfg = cfg
        self.params = params
        self.env = env
        self.slots = slots
        self.cache_len = cache_len
        self.requests: Dict[int, Request] = {}
        self.slot_of: Dict[int, int] = {}
        # on a mesh: the pool's specs, the axes its slots split over, and
        # the one-row prefill's specs
        self.specs = self._one_specs = self._b_ax = None
        if env.is_spmd:
            self.specs = tfm.cache_specs(cfg, env, slots, cache_len)
            self._one_specs = tfm.cache_specs(cfg, env, 1, cache_len)
            self._b_ax = env.batch_if(slots)
        self.state = DecodeState(
            caches=tfm.init_caches(cfg, slots, cache_len, self.device,
                                   env=env),
            last_token=torch.zeros((slots, 1), dtype=torch.long,
                                   device=self.device),
            pos=np.zeros((slots,), np.int64),
            active=np.zeros((slots,), bool))
        self._queue: List[Request] = []
        self._next_rid = 0

    # ------------------------------------------------------------------
    def _local_row(self, slot: int):
        """The pool row of ``slot`` on this rank, or None when another
        data rank owns it."""
        if self._b_ax is None:
            return slot
        n = self.slots // self.env.dp
        row = slot - self.env.axis_index(self._b_ax) * n
        return row if 0 <= row < n else None

    def _write_slot(self, caches: List[dict], slot: int,
                    specs: List[dict] = None) -> None:
        """Write single-request cache trees into ``slot``'s rows: on a
        mesh, ``caches`` are this rank's pieces under ``specs``
        (re-cut to the pool's layout when it differs), or whole trees
        when ``specs`` is None; only the rank that owns the slot
        writes."""
        if not self.env.is_spmd:
            for pool, one in zip(self.state.caches, caches):
                for leaf, new in _leaf_pairs(pool, one):
                    _slot_write(leaf, new.to(self.device), slot)
            return
        row = self._local_row(slot)
        env = self.env
        whole = specs is None
        for pool, one, psp, osp in zip(self.state.caches, caches, self.specs,
                                       specs or self.specs):
            for leaf, new, sp, nsp in _leaf_pairs(pool, one, psp, osp):
                rest = _row_spec(sp)
                if whole:
                    new = env.shard(_pad_to(new.to(self.device),
                                            _whole_shape(leaf, sp, env)),
                                    rest)
                elif tuple(nsp)[1:] != tuple(rest)[1:]:
                    new = env.shard(env.unshard(new, nsp), rest)
                if row is not None:
                    _slot_write(leaf, new, row)

    def _slot_leaves(self, slot: int) -> List[dict]:
        """Copies of ``slot``'s row of every pool leaf, whole: on a mesh
        gathered from the rank that owns the slot and over the model
        axis (every rank calls it)."""
        env = self.env

        def whole(tree, spec):
            out = {}
            for key, sub in tree.items():
                if isinstance(sub, dict):
                    out[key] = whole(sub, spec[key])
                    continue
                if self._b_ax is None:
                    row = sub[slot:slot + 1]
                else:
                    n = self.slots // env.dp
                    row = env.all_gather(sub[slot % n:slot % n + 1], 0,
                                         self._b_ax)[slot // n:slot // n + 1]
                out[key] = env.unshard(row, _row_spec(spec[key])).clone()
            return out

        return [whole(c, sp) for c, sp in zip(self.state.caches, self.specs)]

    @property
    def free_slots(self) -> int:
        """Number of slots not currently running a request."""
        return int(self.slots - self.state.active.sum())

    def submit(self, tokens: np.ndarray, max_new: int) -> int:
        """Queue a request; raises :class:`CacheOverflowError` when its
        prompt and the ``max_new - 1`` decode writes after it need more
        than ``cache_len`` positions."""
        if len(tokens) + max_new - 1 > self.cache_len:
            raise CacheOverflowError(
                f"request of {len(tokens)} prompt token(s) + {max_new} new "
                f"needs {len(tokens) + max_new - 1} positions > "
                f"cache_len={self.cache_len}")
        rid = self._next_rid
        self._next_rid += 1
        self._queue.append(Request(rid=rid, tokens=np.asarray(tokens),
                                   max_new=max_new))
        return rid

    def admit(self) -> List[int]:
        """Admit queued requests into free slots, FIFO.  Each admission
        prefills the prompt and emits the first token.  Returns the rids
        admitted this call, in admission order."""
        admitted: List[int] = []
        free = [i for i in range(self.slots) if not self.state.active[i]]
        while free and self._queue:
            slot = free.pop(0)
            req = self._queue.pop(0)
            S = len(req.tokens)
            prompt = np.zeros((1, _bucket(S)), np.int64)
            prompt[0, :S] = req.tokens
            tokens = torch.from_numpy(prompt[:, :S]).to(self.device)
            logits, caches = tfm.prefill(self.cfg, self.params,
                                         {"tokens": tokens},
                                         cache_len=self.cache_len,
                                         env=self.env)
            if self.env.is_spmd:            # the vocab shards' argmax
                nxt = int(sharded_argmax(logits, env=self.env)[0])
            else:
                nxt = int(torch.argmax(logits[0, :self.cfg.vocab_size]))
            req.out.append(nxt)
            self._write_slot(caches, slot, self._one_specs)
            self.state.last_token[slot, 0] = nxt
            self.state.pos[slot] = S
            self.state.active[slot] = True
            self.requests[req.rid] = req
            if req.done:
                # max_new == 1: the prefill token satisfied the request
                self.state.active[slot] = False
                free.insert(0, slot)
            else:
                self.slot_of[req.rid] = slot
            admitted.append(req.rid)
        return admitted

    def cancel(self, rid: int) -> List[int]:
        """Abort a request (queued or active), freeing its slot.  Returns
        the tokens produced so far; the request is forgotten."""
        for i, req in enumerate(self._queue):
            if req.rid == rid:
                self._queue.pop(i)
                return list(req.out)
        slot = self.slot_of.pop(rid, None)
        if slot is not None:
            self.state.active[slot] = False
        req = self.requests.pop(rid, None)
        if req is None:
            raise KeyError(f"unknown rid {rid}")
        return list(req.out)

    def pop_result(self, rid: int) -> List[int]:
        """Remove a finished request and return its output tokens."""
        req = self.requests.pop(rid)
        self.slot_of.pop(rid, None)
        return list(req.out)

    # -- KV-cache migration --------------------------------------------
    def export_cache(self, rid: int):
        """An active stream's cache for migration: ``(leaves, pos)``,
        ``leaves`` one cache tree per block with the stream's row of every
        leaf (copies, so the engine may go on writing its pool): k/v
        cropped to (1, pos, Hkv, hd), recurrent state whole; ``pos`` the
        filled positions.  The engine state is untouched.  On a mesh the
        leaves are whole, gathered from every rank that holds a piece
        (every rank calls it and gets the same)."""
        slot = self.slot_of.get(rid)
        if slot is None:
            raise KeyError(f"rid {rid} has no active slot")
        pos = int(self.state.pos[slot])
        if self.env.is_spmd:
            leaves = [_export_tree(c, 0, pos)
                      for c in self._slot_leaves(slot)]
        else:
            leaves = [_export_tree(c, slot, pos) for c in self.state.caches]
        return leaves, pos

    def import_cache(self, tokens: np.ndarray, max_new: int, leaves,
                     pos: int) -> int:
        """Resume a migrated stream from its shipped cache prefix.

        ``tokens`` is the full context so far (its last entry becomes the
        decode input), ``max_new`` the tokens still to generate,
        ``(leaves, pos)`` what :meth:`export_cache` returned.  Raises
        :class:`CacheOverflowError` when ``pos + max_new > cache_len``
        (position ``pos`` itself must still be writable) and
        ``RuntimeError`` when no slot is free.  On a mesh ``leaves`` are
        whole and each rank keeps its piece of them."""
        pos = int(pos)
        tokens = np.asarray(tokens)
        if max_new < 1:
            raise ValueError("import_cache needs max_new >= 1 (a "
                             "finished stream has nothing to migrate)")
        if pos < 1 or len(tokens) < 1:
            raise ValueError("import_cache needs a non-empty prefix")
        if pos + max_new > self.cache_len:
            raise CacheOverflowError(
                f"migrated prefix (pos={pos}) + {max_new} decode "
                f"position(s) exceed cache_len={self.cache_len}")
        free = [i for i in range(self.slots) if not self.state.active[i]]
        if not free:
            raise RuntimeError("import_cache: no free slot")
        slot = free[0]
        self._write_slot(leaves, slot)
        rid = self._next_rid
        self._next_rid += 1
        req = Request(rid=rid, tokens=tokens, max_new=max_new)
        self.state.last_token[slot, 0] = int(tokens[-1])
        self.state.pos[slot] = pos
        self.state.active[slot] = True
        self.requests[rid] = req
        self.slot_of[rid] = slot
        return rid

    # ------------------------------------------------------------------
    def step(self) -> List[Tuple[int, int]]:
        """Admit + one decode for all slots.  Returns [(rid, token)]
        emitted this step."""
        self.admit()
        if not self.state.active.any():
            return []
        pos = torch.from_numpy(self.state.pos.copy()).to(self.device)
        _, nxt, _ = tfm.decode_step(self.cfg, self.params,
                                    self.state.last_token, pos,
                                    self.state.caches, env=self.env,
                                    specs=self.specs)
        if self._b_ax is not None:          # every slot's, on every rank
            nxt = self.env.all_gather(nxt, 0, self._b_ax)
        self.state.last_token = nxt[:, None]
        nxt_np = nxt.cpu().numpy()
        emitted = []
        for rid, slot in list(self.slot_of.items()):
            if not self.state.active[slot]:
                continue
            req = self.requests[rid]
            tok = int(nxt_np[slot])
            req.out.append(tok)
            self.state.pos[slot] += 1
            emitted.append((rid, tok))
            if req.done:
                self.state.active[slot] = False
                del self.slot_of[rid]
        return emitted

    def run_to_completion(self, max_steps: int = 10_000, *,
                          strict: bool = True):
        """Step until every submitted request finishes.

        Raises :class:`IncompleteRunError` if ``max_steps`` runs out with
        requests still queued or active; ``strict=False`` returns the
        partial outputs instead (in-flight requests stay resident)."""
        while (self._queue or self.state.active.any()) and max_steps:
            self.step()
            max_steps -= 1
        if self._queue or self.state.active.any():
            partial = {rid: list(req.out)
                       for rid, req in self.requests.items()}
            for req in self._queue:
                partial[req.rid] = list(req.out)
            if strict:
                raise IncompleteRunError(
                    queued=[r.rid for r in self._queue],
                    active=sorted(self.slot_of), partial=partial)
            return partial
        return {rid: req.out for rid, req in self.requests.items()}
