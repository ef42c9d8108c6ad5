"""Closed-loop serving data plane: one engine pool per edge server.

The port of the JAX package's ``repro/serving/dataplane.py``.  The host
logic is numpy and the same: the same RNG draws in the same order, the
same float operations, the same quirks (the ``edf`` key ``(deadline,
rid)``, migrants past ``queue_limit``, the ``lost`` audit in
:meth:`ServingDataPlane.drain`), so fed the same fleet tables and fault
batches the two planes take the same trajectory bit for bit.  The
engines are the port's :class:`~repro_torch.serving.engine.InferenceEngine`
on one device (the card unless the caller asks for the CPU).

The control plane (``MCSAPlanner`` behind ``repro_torch.api.Session``) decides
*where* each user's stream runs and how much compute it gets; this
module is the loop that actually serves the streams and feeds quality
signals back.  Per edge server z it keeps an :class:`EnginePool` — a
continuous-batching :class:`repro_torch.serving.engine.InferenceEngine` whose
slot count is derived from the admission r-budgets
(:func:`repro_torch.core.ledger.slots_from_usage`) — and drives it in
*virtual time*: each decode step advances the pool clock by the slowest
active stream's per-token delay, which comes from the planner's own
cost model (``FleetState.T``).  Virtual time makes the loop
deterministic and seed-reproducible (compute scales with tokens
emitted, not wall clock) while still letting thousands of real decode
streams run on one card.

Robustness semantics (the headline — see docs/ARCHITECTURE.md,
"Serving data plane"):

* **deadlines** — every request carries ``t_submit + deadline_s``; a
  stream that blows it is cancelled (tokens preserved) and retried with
  exponential backoff, at most ``max_retries`` times, then *degraded*
  to device-only.  Never silently dropped.
* **backpressure** — a pool whose queue is at ``queue_limit`` sheds the
  newcomer to device-only execution, deterministically.
* **mid-stream failover** — when a ``FaultBatch`` kills a server, every
  in-flight stream moves to the evacuation target the planner chose, by
  one of two mechanisms the plane prices against each other per stream
  (``ServeConfig.failover_mode``): **re-prefill** ships the raw token
  stream back (Eq. 41's activation-bits relay price) and recomputes the
  KV cache there (the context length at the planner's own per-token
  delay), while **migrate** ships the stream's actual KV-cache leaves
  (:meth:`repro_torch.serving.engine.InferenceEngine.export_cache` /
  ``import_cache``) at the same Eq. 41 bytes-over-backhaul price with
  zero recompute.  ``auto`` picks whichever is cheaper (ties go to
  re-prefill); each move is a
  :class:`repro_torch.serving.failover.FailoverEvent` carrying its mode,
  surfaced into ``SessionMetrics``.  Planned handoff continuations
  (:meth:`_reconcile`) price and choose the same way.

Requests arrive open-loop (seeded Poisson, a ``Scenario`` knob via
:class:`ServeConfig`) and end in exactly one of three terminal states:
``done`` (edge-completed), ``device`` (planner-chosen device-only), or
``degraded`` (forced fallback).  ``drain`` audits the invariant
``submitted == done + device + degraded`` and raises if any request was
lost.

Top-level imports here are light (numpy only) so scenario code can
import :class:`ServeConfig`; the model and engine imports happen inside
the default engine factory.
"""
from __future__ import annotations

import dataclasses
from collections import deque
from typing import Any, Callable, Dict, List, Optional

import numpy as np

from repro_torch.core.faults import HOP_UNREACHABLE, clamp_hops
from repro_torch.core.ledger import slots_from_usage  # noqa: F401  (re-export)
from repro_torch.telemetry.collector import TelemetryCollector

from .failover import (FAILOVER_MODES, MIGRATE, REPREFILL, FailoverEvent,
                       FailoverReport, leaf_bits, migration_price,
                       reprefill_price)

# Terminal request statuses.  DEVICE is the *planner's* choice (split ==
# M at submission / replan); DEGRADED is the data plane forcing a device
# fallback (shed, timeout budget exhausted, or no live server to run on).
DONE = "done"
DEVICE = "device"
DEGRADED = "degraded"
TERMINAL = (DONE, DEVICE, DEGRADED)


@dataclasses.dataclass(frozen=True)
class ServeConfig:
    """Declarative serving workload for one scenario (JSON-safe).

    Arrivals (open-loop Poisson, seeded — the whole request trajectory
    is a pure function of the config):

    arrival_rate : fleet-wide request arrival rate (req/s)
    arrival_seed : rng seed for counts, times, users, and prompts
    max_requests : hard cap on total submissions (None = unbounded)
    prompt_len   : prompt tokens per request
    max_new      : tokens generated per request

    Robustness:

    deadline_s   : per-attempt completion deadline (s, virtual time)
    max_retries  : timeout retries before degrading to device-only
    backoff_s    : retry backoff base; doubles per attempt
    queue_limit  : per-pool queue bound — arrivals beyond it are shed
                   (degraded to device-only, deterministically)

    Pool sizing (see :func:`repro_torch.core.ledger.slots_from_usage`):

    r_per_slot   : admitted compute units per decode slot
    min_slots    : floor so empty servers can still take traffic
    max_slots    : per-server slot cap (pow2-rounded in between)

    Engine & pricing:

    token_time_scale : multiplies the planner's per-user delay T into
                   the virtual per-token service time (T * scale /
                   max_new) — tune so streams span the step boundaries
                   you care about
    engine_arch  : model registry name for the real decode engine
    engine_layers : layer count passed to ``reduced`` (the default
                   factory's engine is the reduced, CPU-scale model)
    cache_len    : engine KV cache length (>= prompt_len + max_new)
    relay_bits_per_token : failover relay payload per token; None
                   derives d_model * 16 from the engine config

    Failover mechanism (docs/ARCHITECTURE.md, "Serving data plane"):

    failover_mode : how a live stream moves servers mid-decode —
                   ``"reprefill"`` (relay the tokens, recompute the
                   KV cache on the target),
                   ``"migrate"`` (ship the actual KV-cache leaves, no
                   recompute), or ``"auto"`` (price both per stream via
                   :func:`repro_torch.serving.failover.migration_price` /
                   ``reprefill_price`` and take the cheaper; ties go to
                   re-prefill).  Streams without an exportable cache
                   (still queued, or an engine lacking ``export_cache``)
                   always re-prefill, whatever the mode says.

    Admission order & feedback (docs/ARCHITECTURE.md, "Telemetry &
    feedback"):

    admission_order : ``"edf"`` admits ready queued requests earliest-
                   deadline-first (rid breaks ties, so workloads whose
                   deadlines are uniform or arrival-ordered admit
                   exactly like FIFO — the regression pin); ``"fifo"``
                   keeps strict arrival order.  Either way migrants
                   still bypass the queue_limit.
    feedback     : close the loop — ``Session.step`` harvests the data
                   plane's :class:`repro_torch.telemetry.TelemetryCollector`
                   through a :class:`repro_torch.telemetry.LoadEstimator` and
                   hands the ``LoadSnapshot`` to
                   ``MCSAPlanner.update_load``, so dirty-set replans
                   and admission price against *observed* load.  Off
                   (the default) never calls ``update_load``: the
                   planner prices against the static edge table,
                   bit-for-bit as before (collection itself is
                   side-effect-free).
    feedback_alpha : estimator EWMA smoothing factor, in (0, 1]
    feedback_interval : control steps between estimator updates
    feedback_window : ring-buffer capacity per (server, signal)
    feedback_max_mult : congestion-multiplier cap (>= 1)
    """
    arrival_rate: float = 2.0
    arrival_seed: int = 0
    max_requests: Optional[int] = None
    prompt_len: int = 8
    max_new: int = 8
    deadline_s: float = 60.0
    max_retries: int = 2
    backoff_s: float = 1.0
    queue_limit: int = 64
    r_per_slot: float = 4.0
    min_slots: int = 2
    max_slots: int = 512
    token_time_scale: float = 1.0
    engine_arch: str = "starcoder2-3b"
    engine_layers: int = 2
    cache_len: int = 64
    relay_bits_per_token: Optional[float] = None
    failover_mode: str = "auto"
    admission_order: str = "edf"
    feedback: bool = False
    feedback_alpha: float = 0.25
    feedback_interval: int = 1
    feedback_window: int = 64
    feedback_max_mult: float = 8.0

    def __post_init__(self):
        if self.max_new < 1:
            raise ValueError("max_new must be >= 1")
        if self.cache_len < self.prompt_len + self.max_new:
            raise ValueError("cache_len must cover prompt_len + max_new")
        if self.failover_mode not in ("auto",) + FAILOVER_MODES:
            raise ValueError(
                f"failover_mode must be one of "
                f"{('auto',) + FAILOVER_MODES}, got "
                f"{self.failover_mode!r}")
        if self.admission_order not in ("edf", "fifo"):
            raise ValueError(f"admission_order must be 'edf' or 'fifo', "
                             f"got {self.admission_order!r}")
        if not (0.0 < self.feedback_alpha <= 1.0):
            raise ValueError("feedback_alpha must be in (0, 1]")
        if self.feedback_interval < 1:
            raise ValueError("feedback_interval must be >= 1")
        if self.feedback_window < 1:
            raise ValueError("feedback_window must be >= 1")
        if self.feedback_max_mult < 1.0:
            raise ValueError("feedback_max_mult must be >= 1")

    # -- serialization (mirrors FaultConfig.to_dict/from_dict) ---------
    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: dict) -> "ServeConfig":
        d = dict(d)
        unknown = set(d) - {f.name for f in dataclasses.fields(cls)}
        if unknown:
            raise TypeError(f"unknown ServeConfig fields: {sorted(unknown)}")
        return cls(**d)


@dataclasses.dataclass
class ServeRequest:
    """One request's lifecycle through the data plane."""
    rid: int
    user: int
    prompt: np.ndarray            # (prompt_len,) int32
    max_new: int
    t_submit: float
    deadline: float
    token_s: float                # virtual per-token service time
    t_ready: float                # earliest admissible time (backoff/relay)
    t_last: float                 # last token emission time
    status: str = "queued"
    attempts: int = 1
    tokens: List[int] = dataclasses.field(default_factory=list)
    server: int = -1
    engine_rid: Optional[int] = None
    t_first: Optional[float] = None
    t_done: Optional[float] = None
    relay_s: float = 0.0
    failovers: int = 0
    cache: Optional[tuple] = None   # (leaves, pos) awaiting import —
    #   set when a relay chose MIGRATE; survives queued moves/retries
    #   (content is a pure function of prompt + tokens, so it stays
    #   valid until imported) and is cleared on import or re-prefill

    @property
    def remaining(self) -> int:
        return self.max_new - len(self.tokens)


class _DefaultEngineFactory:
    """Builds the port's ``InferenceEngine``s lazily on ``device`` (None
    means the card, and raises without one): ``reduced(get_config(
    engine_arch), layers=engine_layers)``, one parameter set from
    ``init_lm`` with ``torch.Generator().manual_seed(0)`` shared by every
    engine, a fresh engine per pool and slot count (a revived pool's
    rebuild reuses the parameters).  The torch and model imports live
    here, so importing this module — or configuring a Scenario — stays
    light."""

    def __init__(self, cfg: ServeConfig, device=None):
        from repro_torch._device import resolve_device
        self._scfg = cfg
        self.device = resolve_device(device)
        self._mcfg = None
        self._params = None

    def model_cfg(self):
        if self._mcfg is None:
            from repro_torch.configs import get_config, reduced
            self._mcfg = reduced(get_config(self._scfg.engine_arch),
                                 layers=self._scfg.engine_layers)
        return self._mcfg

    @property
    def d_model(self) -> int:
        return int(self.model_cfg().d_model)

    def __call__(self, slots: int):
        import torch

        from repro_torch.models import transformer as tfm
        from repro_torch.serving.engine import InferenceEngine
        if self._params is None:
            self._params = tfm.init_lm(self.model_cfg(),
                                       torch.Generator().manual_seed(0),
                                       self.device)
        return InferenceEngine(self.model_cfg(), self._params,
                               device=self.device, slots=int(slots),
                               cache_len=self._scfg.cache_len)


def default_engine_factory(cfg: ServeConfig,
                           device=None) -> Callable[[int], Any]:
    """The engine factory a plane builds when given none: the reduced
    ``cfg.engine_arch`` on ``device`` (None means the card)."""
    return _DefaultEngineFactory(cfg, device)


class EnginePool:
    """One edge server's serving state: a (lazily built) engine, a FIFO
    admission queue, a virtual clock, and liveness."""

    def __init__(self, z: int, slots: int, make_engine: Callable[[int], Any]):
        self.z = z
        self.slots = int(slots)
        self._make = make_engine
        self.engine: Any = None
        self.queue: deque = deque()
        self.active: Dict[int, ServeRequest] = {}   # engine rid -> request
        self.clock = 0.0
        self.up = True
        self.peak = 0           # max concurrent streams this step window
        self.queue_peak = 0     # max queue depth this step window

    def get_engine(self):
        if self.engine is None:
            self.engine = self._make(self.slots)
        return self.engine

    def note_depth(self):
        self.queue_peak = max(self.queue_peak, len(self.queue))

    def fail(self) -> List:
        """Server died: drop the engine, return every in-flight request
        as (request, was_running) for migration.  Running streams keep
        their produced tokens (mirrored at emission time)."""
        out = []
        for req in self.active.values():
            req.engine_rid = None
            out.append((req, True))
        self.active.clear()
        out.extend((req, False) for req in self.queue)
        self.queue.clear()
        self.engine = None
        self.up = False
        return out

    def revive(self, slots: int) -> None:
        """Server recovered: mark live with a fresh slot budget; the
        engine itself is rebuilt lazily on first admission."""
        self.slots = int(slots)
        self.engine = None
        self.up = True


class ServingDataPlane:
    """The closed loop: Poisson arrivals -> pool queues -> real decode
    under deadlines/backpressure/failover, in virtual time.

    Driven by ``repro_torch.api.Session`` once per control step, *after*
    fault evacuation and replanning — so ``fleet.server`` already names
    the evacuation targets when a ``FaultBatch`` arrives here.
    ``engine_factory`` (slots -> engine) overrides the default factory,
    which builds the reduced ``cfg.engine_arch`` on the card; a caller
    that wants another device passes ``default_engine_factory(cfg,
    device)``.
    """

    def __init__(self, cfg: ServeConfig, topo, *, num_layers: int,
                 slots: np.ndarray,
                 slots_fn: Optional[Callable[[], np.ndarray]] = None,
                 engine_factory: Optional[Callable[[int], Any]] = None):
        self.cfg = cfg
        self.topo = topo
        self.num_layers = int(num_layers)
        if engine_factory is None:
            engine_factory = default_engine_factory(cfg)
        self._factory = engine_factory
        self._slots_fn = slots_fn
        slots = np.asarray(slots, np.int64)
        self.pools = [EnginePool(z, int(slots[z]), engine_factory)
                      for z in range(topo.num_servers)]
        self._B_backhaul = np.asarray(
            [e.B_backhaul for e in topo.edges], np.float64)
        bits = cfg.relay_bits_per_token
        if bits is None:
            bits = 16.0 * float(getattr(engine_factory, "d_model", 64))
        self._bits_per_token = float(bits)

        # Always-on observability (repro_torch.telemetry): recording is
        # pure — it never influences admission, clocks, or routing, so the
        # collector may run even when cfg.feedback is off.  Tests strip
        # it (collector = None) to prove that differentially.
        self.collector: Optional[TelemetryCollector] = TelemetryCollector(
            topo.num_servers, window=cfg.feedback_window)

        self._rng = np.random.default_rng(cfg.arrival_seed)
        self._next_rid = 0
        self.requests: Dict[int, ServeRequest] = {}
        self.events: List[FailoverEvent] = []
        self.counters = dict(submitted=0, completed=0, device=0,
                             degraded=0, shed=0, timeouts=0, retries=0,
                             relays=0, relay_s_total=0.0,
                             relays_migrate=0, relays_reprefill=0,
                             relay_s_migrate=0.0, relay_s_reprefill=0.0,
                             recompute_s_total=0.0)
        self._tok_lat: List[float] = []
        self._ttft: List[float] = []
        self.tracks: List[dict] = []
        self.peak_concurrent = 0
        self._queue_depth_peak = 0
        self._t0: Optional[float] = None

    # -- one control step ----------------------------------------------
    def step(self, dt: float, t: float, *, fleet,
             faults=None) -> dict:
        """Advance the data plane over [t, t+dt): fold fault transitions,
        reconcile in-flight streams against the (re)planned fleet table,
        draw arrivals, and run every pool to the step boundary.  Returns
        this step's track sample."""
        if self._t0 is None:
            self._t0 = float(t)
        t_end = t + dt
        for pool in self.pools:
            pool.peak = len(pool.active)
            pool.queue_peak = len(pool.queue)
        if faults is not None:
            self._apply_faults(faults, t, fleet)
        self._reconcile(t, fleet)
        self._arrivals(dt, t, fleet)
        for pool in self.pools:
            self._run_pool(pool, t, t_end, hard=False)
        return self._record_track(t_end)

    def drain(self) -> None:
        """Run every pool until empty (deadlines still apply, so this
        terminates: each request ends within ``max_retries`` attempts).
        Raises if any request failed to reach a terminal state — the
        zero-lost invariant is enforced loudly, not assumed."""
        for pool in self.pools:
            if pool.up:
                self._run_pool(pool, pool.clock, float("inf"), hard=True)
        lost = [r.rid for r in self.requests.values()
                if r.status not in TERMINAL]
        if lost:
            raise RuntimeError(
                f"data plane lost {len(lost)} request(s): {lost[:8]}...")

    # -- fault transitions ----------------------------------------------
    def _apply_faults(self, batch, t: float, fleet) -> None:
        server = np.asarray(fleet.server)
        split = np.asarray(fleet.split)
        for z in np.asarray(batch.server_up, np.int64):
            pool = self.pools[int(z)]
            if not pool.up:
                pool.revive(self._slots_for(int(z)))
        for z in np.asarray(batch.server_down, np.int64):
            pool = self.pools[int(z)]
            if not pool.up:
                continue
            now = max(pool.clock, t)
            # snapshot live streams' KV caches BEFORE fail() drops the
            # engine — the evacuation ships them iff migration wins the
            # price comparison in _route (or is forced)
            exported = {req.rid: self._export(pool, erid)
                        for erid, req in pool.active.items()
                        if int(split[req.user]) < self.num_layers}
            for req, was_running in pool.fail():
                if int(split[req.user]) >= self.num_layers:
                    self._finish_device(req, now, DEVICE)
                    continue
                self._route(req, int(server[req.user]), now=now,
                            relay=was_running,
                            lost=int(z) if was_running else None,
                            cache=exported.get(req.rid))

    # -- handoff continuation -------------------------------------------
    def _reconcile(self, t: float, fleet) -> None:
        """Move in-flight streams whose user the planner re-routed:
        queued requests move free; running streams pay the relay-back
        price and re-prefill on the new server (decode continues across
        the handoff — same greedy stream, new KV cache)."""
        server = np.asarray(fleet.server)
        split = np.asarray(fleet.split)
        for pool in self.pools:
            if not pool.up:
                continue
            for _ in range(len(pool.queue)):
                req = pool.queue.popleft()
                z_new = int(server[req.user])
                if int(split[req.user]) >= self.num_layers:
                    self._finish_device(req, max(t, req.t_ready), DEVICE)
                elif z_new != pool.z:
                    self._route(req, z_new, now=max(t, req.t_ready),
                                relay=False, lost=None)
                else:
                    pool.queue.append(req)
            for erid, req in list(pool.active.items()):
                z_new = int(server[req.user])
                dev = int(split[req.user]) >= self.num_layers
                if not dev and z_new == pool.z:
                    continue
                cache = None if dev else self._export(pool, erid)
                pool.get_engine().cancel(erid)
                del pool.active[erid]
                req.engine_rid = None
                now = max(pool.clock, t)
                if dev:
                    self._finish_device(req, now, DEVICE)
                else:
                    self._route(req, z_new, now=now, relay=True,
                                lost=None, cache=cache)

    # -- arrivals --------------------------------------------------------
    def _arrivals(self, dt: float, t: float, fleet) -> None:
        cfg = self.cfg
        n = int(self._rng.poisson(cfg.arrival_rate * dt))
        if cfg.max_requests is not None:
            n = min(n, cfg.max_requests - self.counters["submitted"])
        if n <= 0:
            return
        server = np.asarray(fleet.server)
        split = np.asarray(fleet.split)
        T = np.asarray(fleet.T, np.float64)
        X = len(server)
        times = t + np.sort(self._rng.uniform(0.0, dt, n))
        users = self._rng.integers(0, X, n)
        prompts = self._rng.integers(1, 200, (n, cfg.prompt_len),
                                     dtype=np.int32)
        for i in range(n):
            u = int(users[i])
            t_arr = float(times[i])
            token_s = (max(float(T[u]), 1e-9) * cfg.token_time_scale
                       / cfg.max_new)
            req = ServeRequest(
                rid=self._next_rid, user=u, prompt=prompts[i],
                max_new=cfg.max_new, t_submit=t_arr,
                deadline=t_arr + cfg.deadline_s, token_s=token_s,
                t_ready=t_arr, t_last=t_arr)
            self._next_rid += 1
            self.requests[req.rid] = req
            self.counters["submitted"] += 1
            if int(split[u]) >= self.num_layers:
                self._finish_device(req, t_arr, DEVICE)
                continue
            pool = self.pools[int(server[u])]
            if not pool.up:
                self._finish_device(req, t_arr, DEGRADED)
                continue
            if len(pool.queue) >= cfg.queue_limit:
                self.counters["shed"] += 1
                if self.collector is not None:
                    self.collector.on_shed(pool.z)
                self._finish_device(req, t_arr, DEGRADED)
                continue
            req.server = pool.z
            pool.queue.append(req)
            pool.note_depth()

    # -- routing / terminal helpers -------------------------------------
    def _export(self, pool: EnginePool, erid: int):
        """Snapshot one running stream's cache leaves for a possible
        migration, or None when the mode forbids it / the engine can't
        (``reprefill`` mode skips the export entirely — forcing
        re-prefill also skips its cost)."""
        if self.cfg.failover_mode == REPREFILL:
            return None
        eng = pool.engine
        if eng is None or getattr(eng, "export_cache", None) is None:
            return None
        return eng.export_cache(erid)

    def _finish_device(self, req: ServeRequest, now: float,
                       status: str) -> None:
        """Complete a request on the user's own device in virtual time.
        Tokens are not materialized (the device runs the full model; the
        stream identity question only exists for edge engines)."""
        if (status == DEGRADED and self.collector is not None
                and req.server >= 0):
            self.collector.on_degraded(req.server)
        req.status = status
        req.server = -1
        req.t_done = now + req.remaining * req.token_s
        self.counters[status] += 1

    def _route(self, req: ServeRequest, z_new: int, *, now: float,
               relay: bool, lost: Optional[int],
               cache: Optional[tuple] = None) -> None:
        """Re-queue a request on server ``z_new``.  ``relay=True`` prices
        the move and picks the mechanism: re-prefill (token relay-back +
        context recompute at the planner's per-token delay) vs KV-cache
        migration (the exported ``cache`` leaves' actual bits over the
        backhaul, no recompute) — forced by ``cfg.failover_mode``, or
        cheapest-wins under ``auto`` with ties to re-prefill.  ``lost``
        names a dead source server, making this a failover event rather
        than a planned handoff.  ``relay=False`` moves (still-queued
        requests) are free and keep any earlier migration stash — its
        content is server-independent."""
        pool = self.pools[z_new]
        if not pool.up:
            self._finish_device(req, now, DEGRADED)
            return
        delay = 0.0
        if relay:
            z_old = lost if lost is not None else req.server
            h = self._relay_hops(z_old, z_new)
            if h >= HOP_UNREACHABLE:
                self._finish_device(req, now, DEGRADED)
                return
            ctx = len(req.prompt) + len(req.tokens)
            bw = float(self._B_backhaul[z_new])
            re_price = reprefill_price(ctx, self._bits_per_token, h, bw,
                                       req.token_s)
            mode = REPREFILL
            if cache is not None:
                cache_b = leaf_bits(cache[0])
                mig_price = migration_price(cache_b, h, bw)
                if self.cfg.failover_mode == MIGRATE or (
                        self.cfg.failover_mode == "auto"
                        and mig_price < re_price):
                    mode = MIGRATE
            if mode == MIGRATE:
                bits = cache_b
                relay_s = delay = mig_price
                req.cache = cache
            else:
                bits = self._bits_per_token * ctx
                relay_s = float(bits * h / bw)
                recompute_s = ctx * req.token_s
                delay = relay_s + recompute_s
                self.counters["recompute_s_total"] += recompute_s
                req.cache = None
            req.relay_s += relay_s
            self.counters["relays"] += 1
            self.counters[f"relays_{mode}"] += 1
            self.counters["relay_s_total"] += relay_s
            self.counters[f"relay_s_{mode}"] += relay_s
            if lost is not None:
                req.failovers += 1
                self.events.append(FailoverEvent(
                    lost=f"server{z_old}", tokens_done=len(req.tokens),
                    relay_s=relay_s, relay_bits=bits, mode=mode))
        req.server = z_new
        req.t_ready = now + delay
        req.t_last = max(req.t_last, req.t_ready)
        # Migrants bypass the queue_limit: they are already-admitted work
        # being preserved, not new load — shedding them would drop them.
        pool.queue.append(req)
        pool.note_depth()

    def _relay_hops(self, z_old: int, z_new: int) -> float:
        ap = int(self.topo.server_aps[z_old])
        h = float(clamp_hops(self.topo.hops[ap, z_new]))
        return h if h >= HOP_UNREACHABLE else max(h, 1.0)

    def _slots_for(self, z: int) -> int:
        if self._slots_fn is not None:
            return int(np.asarray(self._slots_fn())[z])
        return self.pools[z].slots

    # -- the pool run loop ----------------------------------------------
    def _run_pool(self, pool: EnginePool, t_start: float, t_end: float,
                  hard: bool) -> None:
        """Advance one pool's virtual clock to ``t_end`` (or to empty,
        when ``hard``): admit ready requests FIFO, one fused decode per
        iteration, deadline checks between decodes."""
        if not pool.up:
            return
        pool.clock = max(pool.clock, t_start)
        while True:
            self._timeouts(pool)
            self._admit_pool(pool)
            if not pool.active:
                if not pool.queue:
                    return
                nxt = min(r.t_ready for r in pool.queue)
                if not hard and nxt > t_end:
                    return
                pool.clock = max(pool.clock, nxt)
                continue
            if not hard and pool.clock >= t_end:
                return
            if self.collector is not None:
                self.collector.on_occupancy(
                    pool.z, len(pool.active) / max(pool.slots, 1))
            emitted = pool.get_engine().step()
            pool.clock += max(r.token_s for r in pool.active.values())
            for erid, tok in emitted:
                req = pool.active.get(erid)
                if req is None:
                    continue
                self._stamp(req, tok, pool.clock, pool.z)
                if req.remaining <= 0:
                    pool.get_engine().pop_result(erid)
                    del pool.active[erid]
                    req.engine_rid = None
                    req.status = DONE
                    req.t_done = req.t_last
                    self.counters["completed"] += 1

    def _admit_pool(self, pool: EnginePool) -> None:
        if not pool.queue:
            return
        eng = pool.get_engine()
        free = eng.free_slots
        pool.note_depth()
        # Ready = admissible now.  "edf" admits them earliest-deadline-
        # first (a timed-out retry or a migrated stream, whose deadline
        # predates the fresh arrivals queued ahead of it, jumps the
        # line); rid ties restore arrival order, so a workload whose
        # deadlines are uniform or arrival-ordered admits exactly like
        # "fifo".  The skipped remainder keeps its arrival order.
        ready = [r for r in pool.queue
                 if r.t_ready <= pool.clock] if free > 0 else []
        if self.cfg.admission_order == "edf":
            ready.sort(key=lambda r: (r.deadline, r.rid))
        take = ready[:free]
        if take:
            chosen = {r.rid for r in take}
            keep = [r for r in pool.queue if r.rid not in chosen]
            pool.queue.clear()
            pool.queue.extend(keep)
        for req in take:
            if self.collector is not None:
                self.collector.on_queue_delay(
                    pool.z, pool.clock - req.t_ready)
            tokens = np.concatenate(
                [np.asarray(req.prompt, np.int32),
                 np.asarray(req.tokens, np.int32)])
            if req.cache is not None:
                # migrated stream: insert the shipped KV prefix and
                # resume decode — no prefill, no token at admission
                # (the next token comes from the next decode step,
                # exactly as on the source engine)
                leaves, pos = req.cache
                erid = eng.import_cache(tokens, req.remaining, leaves,
                                        pos)
                req.cache = None
                req.engine_rid = erid
                req.status = "running"
                pool.active[erid] = req
                continue
            erid = eng.submit(tokens, req.remaining)
            eng.admit()
            # prefill emits the first token synchronously at admission
            tok = eng.requests[erid].out[-1]
            self._stamp(req, tok, pool.clock + req.token_s, pool.z)
            if req.remaining <= 0:
                eng.pop_result(erid)
                req.status = DONE
                req.t_done = req.t_last
                self.counters["completed"] += 1
            else:
                req.engine_rid = erid
                req.status = "running"
                pool.active[erid] = req
        pool.peak = max(pool.peak, len(pool.active))

    def _timeouts(self, pool: EnginePool) -> None:
        now = pool.clock
        for _ in range(len(pool.queue)):
            req = pool.queue.popleft()
            if now >= req.deadline:
                self._timeout(req, now)
            else:
                pool.queue.append(req)
        for erid, req in list(pool.active.items()):
            if now >= req.deadline:
                pool.get_engine().cancel(erid)
                del pool.active[erid]
                req.engine_rid = None
                self._timeout(req, now)

    def _timeout(self, req: ServeRequest, now: float) -> None:
        self.counters["timeouts"] += 1
        if req.attempts > self.cfg.max_retries:
            self._finish_device(req, now, DEGRADED)
            return
        delay = self.cfg.backoff_s * (2.0 ** (req.attempts - 1))
        req.attempts += 1
        self.counters["retries"] += 1
        req.t_ready = now + delay
        req.deadline = req.t_ready + self.cfg.deadline_s
        req.t_last = max(req.t_last, req.t_ready)
        req.status = "queued"
        pool = self.pools[req.server]
        pool.queue.append(req)     # same server: the planner still maps
        pool.note_depth()          # the user there; reconcile moves it

    def _stamp(self, req: ServeRequest, tok: int, t_tok: float,
               z: int = -1) -> None:
        req.tokens.append(int(tok))
        if req.t_first is None:
            req.t_first = t_tok
            ttft = t_tok - req.t_submit
            self._ttft.append(ttft)
            if self.collector is not None and z >= 0:
                self.collector.on_ttft(z, ttft)
        else:
            lat = max(t_tok - req.t_last, 0.0)
            self._tok_lat.append(lat)
            if self.collector is not None and z >= 0:
                self.collector.on_token(z, lat)
        req.t_last = t_tok

    # -- telemetry -------------------------------------------------------
    def _record_track(self, t_end: float) -> dict:
        peak = sum(p.peak for p in self.pools)
        depth = max((p.queue_peak for p in self.pools), default=0)
        self.peak_concurrent = max(self.peak_concurrent, peak)
        self._queue_depth_peak = max(self._queue_depth_peak, depth)
        queued_ps = [len(p.queue) for p in self.pools]
        active_ps = [len(p.active) for p in self.pools]
        occ_ps = [len(p.active) / max(p.slots, 1) for p in self.pools]
        if self.collector is not None:
            # end-of-step occupancy sample for every pool — idle pools
            # emit the explicit zeros the estimator's decay feeds on
            for z, occ in enumerate(occ_ps):
                self.collector.on_occupancy(z, occ)
        sample = dict(
            t=float(t_end),
            active=sum(active_ps),
            queued=sum(queued_ps),
            peak_active=int(peak),
            queue_depth_max=int(depth),
            submitted=int(self.counters["submitted"]),
            completed=int(self.counters["completed"]),
            queued_per_server=queued_ps,
            active_per_server=active_ps,
            queue_peak_per_server=[int(p.queue_peak)
                                   for p in self.pools],
            occupancy_per_server=[round(o, 6) for o in occ_ps])
        self.tracks.append(sample)
        return sample

    def in_flight(self) -> int:
        return sum(1 for r in self.requests.values()
                   if r.status not in TERMINAL)

    def failover_report(self) -> FailoverReport:
        return FailoverReport(events=list(self.events))

    def summary(self) -> dict:
        c = self.counters
        tl = np.asarray(self._tok_lat, np.float64)
        tf = np.asarray(self._ttft, np.float64)

        def pct(a, q):
            return float(np.percentile(a, q)) if a.size else None

        tokens = int(tl.size + tf.size)
        clocks = [p.clock for p in self.pools]
        span = (max(clocks) - self._t0) if (clocks and
                                            self._t0 is not None) else 0.0
        qmeans = [s["queued"] for s in self.tracks]
        return {
            "submitted": int(c["submitted"]),
            "completed": int(c["completed"]),
            "device": int(c["device"]),
            "degraded": int(c["degraded"]),
            "lost": int(c["submitted"] - c["completed"] - c["device"]
                        - c["degraded"]),
            "shed": int(c["shed"]),
            "timeouts": int(c["timeouts"]),
            "retries": int(c["retries"]),
            "relays": int(c["relays"]),
            "relay_s_total": float(c["relay_s_total"]),
            "relays_migrate": int(c["relays_migrate"]),
            "relays_reprefill": int(c["relays_reprefill"]),
            "relay_s_migrate": float(c["relay_s_migrate"]),
            "relay_s_reprefill": float(c["relay_s_reprefill"]),
            "recompute_s_total": float(c["recompute_s_total"]),
            "failover_events": len(self.events),
            "failovers_migrate": sum(
                1 for e in self.events if e.mode == MIGRATE),
            "failovers_reprefill": sum(
                1 for e in self.events if e.mode == REPREFILL),
            "tokens_emitted": tokens,
            "peak_concurrent_streams": int(self.peak_concurrent),
            "queue_depth_peak": int(self._queue_depth_peak),
            "queue_depth_mean": (float(np.mean(qmeans)) if qmeans
                                 else 0.0),
            "token_latency_p50_s": pct(tl, 50),
            "token_latency_p99_s": pct(tl, 99),
            "ttft_p50_s": pct(tf, 50),
            "ttft_p99_s": pct(tf, 99),
            "virtual_time_s": float(span),
            "virtual_tok_per_s": (float(tokens / span) if span > 0
                                  else None),
            "slots": [int(p.slots) for p in self.pools],
            "servers_up": int(sum(p.up for p in self.pools)),
            "per_server": self._per_server_summary(),
        }

    def _per_server_summary(self) -> dict:
        """Per-server queue-depth / occupancy tracks (one entry per
        control step, Z-wide rows) plus the collector's per-server
        counters and windowed latency stats — the disaggregation the
        telemetry loop consumes and ``SessionMetrics.serving``
        surfaces."""
        Z = len(self.pools)
        q_rows = [s["queue_peak_per_server"] for s in self.tracks
                  if "queue_peak_per_server" in s]
        o_rows = [s["occupancy_per_server"] for s in self.tracks
                  if "occupancy_per_server" in s]
        out = {
            "slots": [int(p.slots) for p in self.pools],
            "up": [bool(p.up) for p in self.pools],
            "queue_depth_track": q_rows,
            "occupancy_track": o_rows,
            "queue_depth_peak": [
                max((row[z] for row in q_rows), default=0)
                for z in range(Z)],
            "occupancy_mean": [
                float(np.mean([row[z] for row in o_rows])) if o_rows
                else 0.0 for z in range(Z)],
        }
        c = self.collector
        if c is not None:
            for name in ("admitted", "tokens", "shed", "degraded"):
                out[name] = [int(v) for v in c.totals(name)]
            q50 = c.window_quantile("queue_delay_s", 0.5)
            t50 = c.window_quantile("token_latency_s", 0.5)
            out["queue_delay_p50_s"] = [
                None if np.isnan(v) else float(v) for v in q50]
            out["token_latency_p50_s"] = [
                None if np.isnan(v) else float(v) for v in t50]
        return out
