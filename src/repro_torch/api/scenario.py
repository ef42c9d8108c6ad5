"""Declarative scenarios: one serializable config for the whole MCSA
pipeline (topology geometry + budgets, fleet, mobility, layer-profile
source, solver, admission, schedule).

The port of the JAX package's ``repro/api/scenario.py``.  A
:class:`Scenario` has the same fields, and ``to_dict`` gives the same
dict, so a scenario crosses between the two packages through
``to_dict`` / ``from_dict`` (see :mod:`repro_torch.interop`).

What the port's Session supports: chain-CNN models and transformer
archs (profiled at ``model_seq`` prefill tokens, one split point a
block), any candidate-set size K, per-server budgets (admission
control), fault injection (``faults``: a
:class:`~repro_torch.core.faults.FaultConfig`, built into a seeded
:class:`~repro_torch.core.faults.FaultModel` by
:meth:`Scenario.build_faults`) and the closed-loop serving data plane
(``serving``: a :class:`~repro_torch.serving.dataplane.ServeConfig`).
Every reference preset is registered here, field for field.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np

from repro_torch.configs import CNN_IDS, get_config
from repro_torch.core.costs import DeviceFleet, LayerProfile
from repro_torch.core.faults import FaultConfig, FaultModel
from repro_torch.core.ligd import LiGDConfig
from repro_torch.core.mobility import RandomWaypointMobility, StaticMobility
from repro_torch.core.network import Topology, build_topology
from repro_torch.core.profile import profile_of
from repro_torch.serving.dataplane import ServeConfig

#: mobility-model registry: name -> class with the
#: (topo, num_users, *, seed, speed_range-ignorable) constructor surface
MOBILITY_MODELS = {
    "random_waypoint": RandomWaypointMobility,
    "static": StaticMobility,
}


@dataclasses.dataclass(frozen=True)
class Scenario:
    """One named, serializable MCSA world (field groups as in the
    reference: topology, model, fleet, mobility, planner, faults,
    serving, schedule)."""
    name: str = "custom"
    # --- topology ---
    num_aps: int = 16
    num_servers: int = 4
    area: float = 2000.0
    topo_seed: int = 0
    heterogeneity: float = 0.5
    r_capacity: Optional[float] = None
    B_capacity: Optional[float] = None
    # --- model / layer profile source ---
    model: str = "vgg16"
    model_seq: int = 128
    # --- fleet ---
    num_users: int = 16
    c_dev_range: Tuple[float, float] = (3e9, 6e9)
    device_seed: int = 0
    # --- mobility ---
    mobility: str = "random_waypoint"
    speed_range: Tuple[float, float] = (1.0, 15.0)
    mobility_seed: int = 1
    # --- planner / policy defaults ---
    ligd: LiGDConfig = LiGDConfig()
    candidates_k: int = 1
    async_replanning: bool = False
    async_horizon: int = 1
    hysteresis: float = 0.0
    admission_aware_handoffs: Optional[bool] = None
    # --- fault injection (None = chaos off) ---
    faults: Optional[FaultConfig] = None
    # --- closed-loop serving (None = analytic only) ---
    serving: Optional[ServeConfig] = None
    # --- schedule ---
    steps: int = 30
    dt: float = 60.0

    # ------------------------------------------------------------------
    # serialization
    # ------------------------------------------------------------------
    def to_dict(self) -> dict:
        """Plain JSON-safe dict (tuples become lists; the nested
        LiGDConfig becomes its own dict) — the reference's layout."""
        d = dataclasses.asdict(self)
        for k, v in d.items():
            if isinstance(v, tuple):
                d[k] = list(v)
        d["ligd"] = {k: (list(v) if isinstance(v, tuple) else v)
                     for k, v in dataclasses.asdict(self.ligd).items()}
        d["faults"] = None if self.faults is None else self.faults.to_dict()
        d["serving"] = (None if self.serving is None
                        else self.serving.to_dict())
        return d

    @classmethod
    def from_dict(cls, d: dict) -> "Scenario":
        """Inverse of :meth:`to_dict` (also reads the reference's
        ``to_dict`` output).  Unknown keys are rejected loudly."""
        d = dict(d)
        unknown = set(d) - {f.name for f in dataclasses.fields(cls)}
        if unknown:
            raise TypeError(f"unknown Scenario fields: {sorted(unknown)}")
        ligd = d.get("ligd", LiGDConfig())
        if isinstance(ligd, dict):
            ligd = dict(ligd)
            if "init" in ligd:
                ligd["init"] = tuple(ligd["init"])
            ligd = LiGDConfig(**ligd)
        d["ligd"] = ligd
        faults = d.get("faults")
        if isinstance(faults, dict):
            d["faults"] = FaultConfig.from_dict(faults)
        serving = d.get("serving")
        if isinstance(serving, dict):
            d["serving"] = ServeConfig.from_dict(serving)
        for k in ("c_dev_range", "speed_range"):
            if k in d:
                d[k] = tuple(d[k])
        return cls(**d)

    def replace(self, **changes) -> "Scenario":
        """A modified copy (``dataclasses.replace`` as a method)."""
        return dataclasses.replace(self, **changes)

    # ------------------------------------------------------------------
    # component builders (Session calls these; scripts may too)
    # ------------------------------------------------------------------
    def build_topology(self) -> Topology:
        return build_topology(
            self.num_aps, self.num_servers, area=self.area,
            seed=self.topo_seed, heterogeneity=self.heterogeneity,
            r_capacity=self.r_capacity, B_capacity=self.B_capacity)

    def build_profile(self) -> LayerProfile:
        cfg = get_config(self.model)
        if self.model in CNN_IDS:
            return profile_of(cfg)
        return profile_of(cfg, seq=self.model_seq, mode="prefill")

    def build_devices(self) -> DeviceFleet:
        rng = np.random.default_rng(self.device_seed)
        return DeviceFleet(
            c_dev=rng.uniform(*self.c_dev_range, self.num_users))

    def build_mobility(self, topo: Topology):
        try:
            model = MOBILITY_MODELS[self.mobility]
        except KeyError:
            raise KeyError(
                f"unknown mobility model {self.mobility!r}; available: "
                f"{sorted(MOBILITY_MODELS)}") from None
        kw = {"seed": self.mobility_seed}
        if model is RandomWaypointMobility:
            kw["speed_range"] = self.speed_range
        return model(topo, self.num_users, **kw)

    def build_faults(self, topo: Topology) -> Optional[FaultModel]:
        """The scenario's seeded fault process over ``topo``'s servers
        and fiber links, or None when chaos is off."""
        if self.faults is None:
            return None
        return FaultModel(self.faults, topo.num_servers,
                          len(topo.links()))


# ---------------------------------------------------------------------------
# Preset registry: the reference's presets, field for field (the
# differential tests pin the to_dict round trip).
# ---------------------------------------------------------------------------
_SCENARIOS: Dict[str, Scenario] = {}


def register_scenario(scenario: Scenario) -> Scenario:
    """Register (or overwrite) a named preset; returns it unchanged."""
    _SCENARIOS[scenario.name] = scenario
    return scenario


def get_scenario(name: str) -> Scenario:
    try:
        return _SCENARIOS[name]
    except KeyError:
        raise KeyError(f"unknown scenario {name!r}; available: "
                       f"{sorted(_SCENARIOS)}") from None


def list_scenarios() -> Tuple[str, ...]:
    return tuple(sorted(_SCENARIOS))


# The paper's Fig. 1 system: 25 APs / 3 heterogeneous servers, YOLOv2
# stream, 10 vehicles at 8-25 m/s, one MLi-GD batch per simulated minute.
register_scenario(Scenario(
    name="paper_fig1", num_aps=25, num_servers=3, topo_seed=0,
    model="yolov2", num_users=10, device_seed=0,
    speed_range=(8.0, 25.0), mobility_seed=1,
    ligd=LiGDConfig(max_iters=250), steps=30, dt=60.0))

# Dense city core: many APs, short cells, pedestrian-to-scooter speeds.
register_scenario(Scenario(
    name="dense_urban", num_aps=64, num_servers=8, area=1600.0,
    topo_seed=2, model="vgg16", num_users=2000,
    speed_range=(1.0, 8.0), mobility_seed=3,
    ligd=LiGDConfig(max_iters=120), steps=20, dt=30.0))

# Sparse corridor: few APs over a long stretch, vehicular speeds.
register_scenario(Scenario(
    name="highway", num_aps=12, num_servers=3, area=6000.0,
    topo_seed=5, model="yolov2", num_users=200,
    speed_range=(25.0, 40.0), mobility_seed=7,
    ligd=LiGDConfig(max_iters=150), steps=40, dt=10.0))

# Admission-control showcase: K=3 candidate servers under a per-server
# compute budget tight enough to force spills, admission-aware handoff
# detection auto-on.
register_scenario(Scenario(
    name="capacitated_k3", num_aps=25, num_servers=4, topo_seed=0,
    model="nin", num_users=500, r_capacity=200.0, candidates_k=3,
    speed_range=(8.0, 25.0), mobility_seed=1,
    ligd=LiGDConfig(max_iters=100), steps=10, dt=30.0))

# The paper's static Figs. 3-8 setting: users never move.
register_scenario(Scenario(
    name="static_no_mobility", num_aps=16, num_servers=4, topo_seed=0,
    model="vgg16", num_users=64, mobility="static",
    ligd=LiGDConfig(max_iters=300), steps=5, dt=60.0))

# Production scale: 100k users on the NiN profile, async replanning
# hiding each step's MLi-GD solve behind the mobility numpy.
register_scenario(Scenario(
    name="megafleet_100k", num_aps=25, num_servers=4, topo_seed=0,
    model="nin", num_users=100_000, speed_range=(10.0, 30.0),
    mobility_seed=2, ligd=LiGDConfig(max_iters=60),
    async_replanning=True, steps=5, dt=30.0))

# Chaos: the capacitated_k3 world with a scripted single-server failure
# (server 2 dies at t=30 s, recovers at t=150 s): every user on the dead
# server is re-admitted under the survivors' residual budgets or degraded
# to device-only within one step, and the recovery hold keeps them off
# the recovered server for a while.
register_scenario(Scenario(
    name="chaos_singlefail_k3", num_aps=25, num_servers=4, topo_seed=0,
    model="nin", num_users=500, r_capacity=200.0, candidates_k=3,
    speed_range=(8.0, 25.0), mobility_seed=1,
    ligd=LiGDConfig(max_iters=100),
    faults=FaultConfig(schedule=(("server_down", 30.0, 2),
                                 ("server_up", 150.0, 2))),
    steps=8, dt=30.0))

# Closed-loop serving under chaos: the chaos_singlefail_k3 schedule with
# a live data plane.  Seeded Poisson arrivals feed per-server engine
# pools sized from the admission r-budgets; token_time_scale stretches
# streams across step boundaries so the kill at t=30 s lands mid-decode.
# Against chaos_singlefail_k3: slower devices (1-2 GHz) so edge wins and
# evacuation re-admits, looser budgets (2000) so the survivors hold
# residual capacity, and the kill takes server 0, the heaviest pool
# under this plan.  Mid-stream failovers, queue shedding on the hottest
# pool and the zero-lost audit after drain all fire.
register_scenario(Scenario(
    name="serve_chaos_k3", num_aps=25, num_servers=4, topo_seed=0,
    model="nin", num_users=500, r_capacity=2000.0, candidates_k=3,
    c_dev_range=(1e9, 2e9),
    speed_range=(8.0, 25.0), mobility_seed=1,
    ligd=LiGDConfig(max_iters=100),
    faults=FaultConfig(schedule=(("server_down", 30.0, 0),
                                 ("server_up", 150.0, 0))),
    serving=ServeConfig(arrival_rate=4.0, arrival_seed=11,
                        max_requests=800,
                        prompt_len=6, max_new=6, cache_len=64,
                        deadline_s=60.0, max_retries=2, backoff_s=5.0,
                        queue_limit=32, r_per_slot=8.0, min_slots=4,
                        max_slots=64, token_time_scale=10_000.0,
                        failover_mode="auto"),
    steps=8, dt=30.0))

# Hotspot: the telemetry feedback showcase.  Fault-free but overloaded:
# tiny decode pools (max_slots=8) under a sustained arrival stream make
# serving slots the binding resource, and the plan piles most users onto
# one hot server.  With feedback on (this preset) the dirty-set replans
# price against the observed queue delay and occupancy and spread load
# to the quiet pools; with ``feedback=False`` the hot server queues until
# deadlines blow.
register_scenario(Scenario(
    name="serve_hotspot_k3", num_aps=25, num_servers=4, topo_seed=0,
    model="nin", num_users=400, r_capacity=600.0, candidates_k=3,
    c_dev_range=(1e9, 2e9),
    speed_range=(8.0, 25.0), mobility_seed=1,
    ligd=LiGDConfig(max_iters=100),
    serving=ServeConfig(arrival_rate=3.0, arrival_seed=13,
                        max_requests=700,
                        prompt_len=6, max_new=6, cache_len=64,
                        deadline_s=60.0, max_retries=1, backoff_s=5.0,
                        queue_limit=24, r_per_slot=8.0, min_slots=2,
                        max_slots=8, token_time_scale=10_000.0,
                        failover_mode="auto", feedback=True,
                        feedback_alpha=0.35, feedback_interval=1),
    steps=10, dt=30.0))

# Chaos: sustained stochastic churn — servers crash and recover on an
# MTBF/MTTR clock, fiber links are cut and spliced, and the per-server
# budgets jitter every step.
register_scenario(Scenario(
    name="chaos_churn", num_aps=25, num_servers=4, topo_seed=0,
    model="nin", num_users=200, r_capacity=250.0, candidates_k=2,
    speed_range=(8.0, 25.0), mobility_seed=1,
    ligd=LiGDConfig(max_iters=80),
    faults=FaultConfig(server_mtbf=240.0, server_mttr=60.0,
                       link_mtbf=300.0, link_mttr=90.0,
                       capacity_jitter=0.15, seed=7),
    steps=12, dt=30.0))
