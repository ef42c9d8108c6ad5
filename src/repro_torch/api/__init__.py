"""The port's front door: declarative :class:`Scenario`, the
:class:`Policy` protocol (the MCSA planner and the §6 baselines), and
the stepped :class:`Session` lifecycle, fault injection, the
closed-loop serving data plane (:class:`ServeConfig`,
``serve_chaos_k3``) and the telemetry feedback loop
(``serve_hotspot_k3``) included.

    from repro_torch.api import Session, get_scenario
    metrics = Session(get_scenario("megafleet_100k")).run()   # on the card
    metrics = Session(get_scenario("paper_fig1"), device="cpu").run()
    metrics = Session(get_scenario("serve_chaos_k3")).run()   # serving
"""
from repro_torch.core.events import (DirtyBatch, DirtySet, EventOutcome,
                                     StepEvents)
from repro_torch.core.faults import (EvacuationReport, FaultBatch,
                                     FaultConfig, FaultModel)
from repro_torch.core.ledger import BudgetLedger
from repro_torch.serving.dataplane import ServeConfig, ServingDataPlane
from repro_torch.telemetry import (LoadEstimator, LoadSnapshot,
                                   TelemetryCollector)

from .policies import (POLICIES, BaselinePolicy, CloudPolicy,
                       DNNSurgeryPolicy, DeviceOnlyPolicy, EdgeOnlyPolicy,
                       GreedyNearestPolicy, MCSAPlanner, Policy,
                       list_policies, make_policy)
from .scenario import (MOBILITY_MODELS, Scenario, get_scenario,
                       list_scenarios, register_scenario)
from .session import Session, SessionMetrics, StepReport

__all__ = [
    "Scenario", "get_scenario", "list_scenarios", "register_scenario",
    "MOBILITY_MODELS",
    "Policy", "POLICIES", "list_policies", "make_policy", "MCSAPlanner",
    "BaselinePolicy", "DeviceOnlyPolicy", "EdgeOnlyPolicy", "CloudPolicy",
    "GreedyNearestPolicy", "DNNSurgeryPolicy",
    "Session", "SessionMetrics", "StepReport",
    "FaultConfig", "FaultModel", "FaultBatch", "EvacuationReport",
    "StepEvents", "EventOutcome", "DirtyBatch", "DirtySet",
    "BudgetLedger",
    "ServeConfig", "ServingDataPlane",
    "TelemetryCollector", "LoadEstimator", "LoadSnapshot",
]
