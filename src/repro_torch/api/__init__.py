"""The port's front door: declarative :class:`Scenario`, the
:class:`Policy` protocol (the MCSA planner), and the stepped
:class:`Session` lifecycle.

    from repro_torch.api import Session, get_scenario
    metrics = Session(get_scenario("megafleet_100k")).run()   # on the card
    metrics = Session(get_scenario("paper_fig1"), device="cpu").run()
"""
from .policies import POLICIES, Policy, list_policies, make_policy
from .scenario import (MOBILITY_MODELS, Scenario, get_scenario,
                       list_scenarios, register_scenario)
from .session import Session, SessionMetrics, StepReport

__all__ = [
    "POLICIES", "Policy", "list_policies", "make_policy",
    "MOBILITY_MODELS", "Scenario", "get_scenario", "list_scenarios",
    "register_scenario", "Session", "SessionMetrics", "StepReport",
]
