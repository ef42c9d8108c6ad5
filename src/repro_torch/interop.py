"""Carrying planner state across from the JAX package.

The planner has no weights: its state is the scenario, the layer profile
and the plan table.  These functions take them as plain numpy arrays and
dicts — what the reference's ``Scenario.to_dict()``, ``LayerProfile``
fields and ``FleetState`` columns hold — so nothing here imports the
reference.  A differential test seeds the port's planner with the
reference's plan table through :func:`fleet_from_columns`, and both
packages then compute the same ``on_events`` step.
"""
from __future__ import annotations

import numpy as np

from repro_torch.api.scenario import Scenario
from repro_torch.core.costs import LayerProfile
from repro_torch.core.planner import PLAN_FIELDS, FleetState

_INT_COLUMNS = ("server", "split", "R")


def scenario_from_dict(d: dict) -> Scenario:
    """A port Scenario from the reference's ``Scenario.to_dict()``."""
    return Scenario.from_dict(d)


def profile_from_arrays(name: str, flops, out_bits, in_bits: float,
                        result_bits: float) -> LayerProfile:
    """A LayerProfile whose ``fingerprint`` equals the reference's for
    the same name and arrays."""
    return LayerProfile(name=name,
                        flops=np.asarray(flops, np.float64),
                        out_bits=np.asarray(out_bits, np.float64),
                        in_bits=float(in_bits),
                        result_bits=float(result_bits))


def fleet_from_columns(cols: dict) -> FleetState:
    """A FleetState from a dict of the reference FleetState's columns
    (copied, so the port never writes into the caller's arrays)."""
    missing = set(PLAN_FIELDS) - set(cols)
    if missing:
        raise KeyError(f"missing FleetState columns: {sorted(missing)}")
    return FleetState(**{
        k: np.array(cols[k], np.int64 if k in _INT_COLUMNS else np.float64)
        for k in PLAN_FIELDS})
