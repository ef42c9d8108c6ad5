"""The MCSA control plane on PyTorch: cost model, Li-GD/MLi-GD solvers,
network/mobility/event/ledger/fault host logic, admission control, the
§6 baselines, and the planner.  See
``repro_torch.api`` for the front door."""
from .admission import AdmissionReport, admit_waterfill
from .baselines import BASELINES, BaselineResult, run_baseline_batch
from .costs import (DeviceFleet, DeviceParams, EdgeParams, LayerProfile,
                    dev_dict, edge_dict, gather_devices, stack_devices,
                    stack_edges_np, utility)
from .events import (DRAIN, EVACUATE, HANDOFF, DirtyBatch, DirtySet,
                     EventOutcome, StepEvents)
from .faults import (HOP_UNREACHABLE, EvacuationReport, FaultBatch,
                     FaultConfig, FaultModel, clamp_hops)
from .ledger import BudgetLedger
from .ligd import LiGDConfig, LiGDResult, solve_ligd, solve_ligd_batch
from .mligd import (MLiGDResult, orig_strategy_dict, solve_mligd,
                    solve_mligd_batch)
from .mobility import (HandoffBatch, HandoffEvent, RandomWaypointMobility,
                       StaticMobility)
from .network import Topology, build_topology
from .planner import PLAN_FIELDS, FleetState, MCSAPlanner, UserPlan
from .profile import profile_chain_cnn, profile_of
