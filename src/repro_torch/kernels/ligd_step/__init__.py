"""Batched Li-GD / MLi-GD solver kernels (the paper's hot spot,
Corollary 3): the whole-sweep CUDA kernel ``csrc/sweep.cu`` (kernel row
1) and the single-split steps ``csrc/steps.cu`` (row 2) on the card,
their plain PyTorch versions ``ref.py`` on the CPU, chosen by ``ops.py``
from the tensor's device."""
from .kernel import LAUNCHES, sqrt_bound, sweep_cuda
from .ops import (SweepResult, ligd_steps, ligd_steps_grouped, ligd_sweep,
                  mligd_sweep)
from .ref import (EDGE_KEYS, MAX_GROUPS, NF, NF_SWEEP, NROWS_JOINT,
                  NROWS_LIGD, SWEEP_FIELDS, edge_tuple_of,
                  fast_math_steps_twin, fast_math_sweep_twin,
                  interior_lanes, ligd_steps_grouped_ref, ligd_steps_ref,
                  ligd_sweep_ref, mligd_sweep_ref, pack_features,
                  pack_sweep_features, steps_interior_case, sweep_tables,
                  table_tensor)
from .steps import ligd_steps_cuda, ligd_steps_grouped_cuda

__all__ = [
    "LAUNCHES", "MAX_GROUPS", "sqrt_bound", "sweep_cuda", "SweepResult",
    "ligd_steps", "ligd_steps_grouped", "ligd_steps_grouped_cuda",
    "ligd_sweep", "mligd_sweep", "EDGE_KEYS", "NF", "NF_SWEEP",
    "NROWS_JOINT", "NROWS_LIGD", "SWEEP_FIELDS", "edge_tuple_of",
    "fast_math_steps_twin", "fast_math_sweep_twin", "interior_lanes",
    "ligd_steps_cuda", "ligd_steps_grouped_ref", "ligd_steps_ref",
    "ligd_sweep_ref", "mligd_sweep_ref", "pack_features",
    "pack_sweep_features", "steps_interior_case", "sweep_tables",
    "table_tensor",
]
