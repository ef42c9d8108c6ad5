"""Batched Li-GD / MLi-GD whole-sweep solver (the paper's hot spot,
Corollary 3): the CUDA kernel ``csrc/sweep.cu`` on the card, its plain
PyTorch version ``ref.py`` on the CPU, chosen by ``ops.py`` from the
tensor's device.  The JAX package's single-step kernel
(``ligd_steps_tpu``) is not ported yet (ROADMAP, queue 1, item 1)."""
from .kernel import LAUNCHES, sweep_cuda
from .ops import SweepResult, ligd_sweep, mligd_sweep
from .ref import (NF_SWEEP, NROWS_JOINT, NROWS_LIGD, SWEEP_FIELDS,
                  ligd_sweep_ref, mligd_sweep_ref, pack_sweep_features,
                  sweep_tables, table_tensor)

__all__ = [
    "LAUNCHES", "sweep_cuda", "SweepResult", "ligd_sweep", "mligd_sweep",
    "NF_SWEEP", "NROWS_JOINT", "NROWS_LIGD", "SWEEP_FIELDS",
    "ligd_sweep_ref", "mligd_sweep_ref",
    "pack_sweep_features", "sweep_tables", "table_tensor",
]
