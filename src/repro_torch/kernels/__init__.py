"""Hand-written Hopper kernels of the port, each beside its plain PyTorch
version.  Only the fused Li-GD/MLi-GD sweep is ported so far; the other
TPU kernels of the JAX package are queued in ROADMAP.md (queue 2)."""
from . import ligd_step

__all__ = ["ligd_step"]
