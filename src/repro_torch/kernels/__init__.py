"""Hand-written Hopper kernels of the port, each beside its plain PyTorch
version: the fused Li-GD/MLi-GD sweep, RMSNorm and flash attention.  The
other TPU kernels of the JAX package are queued in ROADMAP.md."""
from . import flash_attention, ligd_step, rmsnorm

__all__ = ["flash_attention", "ligd_step", "rmsnorm"]
