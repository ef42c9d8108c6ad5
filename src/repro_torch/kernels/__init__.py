"""Hand-written Hopper kernels of the port, each beside its plain PyTorch
version: the fused Li-GD/MLi-GD sweep, RMSNorm, flash attention, the
fused expert SwiGLU and the WKV6 recurrence.  The other TPU kernels of
the JAX package are queued in ROADMAP.md."""
from . import flash_attention, ligd_step, moe_gemm, rmsnorm, wkv6

__all__ = ["flash_attention", "ligd_step", "moe_gemm", "rmsnorm", "wkv6"]
