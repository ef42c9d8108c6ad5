"""Hand-written Hopper kernels of the port, each beside its plain PyTorch
version: the fused Li-GD/MLi-GD sweep and the single-split Li-GD steps,
RMSNorm, flash attention, the fused expert SwiGLU, the RG-LRU scan and
the WKV6 recurrence: one for every TPU kernel of the JAX package."""
from . import flash_attention, ligd_step, moe_gemm, rglru, rmsnorm, wkv6

__all__ = ["flash_attention", "ligd_step", "moe_gemm", "rglru", "rmsnorm",
           "wkv6"]
