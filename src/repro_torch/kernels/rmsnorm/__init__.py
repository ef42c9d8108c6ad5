"""Fused RMSNorm (kernel row 4): the CUDA kernel ``csrc/rmsnorm.cu`` on
the card, its plain PyTorch version ``ref.py`` on the CPU, chosen by
``ops.py`` from the tensor's device."""
from .kernel import LAUNCHES, rmsnorm_cuda
from .ops import rmsnorm
from .ref import rmsnorm_ref

__all__ = ["LAUNCHES", "rmsnorm", "rmsnorm_cuda", "rmsnorm_ref"]
