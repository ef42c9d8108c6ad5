"""Fused RMSNorm (kernel row 4): the CUDA kernels ``csrc/rmsnorm.cu``
(forward) and ``csrc/rmsnorm_bwd.cu`` (backward) on the card, their plain
PyTorch versions ``ref.py`` on the CPU, chosen by ``ops.py`` from the
tensor's device."""
from .backward import rmsnorm_bwd_cuda
from .kernel import LAUNCHES, rmsnorm_cuda
from .ops import RMSNormFunction, rmsnorm
from .ref import rmsnorm_bwd_ref, rmsnorm_ref

__all__ = ["LAUNCHES", "RMSNormFunction", "rmsnorm", "rmsnorm_bwd_cuda",
           "rmsnorm_bwd_ref", "rmsnorm_cuda", "rmsnorm_ref"]
