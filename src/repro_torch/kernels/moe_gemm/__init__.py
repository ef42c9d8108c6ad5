"""Fused expert SwiGLU (kernel row 5): the CUDA kernel
``csrc/moe_swiglu.cu`` on the card, its plain PyTorch version ``ref.py``
on the CPU, chosen by ``ops.py`` from the tensor's device."""
from .kernel import LAUNCHES, moe_swiglu_cuda
from .ops import moe_swiglu
from .ref import moe_swiglu_ref

__all__ = ["LAUNCHES", "moe_swiglu", "moe_swiglu_cuda", "moe_swiglu_ref"]
