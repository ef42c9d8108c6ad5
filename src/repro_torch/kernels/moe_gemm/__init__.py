"""Fused expert SwiGLU (kernel row 5): the CUDA kernels
``csrc/moe_swiglu.cu`` (forward) and ``csrc/moe_swiglu_bwd.cu``
(backward) on the card, their plain PyTorch versions ``ref.py`` on the
CPU, chosen by ``ops.py`` from the tensor's device."""
from .backward import moe_swiglu_bwd_cuda
from .kernel import LAUNCHES, moe_swiglu_cuda
from .ops import MoESwiGLUFunction, moe_swiglu
from .ref import moe_swiglu_bwd_ref, moe_swiglu_ref, moe_swiglu_split_ref

__all__ = ["LAUNCHES", "MoESwiGLUFunction", "moe_swiglu",
           "moe_swiglu_bwd_cuda", "moe_swiglu_bwd_ref", "moe_swiglu_cuda",
           "moe_swiglu_ref", "moe_swiglu_split_ref"]
