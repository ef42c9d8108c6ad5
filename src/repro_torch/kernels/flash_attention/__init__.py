"""Flash attention (kernel row 3): the CUDA kernels
``csrc/flash_attention.cu`` (forward) and ``csrc/flash_attention_bwd.cu``
(backward) on the card, their plain PyTorch versions ``ref.py`` on the
CPU, chosen by ``ops.py`` from the tensor's device."""
from .backward import flash_attention_bwd_cuda
from .kernel import LAUNCHES, flash_attention_cuda
from .ops import FlashAttentionFunction, flash_attention
from .ref import attention_bwd_ref, attention_ref

__all__ = ["FlashAttentionFunction", "LAUNCHES", "attention_bwd_ref",
           "attention_ref", "flash_attention", "flash_attention_bwd_cuda",
           "flash_attention_cuda"]
