"""Flash attention (kernel row 3): the CUDA kernel
``csrc/flash_attention.cu`` on the card, its plain PyTorch version
``ref.py`` on the CPU, chosen by ``ops.py`` from the tensor's device."""
from .kernel import LAUNCHES, flash_attention_cuda
from .ops import flash_attention
from .ref import attention_ref

__all__ = ["LAUNCHES", "attention_ref", "flash_attention",
           "flash_attention_cuda"]
