"""RWKV-6 WKV recurrence (kernel row 7): the CUDA kernel ``csrc/wkv6.cu``
on the card, its plain PyTorch version ``ref.py`` on the CPU, chosen by
``ops.py`` from the tensor's device."""
from .kernel import LAUNCHES, wkv6_cuda
from .ops import wkv6
from .ref import wkv6_ref

__all__ = ["LAUNCHES", "wkv6", "wkv6_cuda", "wkv6_ref"]
