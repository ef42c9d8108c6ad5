"""RG-LRU linear recurrence (kernel row 6): the CUDA kernel
``csrc/rglru_scan.cu`` on the card, its plain PyTorch version ``ref.py``
on the CPU, chosen by ``ops.py`` from the tensor's device."""
from .kernel import LAUNCHES, rglru_scan_cuda
from .ops import rglru_scan
from .ref import rglru_scan_ref

__all__ = ["LAUNCHES", "rglru_scan", "rglru_scan_cuda", "rglru_scan_ref"]
