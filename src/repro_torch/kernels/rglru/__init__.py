"""RG-LRU linear recurrence (kernel row 6): the CUDA kernels
``csrc/rglru_scan.cu`` (forward) and ``csrc/rglru_scan_bwd.cu``
(backward) on the card, their plain PyTorch versions ``ref.py`` on the
CPU, chosen by ``ops.py`` from the tensor's device."""
from .backward import rglru_scan_bwd_cuda
from .kernel import LAUNCHES, rglru_scan_cuda
from .ops import RGLRUScanFunction, rglru_scan
from .ref import rglru_scan_bwd_ref, rglru_scan_ref

__all__ = ["LAUNCHES", "RGLRUScanFunction", "rglru_scan",
           "rglru_scan_bwd_cuda", "rglru_scan_bwd_ref", "rglru_scan_cuda",
           "rglru_scan_ref"]
