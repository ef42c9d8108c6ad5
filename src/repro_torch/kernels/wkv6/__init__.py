"""RWKV-6 WKV recurrence (kernel row 7): the CUDA kernels
``csrc/wkv6.cu`` (forward) and ``csrc/wkv6_bwd.cu`` (backward) on the
card, their plain PyTorch versions ``ref.py`` on the CPU, chosen by
``ops.py`` from the tensor's device."""
from .backward import wkv6_bwd_cuda
from .kernel import LAUNCHES, wkv6_cuda
from .ops import WKV6Function, wkv6
from .ref import (wkv6_bwd_ref, wkv6_chunked_bwd_ref, wkv6_chunked_ref,
                  wkv6_ref)

__all__ = ["LAUNCHES", "WKV6Function", "wkv6", "wkv6_bwd_cuda",
           "wkv6_bwd_ref", "wkv6_chunked_bwd_ref", "wkv6_chunked_ref",
           "wkv6_cuda", "wkv6_ref"]
