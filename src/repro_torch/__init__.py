"""MCSA (arXiv:2312.16497) on PyTorch and CUDA — the port of the JAX
package ``repro``, beside it in this repository.

It imports ``torch`` and numpy, never JAX and nothing of ``repro``.
Entry points run on the card (``device=None`` means ``cuda``) unless the
caller passes ``device="cpu"``; asking for CUDA without it raises.  On
the card the fused Li-GD/MLi-GD sweep runs as a hand-written CUDA kernel
(``kernels/ligd_step/csrc/sweep.cu``), built with nvcc at first use.
"""
__version__ = "0.1.0"
