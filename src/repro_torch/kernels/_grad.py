"""Where a gradient may and may not flow through the port's kernels.

Rows 3 (attention) and 4 (RMSNorm) have backward kernels and are
``torch.autograd.Function`` s.  Rows 5 (the fused expert SwiGLU), 6 (the
RG-LRU scan) and 7 (WKV6) have none yet: their CUDA outputs carry no
autograd history, so a ``backward()`` through them would leave their
inputs' gradients silently missing.  On the card they refuse, with
:func:`refuse_grad`, any call that autograd records.  Serving never
meets the refusal: its parameters and inputs require no gradient."""
from __future__ import annotations

import torch

#: the ROADMAP item that the refused training paths wait for
TRAIN_DEFERRED = ("ROADMAP item 7b (training for MoE, RWKV-6, "
                  "RecurrentGemma and the encoder-decoder)")


def refuse_grad(kernel: str, *tensors) -> None:
    """Raise ``NotImplementedError`` when autograd is recording and one of
    ``tensors`` requires a gradient."""
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in tensors):
        raise NotImplementedError(
            f"{kernel}: no backward kernel on CUDA yet, and its output "
            "would carry no gradient; it waits for " + TRAIN_DEFERRED)
