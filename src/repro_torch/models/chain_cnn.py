"""Executable chain-topology CNNs (NiN / YOLOv2 / VGG16) for the paper's
experiments, and split execution: layers [0, s) on the device, [s, M) on
the edge — the computation MCSA plans for.

The port of the JAX package's ``repro/models/chain_cnn.py``, in float32.
Activations are NHWC at every function here, as in the reference; a conv
runs as ``F.conv2d`` on the channels-last view of the same memory (a
conv's weight is kept as (Cout, Cin, K, K) in channels-last memory), so
no layer copies its input to another layout.  The convolutions and the
fc products are plain PyTorch, as the reference leaves them to XLA: no
TPU kernel computes them.

Padding is TensorFlow's ``SAME``, which ``lax.conv_general_dilated`` and
``lax.reduce_window`` use: ``total = max((ceil(H/s) - 1)·s + K - H, 0)``
rows, ``total // 2`` before and the rest after (zeros for a conv, -inf
for a max pool), so a layer's output is ``ceil(H/s)`` a side.
:func:`_layer_shapes` and ``init_cnn``'s fc sizing count a pool's output
as ``H // s`` instead, as the reference's do; the two agree on every
shipped config (even sizes) and differ at an odd one (ROADMAP §3).

On the card, ``torch.backends.cudnn.allow_tf32`` (True by default)
decides whether the convolutions round their inputs to TF32; this module
sets no global flag, and callers that compare against float32 state
which setting they ran under.
"""
from __future__ import annotations

import math
from typing import List, Tuple

import torch
import torch.nn.functional as F

from repro_torch._device import resolve_device
from repro_torch.configs.chain_cnns import ChainCNNConfig, CNNLayer


def _layer_shapes(cfg: ChainCNNConfig) -> List[Tuple[int, ...]]:
    """Output (H, W, C) (or (F,) for fc) after each layer, single example."""
    h = w = cfg.in_hw
    c = cfg.in_ch
    shapes: List[Tuple[int, ...]] = []
    for layer in cfg.layers:
        if layer.kind == "conv":
            h = -(-h // layer.stride)
            w = -(-w // layer.stride)
            c = layer.out_ch
            shapes.append((h, w, c))
        elif layer.kind == "pool":
            h = max(1, h // layer.stride)
            w = max(1, w // layer.stride)
            shapes.append((h, w, c))
        else:                           # fc
            shapes.append((layer.out_features,))
    return shapes


def init_cnn(cfg: ChainCNNConfig, gen: torch.Generator,
             device=None) -> list:
    """Per-layer params on ``device`` (``None``: the card), drawn in
    float32 on the generator's device: conv -> {"w": (Cout, Cin, K, K)
    channels-last, Normal(0, 1/(K²·Cin)), "b": zeros}, pool -> {}, fc ->
    {"w": (In, Out), Normal(0, 1/In), "b": zeros}."""
    device = resolve_device(device)
    params = []
    h = w = cfg.in_hw
    c = cfg.in_ch
    flat = None

    def normal(shape, fan_in):
        x = torch.randn(shape, generator=gen, device=gen.device,
                        dtype=torch.float32) / math.sqrt(fan_in)
        return x.to(device)

    for layer in cfg.layers:
        if layer.kind == "conv":
            k = layer.kernel
            wgt = normal((layer.out_ch, k, k, c), k * k * c).permute(
                0, 3, 1, 2)                 # OHWI memory = channels-last
            params.append({"w": wgt, "b": torch.zeros(
                layer.out_ch, dtype=torch.float32, device=device)})
            h = -(-h // layer.stride)
            w = -(-w // layer.stride)
            c = layer.out_ch
        elif layer.kind == "pool":
            params.append({})
            h = max(1, h // layer.stride)
            w = max(1, w // layer.stride)
        else:
            if flat is None:
                flat = h * w * c
            params.append({"w": normal((flat, layer.out_features), flat),
                           "b": torch.zeros(layer.out_features,
                                            dtype=torch.float32,
                                            device=device)})
            flat = layer.out_features
    return params


def _same_pad(x: torch.Tensor, k: int, s: int, value: float) -> torch.Tensor:
    """NHWC x padded on H and W as ``SAME`` pads them for a window of
    ``k`` at stride ``s``."""
    pads = []
    for n in (x.shape[2], x.shape[1]):          # F.pad lists W, then H
        total = max((-(-n // s) - 1) * s + k - n, 0)
        pads += [total // 2, total - total // 2]
    if not any(pads):
        return x
    return F.pad(x, (0, 0, *pads), value=value)


def apply_layer(layer: CNNLayer, p: dict, x: torch.Tensor) -> torch.Tensor:
    """x: NHWC, or (N, F) for fc chains."""
    if layer.kind == "conv":
        xp = _same_pad(x, layer.kernel, layer.stride, 0.0)
        y = F.conv2d(xp.permute(0, 3, 1, 2), p["w"], p["b"],
                     stride=layer.stride)
        return torch.relu(y).permute(0, 2, 3, 1)
    if layer.kind == "pool":
        xp = _same_pad(x, layer.kernel, layer.stride, -math.inf)
        y = F.max_pool2d(xp.permute(0, 3, 1, 2), layer.kernel,
                         layer.stride)
        return y.permute(0, 2, 3, 1)
    if x.dim() > 2:                             # NHWC flatten order
        x = x.reshape(x.shape[0], -1)
    return torch.relu(x @ p["w"] + p["b"])


def forward_range(cfg: ChainCNNConfig, params: list, x: torch.Tensor,
                  start: int, stop: int) -> torch.Tensor:
    """Apply layers [start, stop) — the split-execution primitive."""
    for i in range(start, stop):
        x = apply_layer(cfg.layers[i], params[i], x)
    return x


def forward(cfg: ChainCNNConfig, params: list,
            x: torch.Tensor) -> torch.Tensor:
    return forward_range(cfg, params, x, 0, len(cfg.layers))


def split_inference(cfg: ChainCNNConfig, params: list, x: torch.Tensor,
                    split: int):
    """Run the device part and the edge part separately; returns
    (intermediate activation shipped over the network, final logits)."""
    inter = forward_range(cfg, params, x, 0, split)
    out = forward_range(cfg, params, inter, split, len(cfg.layers))
    return inter, out


__all__ = ["apply_layer", "forward", "forward_range", "init_cnn",
           "split_inference"]
