"""Model configurations the port supports: the paper's chain CNNs."""
from __future__ import annotations

from .chain_cnns import (CNN_BUILDERS, ChainCNNConfig, CNNLayer, nin,
                         vgg16, yolov2)

CNN_IDS = tuple(sorted(CNN_BUILDERS))

__all__ = ["CNN_BUILDERS", "CNN_IDS", "ChainCNNConfig", "CNNLayer", "nin",
           "vgg16", "yolov2"]
