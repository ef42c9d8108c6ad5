"""Model configurations the port supports: the paper's chain CNNs and the
transformer registry (``get_config("<arch-id>")``)."""
from __future__ import annotations

from .archs import ARCH_BUILDERS
from .base import (ATTN_GLOBAL, ATTN_LOCAL, RGLRU, RWKV6, ModelConfig,
                   reduced)
from .chain_cnns import (CNN_BUILDERS, ChainCNNConfig, CNNLayer, nin,
                         vgg16, yolov2)

CNN_IDS = tuple(sorted(CNN_BUILDERS))
ARCH_IDS = tuple(sorted(ARCH_BUILDERS))

_REGISTRY = dict(ARCH_BUILDERS)
_REGISTRY.update(CNN_BUILDERS)


def get_config(name: str):
    """The config of ``name``: a :class:`ModelConfig` for a transformer,
    a :class:`ChainCNNConfig` for a chain CNN."""
    try:
        return _REGISTRY[name]()
    except KeyError:
        raise KeyError(
            f"unknown arch {name!r}; available: {sorted(_REGISTRY)}") from None


__all__ = ["ARCH_BUILDERS", "ARCH_IDS", "ATTN_GLOBAL", "ATTN_LOCAL",
           "CNN_BUILDERS", "CNN_IDS", "ChainCNNConfig", "CNNLayer",
           "ModelConfig", "RGLRU", "RWKV6", "get_config", "nin", "reduced",
           "vgg16", "yolov2"]
