"""Model configurations the port supports: the paper's chain CNNs and the
transformer registry (``get_config("<arch-id>")``)."""
from __future__ import annotations

from .archs import ARCH_BUILDERS
from .base import (ALL_CELLS, ATTN_GLOBAL, ATTN_LOCAL, CELLS_BY_NAME,
                   DECODE_32K, LONG_500K, PREFILL_32K, RGLRU, RWKV6, TRAIN_4K,
                   ModelConfig, ShapeCell, reduced, supports_cell)
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


def get_cell(name: str) -> ShapeCell:
    """The shape cell ``name`` (``CELLS_BY_NAME``)."""
    return CELLS_BY_NAME[name]


__all__ = ["ALL_CELLS", "ARCH_BUILDERS", "ARCH_IDS", "ATTN_GLOBAL",
           "ATTN_LOCAL", "CELLS_BY_NAME", "CNN_BUILDERS", "CNN_IDS",
           "ChainCNNConfig", "CNNLayer", "DECODE_32K", "LONG_500K",
           "ModelConfig", "PREFILL_32K", "RGLRU", "RWKV6", "ShapeCell",
           "TRAIN_4K", "get_cell", "get_config", "nin", "reduced",
           "supports_cell", "vgg16", "yolov2"]
