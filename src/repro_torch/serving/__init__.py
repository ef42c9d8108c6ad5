"""Serving on one card: MCSA split execution (:mod:`.split`), the
continuous-batching engine (:mod:`.engine`) and failover accounting
(:mod:`.failover`)."""
from .engine import (CacheOverflowError, IncompleteRunError,
                     InferenceEngine)
from .failover import (FailoverEvent, FailoverReport, ServerLostError,
                       leaf_bits, migration_price, reprefill_price)
from .split import (SplitServer, activation_bits, device_prefix,
                    edge_suffix, layer_params)

__all__ = ["CacheOverflowError", "FailoverEvent", "FailoverReport",
           "IncompleteRunError", "InferenceEngine", "ServerLostError",
           "SplitServer", "activation_bits", "device_prefix", "edge_suffix",
           "layer_params", "leaf_bits", "migration_price", "reprefill_price"]
