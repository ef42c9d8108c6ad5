"""Serving on one card: MCSA split execution (:mod:`.split`), the
continuous-batching engine (:mod:`.engine`), failover accounting
(:mod:`.failover`) and the closed-loop data plane (:mod:`.dataplane`:
one engine pool per edge server, deadlines, backpressure, mid-stream
failover, in virtual time)."""
from .dataplane import (DEGRADED, DEVICE, DONE, TERMINAL, EnginePool,
                        ServeConfig, ServeRequest, ServingDataPlane,
                        default_engine_factory, slots_from_usage)
from .engine import (CacheOverflowError, IncompleteRunError,
                     InferenceEngine)
from .failover import (FAILOVER_MODES, MIGRATE, REPREFILL, FailoverEvent,
                       FailoverReport, ServerLostError, leaf_bits,
                       migration_price, reprefill_price)
from .split import (SplitServer, activation_bits, device_prefix,
                    edge_suffix, layer_params)

__all__ = ["CacheOverflowError", "DEGRADED", "DEVICE", "DONE",
           "EnginePool", "FAILOVER_MODES", "FailoverEvent",
           "FailoverReport", "IncompleteRunError", "InferenceEngine",
           "MIGRATE", "REPREFILL", "ServeConfig", "ServeRequest",
           "ServerLostError", "ServingDataPlane", "SplitServer", "TERMINAL",
           "activation_bits", "default_engine_factory", "device_prefix",
           "edge_suffix", "layer_params", "leaf_bits", "migration_price",
           "reprefill_price", "slots_from_usage"]
