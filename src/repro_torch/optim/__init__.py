"""The optimizer of the port's training path: AdamW over parameter
trees and its learning-rate schedules."""
from .adamw import AdamWConfig, AdamWState, global_norm, init, update
from . import schedules

__all__ = ["AdamWConfig", "AdamWState", "global_norm", "init",
           "schedules", "update"]
