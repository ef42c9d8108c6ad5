"""The training runtime of the port: the train step, the deterministic
data stream, checkpoints, gradient compression and the mesh.

The train step is ``repro_torch.runtime.train``, imported by name: it
imports the models, whose modules import ``runtime.meshenv``, so this
package does not load it."""
from . import checkpoint, compression, data
from .data import DataConfig, StragglerAwareDispatcher, batch_at

__all__ = ["DataConfig", "StragglerAwareDispatcher", "batch_at",
           "checkpoint", "compression", "data"]
