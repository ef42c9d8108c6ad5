"""The training runtime of the port: the train step, the deterministic
data stream, checkpoints and gradient compression."""
from . import checkpoint, compression, data, train
from .data import DataConfig, StragglerAwareDispatcher, batch_at
from .train import TrainConfig, make_train_step

__all__ = ["DataConfig", "StragglerAwareDispatcher", "TrainConfig",
           "batch_at", "checkpoint", "compression", "data",
           "make_train_step", "train"]
