from gamd_tpu_torch.train.data import (
    TrajectoryDataset,
    RealLargeDataset,
    batch_iterator,
)
from gamd_tpu_torch.train.state import TrainState, create_train_state
from gamd_tpu_torch.train.loop import make_train_step, make_eval_step, train
from gamd_tpu_torch.train.checkpoint import save_checkpoint, load_checkpoint
from gamd_tpu_torch.train.forcefield import GNNForceField

__all__ = [
    "TrajectoryDataset",
    "RealLargeDataset",
    "batch_iterator",
    "TrainState",
    "create_train_state",
    "make_train_step",
    "make_eval_step",
    "train",
    "save_checkpoint",
    "load_checkpoint",
    "GNNForceField",
]
