"""Training of the port (`repro.train` counterpart): optimizers, the train
step, checkpoints and the fault-tolerant loop."""
from repro_torch.train.checkpoint import CheckpointManager, install_preemption_handler
from repro_torch.train.loop import LoopConfig, train
from repro_torch.train.optimizer import OptConfig, make_optimizer
from repro_torch.train.step import TrainConfig, make_train_step

__all__ = ["CheckpointManager", "LoopConfig", "OptConfig", "TrainConfig",
           "install_preemption_handler", "make_optimizer", "make_train_step",
           "train"]
