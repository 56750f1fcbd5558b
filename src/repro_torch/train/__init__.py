"""Training: the train step (loss -> grads -> AdamW) and the fault-tolerant
trainer loop (the reference's ``train`` exports; its CLI, ``launch/train``,
and the step's mesh shardings wait for the ``torch.distributed`` slice)."""

from repro_torch.train.step import TrainStepConfig, make_train_step
from repro_torch.train.trainer import Trainer, TrainerConfig

__all__ = ["TrainStepConfig", "Trainer", "TrainerConfig", "make_train_step"]
