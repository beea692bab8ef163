"""Training substrate: optimizers, the train step, checkpoints, data and
gradient compression (port of ``repro/train``)."""
from repro_torch.train import (checkpoint, data, grad_compress, optimizer,
                               trainstep)
from repro_torch.train.optimizer import AdamWConfig, AdamWState
from repro_torch.train.trainstep import make_train_step

__all__ = ["checkpoint", "data", "grad_compress", "optimizer", "trainstep",
           "AdamWConfig", "AdamWState", "make_train_step"]
