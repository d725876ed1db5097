"""repro_torch.train — the optimizers and the training-step builder, the
port of :mod:`repro.train`."""

from repro_torch.train.optimizer import OptConfig
from repro_torch.train.trainer import (abstract_state, build_train_step,
                                       init_state)

__all__ = ["OptConfig", "abstract_state", "build_train_step", "init_state"]
