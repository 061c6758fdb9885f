"""Optimizers and learning-rate schedules over dicts of tensors
(copies of the JAX package's ``optim``)."""
from .optimizers import (Optimizer, adam, adamw, apply_updates, fedadam,
                         fedyogi, global_norm, make, sgd)
from .schedules import constant, inverse_sqrt, warmup_cosine
