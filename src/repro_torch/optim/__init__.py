"""Optimizers and learning-rate schedules over trees of tensors
(copies of the JAX package's ``optim``)."""
from .optimizers import (Optimizer, adam, adamw, apply_updates, fedadam,
                         fedyogi, global_norm, make, sgd, tree_leaves,
                         tree_map)
from .schedules import constant, inverse_sqrt, warmup_cosine
