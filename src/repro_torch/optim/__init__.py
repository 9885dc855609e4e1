"""Optimizers of the LM training step (port of ``repro/optim``)."""
from .optimizers import Optimizer, adamw, global_norm, sgd
