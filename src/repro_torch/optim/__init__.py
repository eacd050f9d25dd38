"""Optimizers and learning-rate schedules (port of :mod:`repro.optim`)."""

from repro_torch.optim.optimizers import (  # noqa: F401
    Optimizer,
    OptimizerConfig,
    adamw,
    global_norm,
    make_optimizer,
    sgd_momentum,
    tree_flatten,
    tree_map,
    tree_paths,
    tree_unflatten,
)
from repro_torch.optim.schedules import (  # noqa: F401
    constant_schedule,
    cosine_schedule,
    step_decay_schedule,
)
