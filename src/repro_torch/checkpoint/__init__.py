"""Checkpoints (port of :mod:`repro.checkpoint`)."""

from repro_torch.checkpoint.manager import CheckpointManager  # noqa: F401
