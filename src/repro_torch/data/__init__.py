"""Synthetic LM data (port of :mod:`repro.data`)."""

from repro_torch.data.pipeline import DataConfig, SyntheticLM  # noqa: F401
