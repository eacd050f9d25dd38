"""Synthetic LM data (port of :mod:`repro.data`)."""

from repro_torch.data.pipeline import (  # noqa: F401
    DataConfig, SyntheticLM, make_batch_specs)
