"""Model configurations (port of :mod:`repro.configs`)."""
