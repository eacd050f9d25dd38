"""Command-line entry points (port of :mod:`repro.launch`)."""
