"""Transforms, transform families, the ACDC layer and SELL dispatch
(port of :mod:`repro.core`)."""
