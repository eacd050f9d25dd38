"""Step builders (port of the serving half of :mod:`repro.dist`)."""
