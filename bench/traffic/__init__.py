"""Traffic generators, one module a kind, and the mixes as data."""
