"""FLOP and byte counts from configuration shapes, and the peaks."""
