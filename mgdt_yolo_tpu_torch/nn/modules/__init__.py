"""Building blocks of the flagship graph (NCHW modules)."""
