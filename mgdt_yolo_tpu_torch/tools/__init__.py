"""Measurement scripts of the PyTorch port (run on the GPU)."""
