"""Synthetic input data of the PyTorch port."""
