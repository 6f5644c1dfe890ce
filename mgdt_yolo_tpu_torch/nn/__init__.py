"""Modules and the model graph of the PyTorch port."""
