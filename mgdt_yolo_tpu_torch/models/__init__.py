"""Model configurations of the PyTorch port, as Python literals."""
