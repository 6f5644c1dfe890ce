"""Build helpers of the PyTorch port."""
