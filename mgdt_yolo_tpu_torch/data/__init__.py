"""Input data of the PyTorch port: synthetic scenes, batches and the letterbox."""
