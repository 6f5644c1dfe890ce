"""Tensor operations of the PyTorch port: resampling, boxes, DCNv2, NMS."""
