"""Tensor ops of the port: conv cell, DCNv2, stem, pooling, decode, NMS."""
