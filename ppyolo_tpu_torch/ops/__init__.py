"""Tensor ops of the port: conv cell, DCNv2, stem, strided conv, pooling,
decode, NMS."""
