"""Serving: inference-time parameter rewrites and the batched Detector."""
