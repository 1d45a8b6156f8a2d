"""Logging, FLOP accounting and profiling helpers (``ppyolo_tpu/utils``)."""
