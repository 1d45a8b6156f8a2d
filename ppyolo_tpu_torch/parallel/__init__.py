"""Data parallelism of the port over ``torch.distributed`` (``dist.py``)."""
