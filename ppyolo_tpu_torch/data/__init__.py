"""Training targets built on the device (the host data pipeline is a later slice)."""
