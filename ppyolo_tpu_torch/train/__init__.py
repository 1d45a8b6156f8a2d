"""Training of the port: losses, LR schedule, SGD policy, train step, loop."""
