"""The port's command-line entry points (run with ``python -m``): ``train``
and ``eval``, the root ``train.py`` and ``eval.py`` of the JAX package."""
