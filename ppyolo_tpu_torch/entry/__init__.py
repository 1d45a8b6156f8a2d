"""The port's command-line entry points (run with ``python -m``): ``train``,
``eval``, ``test_dev`` and ``demo``, the root ``train.py``, ``eval.py``,
``test_dev.py`` and ``demo.py`` of the JAX package."""
