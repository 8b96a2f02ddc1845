"""The port's benchmark: see ``harness.py`` and ``run.py``."""
