"""The port's drivers, ``train`` and ``test``: ``python -m
masters_thesis_tpu_torch train|test``."""
