"""Synthetic data-generating processes (numpy, explicit seeds)."""
