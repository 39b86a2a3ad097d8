"""Recurrence kernels (CUDA, built at first use) and window functions."""
