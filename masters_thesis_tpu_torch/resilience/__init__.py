"""Resilience: the deterministic fault plan (``faults``)."""
