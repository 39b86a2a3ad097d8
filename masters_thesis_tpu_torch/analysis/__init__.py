"""Findings of the port's checks (the serve preflight's SV rules)."""
