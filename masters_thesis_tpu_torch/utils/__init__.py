"""Small helpers shared across the port's subsystems."""
