"""Training: step functions, optimizer, scheduler, checkpoints, trainer."""
