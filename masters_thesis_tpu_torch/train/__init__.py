"""Step functions shared by serving and, later, training."""
