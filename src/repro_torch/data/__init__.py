"""Data substrate of the training path (the port's own copy)."""
