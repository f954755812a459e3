"""Optimizer of the training path: AdamW with global-norm clipping."""
