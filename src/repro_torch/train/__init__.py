"""Training: the step factory and the loop with its anomaly ladder."""
