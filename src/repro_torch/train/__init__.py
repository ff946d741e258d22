"""Training: optimizers, gradient compression and the train steps."""
