"""Training: optimizers, the train step, checkpoints and the trainer."""
