"""Training: optimizers, LR schedules and the trainers."""
