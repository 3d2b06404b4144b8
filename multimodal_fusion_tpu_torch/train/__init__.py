"""Training of the port: the survival trainer, its optimizers, schedules, metrics and checkpoints."""
