"""Training of the port: schedules, the optimizer and the train step,
full-state checkpoints and the training loop (``--mode train``)."""
