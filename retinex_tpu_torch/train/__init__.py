"""Training of the port: schedules, the optimizer and the train step,
full-state checkpoints in the JAX package's Orbax layout and the training
loop (``--mode train``)."""
