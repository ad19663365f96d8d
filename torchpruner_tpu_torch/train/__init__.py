"""Training of the port: the loop, the functional optimizers, the logger."""
