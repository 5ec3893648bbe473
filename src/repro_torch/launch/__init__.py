"""Training steps and the training launcher of the port."""
