"""Training of the port: optimizers and the IRNet train step."""
