"""Training of the port: the train step over autograd."""
