"""Training of the port: losses, precision policy, train state and optimizers, step factories."""
