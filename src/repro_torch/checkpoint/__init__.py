"""Training checkpoints and parameter conversion to and from the JAX
reference."""
