"""Parameter conversion from the JAX reference."""
