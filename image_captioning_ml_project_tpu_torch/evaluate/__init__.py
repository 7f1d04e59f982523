"""Caption metrics of the port (a copy of the JAX package's host-side
scorers)."""
