"""Training drivers (port of the JAX package's ``parallel/``)."""
