"""Weight conversion from the JAX package's layout."""
