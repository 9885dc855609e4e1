"""Model configurations (copies of the JAX package's pure-Python ones)."""
