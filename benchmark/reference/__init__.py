"""The plain reference: it imports nothing of the port, nor JAX."""
