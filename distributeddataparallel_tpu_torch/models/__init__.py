"""The transformer LM family and weight transfer from the JAX package."""
