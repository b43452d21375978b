"""Loading, random models, JAX-tree conversion, device checks."""
