"""Scene description, import and table building (jax-free)."""
