"""Synthetic drifting token streams and the named fleet scenarios,
copied from the JAX package (pure numpy: equal seeds draw equal tokens)."""
