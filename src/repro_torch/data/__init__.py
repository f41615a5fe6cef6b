"""Synthetic drifting token streams and the named fleet scenarios, and the
data plane between streams and jobs (the group pipeline and the
teachers), copied from the JAX package (the streams, scenarios and
pipeline are pure numpy: equal seeds draw equal tokens and batches)."""
