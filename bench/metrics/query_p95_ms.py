"""query_p95_ms: see bench/core/readings.py."""
from bench.core.readings import query_p95_ms as read  # noqa: F401
