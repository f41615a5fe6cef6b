"""queries_per_s: see bench/core/readings.py."""
from bench.core.readings import queries_per_s as read  # noqa: F401
