"""window_ms: see bench/core/readings.py."""
from bench.core.readings import window_ms as read  # noqa: F401
