"""tick_ms.p95: see bench/core/readings.py."""
from bench.core.readings import tick_ms as read  # noqa: F401
