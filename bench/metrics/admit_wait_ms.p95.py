"""admit_wait_ms.p95: see bench/core/readings.py."""
from bench.core.readings import admit_wait_ms as read  # noqa: F401
