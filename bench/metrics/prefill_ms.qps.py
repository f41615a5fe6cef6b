"""prefill_ms.qps: see bench/core/readings.py."""
from bench.core.readings import prefill_ms as read  # noqa: F401
