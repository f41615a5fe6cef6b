"""eval_ms.window: see bench/core/readings.py."""
from bench.core.readings import eval_ms as read  # noqa: F401
