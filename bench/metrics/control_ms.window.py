"""control_ms.window: see bench/core/readings.py."""
from bench.core.readings import control_ms as read  # noqa: F401
