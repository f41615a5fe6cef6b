"""train_ms.window: see bench/core/readings.py."""
from bench.core.readings import train_ms as read  # noqa: F401
