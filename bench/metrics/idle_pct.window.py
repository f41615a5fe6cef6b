"""idle_pct.window: see bench/core/readings.py."""
from bench.core.readings import idle_pct as read  # noqa: F401
