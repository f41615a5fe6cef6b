"""idle_pct.qps: see bench/core/readings.py."""
from bench.core.readings import idle_pct as read  # noqa: F401
