"""mfu_pct.window: see bench/core/readings.py."""
from bench.core.readings import mfu_pct as read  # noqa: F401
