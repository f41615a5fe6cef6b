"""ssd_roofline_pct.p95: see bench/core/readings.py."""
from bench.core.readings import ssd_roofline_pct as read  # noqa: F401
