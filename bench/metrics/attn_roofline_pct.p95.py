"""attn_roofline_pct.p95: see bench/core/readings.py."""
from bench.core.readings import attn_roofline_pct as read  # noqa: F401
