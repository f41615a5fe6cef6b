"""attn_roofline_pct.window: see bench/core/readings.py."""
from bench.core.readings import attn_roofline_pct as read  # noqa: F401
