"""attn_roofline_pct.p95: flash_attention's roofline share (bench/core/readings.py)."""
from bench.core.readings import roofline

read = roofline("flash_attention")
