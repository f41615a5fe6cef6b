"""attn_roofline_pct.qps: flash_attention's roofline share (bench/core/readings.py)."""
from bench.core.readings import roofline

read = roofline("flash_attention")
