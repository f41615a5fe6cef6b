"""attn_roofline_pct.window: flash_attention's roofline share (bench/core/readings.py)."""
from bench.core.readings import roofline

read = roofline("flash_attention")
