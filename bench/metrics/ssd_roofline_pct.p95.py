"""ssd_roofline_pct.p95: ssd_scan's roofline share (bench/core/readings.py)."""
from bench.core.readings import roofline

read = roofline("ssd_scan")
