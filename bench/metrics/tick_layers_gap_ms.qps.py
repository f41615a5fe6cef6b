"""tick_layers_gap_ms.qps: see bench/core/program.py."""
from bench.core.program import tick_layers_gap_ms as read  # noqa: F401
