"""grads_gap_ms.window: see bench/core/program.py."""
from bench.core.program import grads_gap_ms as read  # noqa: F401
