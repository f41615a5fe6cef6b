"""prefill_gap_ms.p95: see bench/core/program.py."""
from bench.core.program import prefill_gap_ms as read  # noqa: F401
