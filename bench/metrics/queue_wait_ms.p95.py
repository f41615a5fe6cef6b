"""queue_wait_ms.p95: see bench/core/program.py."""
from bench.core.program import queue_wait_ms as read  # noqa: F401
