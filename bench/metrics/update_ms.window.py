"""update_ms.window: see bench/core/program.py."""
from bench.core.program import update_ms as read  # noqa: F401
