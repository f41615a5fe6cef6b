"""setup_s: see bench/core/readings.py."""
from bench.core.readings import setup_s as read  # noqa: F401
