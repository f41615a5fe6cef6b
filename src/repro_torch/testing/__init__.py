"""Test harnesses of the port: the window-level fleet invariants
(`invariants.py`) and the golden-trace runner (`trace.py`)."""
