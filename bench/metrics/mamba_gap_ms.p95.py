"""mamba_gap_ms.p95: device idle time under the grouped fleet tick's
Mamba-2 steps (the program's span `ecco.tick.mamba`), per tick, in a run
that `bench/spans.py` made with the program's tracer on; None in any other
run (bench/core/program.py)."""
from bench.core import program


def read(run):
    g, c = program._stretch(run)
    if g is None or not c.get("ecco.tick"):
        return None
    return 1e3 * g.get("ecco.tick.mamba", 0.0) / c["ecco.tick"]
