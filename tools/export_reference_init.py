#!/usr/bin/env python3
"""Write the JAX package's initial weights of the golden engine to one
`.npz`, so that the port can start from them where JAX is absent:

    JAX_PLATFORMS=cpu python3 tools/export_reference_init.py \
        [--out tests/fixtures/golden_engine_init.npz]

The golden traces (tests/golden/) were trained from the reference's
`SharedEngine.fresh_state(0)` of the golden engine (`repro.testing.trace.
make_engine_for` on the golden scenario: olmo-1b at smoke width, 2
layers of d_model 64, the scenario's vocabulary of 64). The file holds
that state's parameters, one entry per leaf keyed by its path
(`repro_torch.models.convert.save_params_npz`); the AdamW moments start
at zero and are not stored. tests/test_torch_window_golden.py holds the
file bit for bit to a live `fresh_state(0)`.

This tool runs the JAX package and is not part of the port.
"""
import argparse
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(HERE, os.pardir, "src"))
OUT = os.path.join(HERE, os.pardir, "tests", "fixtures",
                   "golden_engine_init.npz")


def reference_init(seed: int = 0):
    """The reference golden engine's fresh_state(seed) params, as numpy."""
    import jax
    import numpy as np

    from repro.testing import trace
    engine = trace.make_engine_for(trace.golden_scenario())
    return jax.tree.map(np.asarray, engine.fresh_state(seed)["params"])


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default=OUT)
    args = ap.parse_args(argv)
    from repro_torch.models.convert import save_params_npz
    save_params_npz(reference_init(0), args.out)
    print(f"wrote {os.path.normpath(args.out)}")


if __name__ == "__main__":
    main()
