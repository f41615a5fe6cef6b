"""The port's window loop against the live JAX controller on the
oscillating_drift and bandwidth_collapse hostile scenarios under the four
frameworks, fp32 from the reference's initial weights, invariants on:
the checks of tests/test_torch_window_hostile.py (whose helpers this
file reuses), in a file of their own so that each stays short on one
worker.
"""
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from repro_torch.testing import trace as T  # noqa: E402
from test_torch_window_hostile import (check_hostile,  # noqa: E402
                                       make_engines)


@pytest.fixture(scope="module")
def engines():
    return make_engines()


@pytest.mark.parametrize("framework", T.GOLDEN_FRAMEWORKS)
@pytest.mark.parametrize("name", ["oscillating_drift", "bandwidth_collapse"])
def test_hostile_window_loop_matches_reference_fp32(name, framework,
                                                     engines):
    tctl, jctl = check_hostile(name, framework, engines)
    if name == "bandwidth_collapse":
        # the collapse reached the controller in both packages
        assert tctl.cc.local_caps == jctl.cc.local_caps
