"""The port's GAIMD fluid model (`repro_torch.core.gaimd`, a host fp32
numpy loop) against the JAX package's jitted `lax.scan`.

Every step rounds as the reference's does, so trajectories and final
rates are equal bit for bit, and `simulate_warm` stops after the same
number of steps. The means over steps agree within 1e-5 relative: XLA
sums each (steps, N) column in an order of its own (ROADMAP.md queue 3).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from repro.core import gaimd as jgaimd  # noqa: E402
from repro_torch.core import gaimd  # noqa: E402

MEAN_RTOL = 1e-5
SIZES = (0, 1, 3, 8, 100, 10_000)


def _flows(n, caps, seed=0):
    rng = np.random.default_rng(seed + n)
    alpha = (rng.uniform(0.05, 1.0, n) / max(1, n) * 8).astype(np.float32)
    beta = rng.choice(np.array([0.5, 0.7], np.float32), n)
    if caps == "inf":
        cap = np.full(n, np.inf, np.float32)
    else:
        cap = rng.uniform(0.05, 2.0, n).astype(np.float32)
        cap[::3] = np.inf
    r0 = (rng.uniform(0.0, 0.5, n) / max(1, n) * 8).astype(np.float32)
    return alpha, beta, cap, r0


@pytest.mark.parametrize("warm", [False, True], ids=["cold", "warm"])
@pytest.mark.parametrize("caps", ["inf", "finite"])
@pytest.mark.parametrize("n", SIZES)
def test_simulate_trajectory_bit_for_bit(n, caps, warm):
    alpha, beta, cap, r0 = _flows(n, caps)
    kw = dict(steps=500, r0=r0 if warm else None)
    jr, jf = jgaimd.simulate(alpha, beta, cap, 8.0, **kw)
    pr, pf = gaimd.simulate(alpha, beta, cap, 8.0, **kw)
    assert pr.dtype == pf.dtype == np.float32
    np.testing.assert_array_equal(pr, np.asarray(jr))
    np.testing.assert_array_equal(pf, np.asarray(jf))


@pytest.mark.parametrize("caps", ["inf", "finite"])
@pytest.mark.parametrize("n", SIZES)
def test_simulate_warm_steps_final_and_means(n, caps):
    alpha, beta, cap, r0 = _flows(n, caps, seed=5)
    for start in (None, r0):
        jm, jf, js = jgaimd.simulate_warm(alpha, beta, cap, 8.0, r0=start)
        pm, pf, ps = gaimd.simulate_warm(alpha, beta, cap, 8.0, r0=start)
        assert ps == js
        np.testing.assert_array_equal(pf, np.asarray(jf))
        assert pm.dtype == np.float64 and pm.shape == (n,)
        np.testing.assert_allclose(pm, jm, rtol=MEAN_RTOL, atol=0)


def test_simulate_warm_from_its_final_state_matches_cold():
    """tests/test_transmission_plane.py's warm-start contract, on the
    port, with the step counts of both starts equal to the reference's."""
    alpha = np.array([0.2, 0.4, 0.8], np.float32)
    beta = np.full(3, 0.5, np.float32)
    caps = np.full(3, np.inf, np.float32)
    cold, final, steps_cold = gaimd.simulate_warm(alpha, beta, caps, 12.0)
    warm, _, steps_warm = gaimd.simulate_warm(alpha, beta, caps, 12.0,
                                              r0=final)
    assert steps_warm <= steps_cold < 4000
    assert (steps_cold, steps_warm) == (
        jgaimd.simulate_warm(alpha, beta, caps, 12.0)[2],
        jgaimd.simulate_warm(alpha, beta, caps, 12.0, r0=final)[2])
    assert gaimd.proportionality_error(warm, cold) < 0.05
    assert gaimd.proportionality_error(warm, alpha / (1 - beta)) < 0.1


def test_steady_state_rates_within_mean_tolerance():
    alpha, beta, cap, _ = _flows(100, "finite", seed=3)
    np.testing.assert_allclose(
        gaimd.steady_state_rates(alpha, beta, cap, 8.0),
        np.asarray(jgaimd.steady_state_rates(alpha, beta, cap, 8.0)),
        rtol=MEAN_RTOL, atol=0)


def test_ecco_params_and_proportionality_error_equal():
    p = [0.75, 0.75, 0.75, 0.25, 0.0]
    n = [3, 3, 3, 1, 0]
    for want, got in zip(jgaimd.ecco_params(p, n, beta=0.6, alpha_scale=2),
                         gaimd.ecco_params(p, n, beta=0.6, alpha_scale=2)):
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
    for r, t in (([1, 1], [1, 1]), ([1, 0], [0, 1]), ([3, 1], [1, 1]),
                 ([0, 0], [0, 0])):
        assert gaimd.proportionality_error(r, t) == \
            jgaimd.proportionality_error(r, t)


def test_steady_state_is_share_proportional():
    """The law ECCO relies on (tests/test_gaimd.py, on the port): with
    alpha = p_j / n_j a group's aggregate rate follows its GPU share."""
    alpha, beta = gaimd.ecco_params([0.75] * 3 + [0.25], [3] * 3 + [1])
    r = gaimd.steady_state_rates(alpha, beta, np.full(4, np.inf), 40.0)
    g1, g2 = r[:3].sum(), r[3]
    np.testing.assert_allclose(g1 / (g1 + g2), 0.75, atol=0.08)
