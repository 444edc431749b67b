"""The port's Monte-Carlo cells against the JAX package's.

``monte_carlo_error`` draws its codes and masks from
``np.random.default_rng(seed)`` in both packages, so the same seed gives
the same ensembles; the decode then runs through the port's engine on the
CPU (plain kernels, fp32 V, fp64 errors) and must give the same means to
rtol 1e-5, and the same one-step golden means the JAX package pins.
"""

import numpy as np
import pytest

from repro.core import simulate as ref_sim

from repro_torch.core import simulate as pt_sim
from test_golden_mc import GOLDEN_MEANS, K, SEED

CPU = "cpu"


def test_sampled_masks_bitwise():
    for trials, ns in [(7, 0), (50, 5), (3, 17)]:
        a = ref_sim.sample_straggler_masks(17, ns, trials,
                                           np.random.default_rng(9))
        b = pt_sim.sample_straggler_masks(17, ns, trials,
                                          np.random.default_rng(9))
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("scheme,s", [("bgc", 4), ("frc", 4), ("sbm", 4),
                                      ("expander", 4), ("cyclic", 3),
                                      ("sregular", 4), ("rbgc", 4),
                                      ("uncoded", 1)])
@pytest.mark.parametrize("decoder", ["onestep", "ignore"])
def test_monte_carlo_matches_reference(scheme, s, decoder):
    kw = dict(k=36, n=36, s=s, delta=0.25, trials=96, decoder=decoder,
              seed=3, code_draws=4)
    got = pt_sim.monte_carlo_error(scheme, device=CPU, **kw)
    for backend in ("pallas_interpret", "numpy"):
        want = ref_sim.monte_carlo_error(scheme, backend=backend, **kw)
        assert got.mean == pytest.approx(want.mean, rel=1e-5)
        assert got.p_zero == want.p_zero
        assert got.q95 == pytest.approx(want.q95, rel=1e-5, abs=1e-9)


@pytest.mark.parametrize("cell,golden", sorted(
    (c, g) for c, g in GOLDEN_MEANS.items() if c[3] == "onestep"))
def test_golden_onestep_means_through_the_port(cell, golden):
    scheme, s, delta, decoder, trials = cell
    got = pt_sim.monte_carlo_error(scheme, k=K, n=K, s=s, delta=delta,
                                   trials=trials, decoder=decoder, seed=SEED,
                                   device=CPU)
    assert got.mean == pytest.approx(golden, rel=1e-5)


def test_sweep_delta_matches_reference():
    kw = dict(k=24, s=3, trials=40, seed=1)
    got = pt_sim.sweep_delta(["frc", "bgc"], [0.1, 0.3], device=CPU, **kw)
    want = ref_sim.sweep_delta(["frc", "bgc"], [0.1, 0.3], **kw)
    assert [(r.scheme, r.delta) for r in got] == \
        [(r.scheme, r.delta) for r in want]
    for a, b in zip(got, want):
        assert a.mean == pytest.approx(b.mean, rel=1e-5)


def test_algorithmic_curve_matches_reference():
    kw = dict(k=24, s=3, delta=0.2, trials=30, iters=4, seed=2)
    np.testing.assert_allclose(pt_sim.algorithmic_curve_mc("bgc", **kw),
                               ref_sim.algorithmic_curve_mc("bgc", **kw),
                               rtol=1e-12)
