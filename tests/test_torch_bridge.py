"""The PyTorch port's numpy layer against the JAX package, and the bridge
the differential tests use to feed both packages the same state.

The port keeps its own copies of the numpy modules (codes, registry,
theory, decoding, adversary, straggler models, traces, assignment); from
the same seed they must build the same codes, masks and traces bit for
bit.  ``port_code`` / ``port_trace`` carry a reference object's arrays
into the port's types, so every differential test decodes the same G
and replays the same trace in both packages, not only the same seed.
"""

import numpy as np
import pytest
import torch

from repro.core import assignment as ref_assignment
from repro.core import decoding as ref_decoding
from repro.core import registry as ref_registry
from repro.core import theory as ref_theory
from repro.runtime import straggler as ref_straggler
from repro.sim import traces as ref_traces

from repro_torch.core import assignment as pt_assignment
from repro_torch.core import codes as pt_codes
from repro_torch.core import decoding as pt_decoding
from repro_torch.core import registry as pt_registry
from repro_torch.core import theory as pt_theory
from repro_torch.runtime import straggler as pt_straggler
from repro_torch.sim import traces as pt_traces

# The port's CPU tests run many tiny torch ops while other test workers
# share the cores; one intra-op thread keeps torch's OpenMP pool from
# spinning on cores the other workers need.
torch.set_num_threads(1)

FAMILIES = tuple(f.name for f in ref_registry.families())
# straggler model / trace source -> constructor kwargs
MODEL_KW = {"none": {}, "iid": {"delta": 0.2, "seed": 5},
            "fixed": {"delta": 0.2, "seed": 5}, "deadline": {"seed": 5},
            "correlated": {"pod_size": 4, "seed": 5},
            "bimodal": {"seed": 5}, "clustered": {"seed": 5}}


def port_code(code) -> pt_codes.GradientCode:
    """The port's GradientCode holding a reference code's G."""
    return pt_codes.GradientCode.from_arrays(
        code.G, code.name, code.s, seed=code.seed, params=code.params)


def port_trace(trace) -> pt_traces.LatencyTrace:
    """The port's LatencyTrace replaying a reference trace's latencies."""
    return pt_traces.LatencyTrace.from_arrays(trace.latencies,
                                              source=trace.source)


def family_s(name: str, k: int, s: int) -> int:
    """The legal s closest to `s` for a family at k = n."""
    legal = ref_registry.get(name).legal_s(k, k)
    return min(legal, key=lambda v: (abs(v - s), v))


def test_registry_names_match():
    assert pt_registry.names() == ref_registry.names()
    assert pt_registry.randomized_schemes() == ref_registry.randomized_schemes()


@pytest.mark.parametrize("name", FAMILIES)
@pytest.mark.parametrize("k,s", [(30, 3), (53, 5)])
def test_registry_make_bitwise(name, k, s):
    s = family_s(name, k, s)
    ref = ref_registry.make(name, k=k, n=k, s=s, seed=11)
    got = pt_registry.make(name, k=k, n=k, s=s, seed=11)
    assert got.name == ref.name and got.s == ref.s
    assert got.params == ref.params
    np.testing.assert_array_equal(got.G, ref.G)
    for a, b in zip(got.ell(), ref.ell()):
        np.testing.assert_array_equal(a, b)
    assert pt_registry.get(name).legal_s(k, k) == \
        ref_registry.get(name).legal_s(k, k)


@pytest.mark.parametrize("name", FAMILIES)
def test_port_code_from_arrays(name):
    k = 24
    ref = ref_registry.make(name, k=k, n=k, s=family_s(name, k, 3), seed=2)
    got = port_code(ref)
    assert isinstance(got, pt_codes.GradientCode)
    np.testing.assert_array_equal(got.G, ref.G)
    assert got.G is not ref.G                    # a private copy
    assert (got.name, got.s, got.seed, got.params) == \
        (ref.name, ref.s, ref.seed, ref.params)
    np.testing.assert_array_equal(got.ell()[0], ref.ell()[0])
    np.testing.assert_array_equal(got.ell()[1], ref.ell()[1])


def test_from_arrays_rejects_non_matrix():
    with pytest.raises(ValueError, match="must be"):
        pt_codes.GradientCode.from_arrays(np.ones(4), "bgc", 2)


@pytest.mark.parametrize("source", ["pareto", "bimodal", "clustered",
                                    "correlated", "iid", "fixed", "none"])
def test_make_trace_bitwise(source):
    kw = MODEL_KW["deadline" if source == "pareto" else source]
    ref = ref_traces.make_trace(source, steps=40, n=17, **kw)
    got = pt_traces.make_trace(source, steps=40, n=17, **kw)
    np.testing.assert_array_equal(got.latencies, ref.latencies)
    assert got.source == ref.source


def test_port_trace_from_arrays():
    ref = ref_traces.make_trace("pareto", steps=12, n=9, seed=1)
    got = port_trace(ref)
    assert isinstance(got, pt_traces.LatencyTrace)
    np.testing.assert_array_equal(got.latencies, ref.latencies)
    assert got.latencies is not ref.latencies
    with pytest.raises(ValueError):
        pt_traces.LatencyTrace.from_arrays(np.ones(3))


@pytest.mark.parametrize("name", sorted(MODEL_KW))
def test_straggler_models_bitwise(name):
    ref = ref_straggler.make_straggler_model(name, **MODEL_KW[name])
    got = pt_straggler.make_straggler_model(name, **MODEL_KW[name])
    for step in range(5):
        np.testing.assert_array_equal(got.sample(step, 23),
                                      ref.sample(step, 23))
        np.testing.assert_array_equal(got.latencies(step, 23),
                                      ref.latencies(step, 23))


def test_decoding_oracles_bitwise():
    rng = np.random.default_rng(0)
    G = (rng.random((20, 20)) < 0.2).astype(float)
    masks = rng.random((6, 20)) < 0.7
    masks[0] = False
    rhos = ref_decoding._default_rhos(20, masks.sum(1), 4)
    np.testing.assert_array_equal(
        pt_decoding._default_rhos(20, masks.sum(1), 4), rhos)
    np.testing.assert_array_equal(pt_decoding.err1_batch(G, masks, rhos),
                                  ref_decoding.err1_batch(G, masks, rhos))
    W = rhos[:, None] * masks
    np.testing.assert_array_equal(pt_decoding.err_batch(G, W),
                                  ref_decoding.err_batch(G, W))
    np.testing.assert_array_equal(pt_decoding.exact_decode_renorm(G, W),
                                  ref_decoding.exact_decode_renorm(G, W))


def test_theory_and_assignment_match():
    assert pt_theory.thm5_expected_err1_frc(100, 5, 0.2) == \
        ref_theory.thm5_expected_err1_frc(100, 5, 0.2)
    assert pt_theory.fundamental_err_lower_bound(64, 4, 48) == \
        ref_theory.fundamental_err_lower_bound(64, 4, 48)
    code = ref_registry.make("bgc", k=12, n=12, s=3, seed=4)
    a = ref_assignment.build_assignment(code)
    b = pt_assignment.build_assignment(port_code(code))
    for field in ("task_ids", "coeffs"):
        np.testing.assert_array_equal(getattr(b, field), getattr(a, field))
