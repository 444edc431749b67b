"""The port's DecodeEngine on the CPU against the JAX package's engine.

``DecodeEngine(backend="torch", device="cpu")`` runs the plain versions
of the port's one-step kernels; it is held against the reference's
``"pallas_interpret"`` backend (the Pallas kernels in interpret mode) and
its fp64 ``"numpy"`` backend, for every registry family, on the same G
(carried across with ``port_code``).  Both engines must take the same
branch (dense or row-ELL).  The port's ``numpy`` backend must equal the
reference's for the optimal and algorithmic decoders.
"""

import numpy as np
import pytest
import torch
from numpy.testing import assert_allclose

from repro.core import registry as ref_registry
from repro.core.engine import DecodeEngine as RefEngine

from repro_torch.core.engine import DecodeEngine
from test_torch_bridge import FAMILIES, family_s, port_code

CPU = "cpu"


def _code(name, k=30, s=3, seed=0):
    return ref_registry.make(name, k=k, n=k, s=family_s(name, k, s),
                             seed=seed)


def _masks(n, B=9, seed=1, frac=0.75):
    m = np.random.default_rng(seed).random((B, n)) < frac
    m[0] = True                                # no stragglers
    m[1] = False                               # all stragglers
    return m


@pytest.mark.parametrize("name", FAMILIES)
@pytest.mark.parametrize("decoder", ["onestep", "ignore"])
def test_decode_batch_matches_reference(name, decoder):
    ref_code = _code(name)
    masks = _masks(ref_code.n)
    got = DecodeEngine(port_code(ref_code), device=CPU).decode_batch(
        masks, decoder)
    for backend in ("pallas_interpret", "numpy"):
        want = RefEngine(ref_code, backend=backend).decode_batch(masks,
                                                                 decoder)
        assert_allclose(got.weights, want.weights, rtol=1e-12, atol=0)
        assert_allclose(got.errors, want.errors, rtol=1e-5, atol=1e-5)
    assert got.weights.dtype == np.float64 and got.errors.dtype == np.float64


@pytest.mark.parametrize("name,s,sparse,ell", [
    ("bgc", 3, "auto", True),        # 4 * rmax <= n
    ("bgc", 12, "auto", False),      # dense
    ("frc", 3, "never", False),
    ("expander", 12, "always", True),
])
def test_dense_and_ell_branches_match_reference(name, s, sparse, ell):
    ref_code = _code(name, s=s)
    masks = _masks(ref_code.n, B=6)
    ref_eng = RefEngine(ref_code, backend="pallas_interpret", sparse=sparse)
    eng = DecodeEngine(port_code(ref_code), device=CPU, sparse=sparse)
    assert eng._use_ell() == ref_eng._use_ell() == ell
    assert_allclose(eng.errors_batch(masks), ref_eng.errors_batch(masks),
                    rtol=1e-5, atol=1e-5)


def test_errors_are_fp64_on_the_host():
    """V comes back from the kernel in fp32; the error reduction is fp64,
    so an exact decode reports an error below 1e-9 (the Monte-Carlo
    zero-error threshold), as the reference's does."""
    code = _code("frc", k=24, s=4)
    masks = np.ones((3, 24), bool)
    errs = DecodeEngine(port_code(code), device=CPU).errors_batch(masks)
    assert errs.dtype == np.float64 and np.all(errs < 1e-9)


def test_decode_lru_matches_reference():
    ref_code = _code("bgc")
    masks = _masks(ref_code.n, B=4)
    eng = DecodeEngine(port_code(ref_code), device=CPU)
    ref_eng = RefEngine(ref_code, backend="pallas_interpret")
    for m in list(masks) + [masks[2]]:
        w = eng.decode(m)
        assert_allclose(w, ref_eng.decode(m), rtol=1e-12)
        assert not w.flags.writeable
    assert eng.cache_info() == {"hits": 1, "misses": 4, "size": 4,
                                "maxsize": 512}
    assert eng.batch_calls == 4
    eng.clear_cache()
    assert eng.cache_info()["size"] == 0


@pytest.mark.parametrize("renorm", [False, True])
def test_onestep_scales_match_reference(renorm):
    ref_code = _code("sbm", k=32, s=4)
    masks = _masks(ref_code.n)
    eng = DecodeEngine(port_code(ref_code), device=CPU)
    got = eng.onestep_scales(masks, renorm=renorm)
    want = RefEngine(ref_code).onestep_scales(masks, renorm=renorm)
    assert_allclose(got, want, rtol=1e-12)
    assert eng.fused_calls == 1 and eng.batch_calls == 0


@pytest.mark.parametrize("renorm", [False, True])
def test_decode_apply_batch_matches_reference(renorm):
    ref_code = _code("bgc", k=21, s=4)
    masks = _masks(ref_code.n, B=5)
    msgs = np.random.default_rng(4).normal(size=(ref_code.n, 19))
    eng = DecodeEngine(port_code(ref_code), device=CPU)
    want = RefEngine(ref_code, backend="pallas_interpret").decode_apply_batch(
        masks, msgs, renorm=renorm)
    got = eng.decode_apply_batch(masks, msgs, renorm=renorm)
    assert isinstance(got, np.ndarray) and got.dtype == np.float64
    assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    assert np.all(got[1] == 0)                      # all-straggler row
    t = eng.decode_apply_batch(masks, torch.from_numpy(msgs), renorm=renorm)
    assert isinstance(t, torch.Tensor) and t.dtype == torch.float32
    assert_allclose(t.numpy(), want, rtol=1e-5, atol=1e-5)
    host = eng.decode_apply_batch(masks, msgs, renorm=renorm, impl="numpy")
    assert_allclose(host, RefEngine(ref_code).decode_apply_batch(
        masks, msgs, renorm=renorm), rtol=1e-12)
    assert eng.fused_calls == 3 and eng.batch_calls == 0


@pytest.mark.parametrize("name", ["frc", "bgc", "expander", "sbm"])
@pytest.mark.parametrize("decoder,kw", [("optimal", {"optimal_impl": "pinv"}),
                                        ("optimal", {"optimal_impl": "gram"}),
                                        ("algorithmic", {"iters": 5})])
def test_numpy_backend_matches_reference(name, decoder, kw):
    ref_code = _code(name, k=24, s=4)
    masks = _masks(ref_code.n)
    got = DecodeEngine(port_code(ref_code), backend="numpy",
                       **kw).decode_batch(masks, decoder)
    want = RefEngine(ref_code, backend="numpy", **kw).decode_batch(masks,
                                                                   decoder)
    assert_allclose(got.weights, want.weights, rtol=1e-12, atol=1e-12)
    assert_allclose(got.errors, want.errors, rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("decoder", ["optimal", "algorithmic"])
def test_torch_backend_defers_other_decoders(decoder):
    eng = DecodeEngine(port_code(_code("bgc")), device=CPU)
    with pytest.raises(NotImplementedError, match="later slice"):
        eng.decode_batch(_masks(30), decoder)


def test_constructor_rules(monkeypatch):
    code = port_code(_code("bgc"))
    with pytest.raises(ValueError, match="tiles"):
        DecodeEngine(code, device=CPU, tiles=object())
    with pytest.raises(ValueError, match="backend"):
        DecodeEngine(code, backend="pallas")
    # the default is the card: without one it raises, it never picks the CPU
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        DecodeEngine(code)
    assert DecodeEngine(code, backend="numpy").device is None
    assert DecodeEngine(code, device=CPU).device == torch.device("cpu")
