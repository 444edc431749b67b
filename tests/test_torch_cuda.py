"""The port's CUDA kernels and entry points on the card.

Marked ``cuda``: each test asks the ``card`` fixture for the GPU and
skips where there is none (the CPU test runs); on a machine with a card
run them with

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Each kernel is held against its plain version on the card at the ragged
shapes below, which ``test_torch_kernels`` also uses on the CPU against
the JAX package (tolerance 1e-5 for the one-step
decodes, 1e-4 for the accumulates), and the engine and ClusterSim on the
card against the same calls on the CPU.
"""

import numpy as np
import pytest
import torch
from numpy.testing import assert_allclose

from repro_torch.core import registry
from repro_torch.core.engine import DecodeEngine
from repro_torch.kernels import batched_decode as bd
from repro_torch.kernels import coded_accumulate as acc
from repro_torch.kernels import fused_decode_apply as fused
from repro_torch.kernels import ops, ref
from repro_torch.sim.cluster import ClusterSim
from repro_torch.sim.traces import make_trace

pytestmark = pytest.mark.cuda

# (B, k, n, density): ragged n, B = 1, k != n, a one-worker code
DECODE_SHAPES = [(1, 37, 53, 0.3), (7, 64, 45, 0.2), (16, 24, 24, 0.15),
                 (5, 5, 1, 0.5)]
# (L, P, B): the JAX package's own ragged cells plus P not a multiple of 4
ACC_SHAPES = [(8, 64, 4), (13, 37, 9), (1, 9, 1), (6, 130, 32)]


def _decode_case(B, k, n, p, seed=0):
    rng = np.random.default_rng(seed + 31 * k + n)
    G = (rng.random((k, n)) < p).astype(np.float32)
    G[0, 0] = 1.0
    masks = rng.random((B, n)) < 0.7
    masks[0] = True                       # no stragglers
    if B > 1:
        masks[-1] = False                 # all stragglers
    rhos = (rng.random(B) + 0.5).astype(np.float32)
    return G, masks, rhos


def _ell(G):
    nz = G != 0
    rmax = max(int(nz.sum(1).max()), 1)
    idx = np.zeros((G.shape[0], rmax), np.int32)
    val = np.zeros((G.shape[0], rmax), np.float32)
    for i in range(G.shape[0]):
        cols = np.flatnonzero(nz[i])
        idx[i, :cols.size], val[i, :cols.size] = cols, G[i, cols]
    return idx, val


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def _on(dev, *xs):
    return [torch.from_numpy(np.ascontiguousarray(x)).to(dev) for x in xs]


@pytest.mark.parametrize("B,k,n,p", DECODE_SHAPES)
def test_onestep_kernels_match_plain(card, B, k, n, p):
    G, masks, rhos = _decode_case(B, k, n, p)
    idx, val = _ell(G)
    tG, tm, tr, ti, tv = _on(card, G, masks, rhos, idx, val)
    want = ref.batched_onestep_decode_ref(tG, tm, tr).cpu().numpy()
    n_dense = bd.DENSE.launches
    got = bd.batched_onestep_decode(tG, tm, tr)
    assert bd.DENSE.launches == n_dense + 1
    assert_allclose(got.cpu().numpy(), want, rtol=1e-5, atol=1e-5)
    got = bd.batched_onestep_decode_ell(ti, tv, tm, tr)
    assert_allclose(got.cpu().numpy(), want, rtol=1e-5, atol=1e-5)
    if B > 1:
        assert torch.all(got[-1] == 0)


@pytest.mark.parametrize("L,P,B", ACC_SHAPES + [(300, 1027, 17)])
@pytest.mark.parametrize("offset", [0, 1])
def test_accumulate_kernels_match_plain(card, L, P, B, offset):
    rng = np.random.default_rng(L + P)
    msgs = rng.normal(size=(L, P)).astype(np.float32)
    W = rng.normal(size=(B, L)).astype(np.float32)
    masks = rng.random((B, L)) < 0.7
    scales = (rng.random(B) + 0.5).astype(np.float32)
    tm, tW, tk, ts = _on(card, msgs, W, masks, scales)
    if offset:      # the same messages 4 bytes past a 16-byte boundary
        buf = torch.empty(L * P + offset, device=card)
        tm = buf[offset:].view(L, P)
        tm.copy_(torch.from_numpy(msgs))
    assert_allclose(acc.coded_accumulate_batched(tm, tW).cpu().numpy(),
                    W @ msgs, rtol=1e-4, atol=1e-4)
    want = ref.fused_decode_apply_ref(tm, tk, ts).cpu().numpy()
    assert_allclose(fused.fused_decode_apply(tm, tk, ts).cpu().numpy(), want,
                    rtol=1e-4, atol=1e-4)


def test_wrappers_refuse_what_the_kernels_do_not_take(card):
    x = torch.ones(4, 6, device=card)
    with pytest.raises(TypeError, match="float32"):
        acc.coded_accumulate_batched(x.double(), torch.ones(2, 4,
                                                            device=card))
    with pytest.raises(ValueError, match="contiguous"):
        acc.coded_accumulate_batched(x.T.contiguous().T,
                                     torch.ones(2, 4, device=card))
    with pytest.raises(ValueError, match="span devices"):
        ops.coded_accumulate_batched(x, torch.ones(2, 4))


@pytest.mark.parametrize("name,s", [("bgc", 3), ("bgc", 12), ("frc", 4),
                                    ("expander", 4)])
def test_engine_on_the_card_matches_cpu(card, name, s):
    code = registry.make(name, k=36, n=36, s=s, seed=1)
    masks = np.random.default_rng(2).random((40, 36)) < 0.75
    masks[0], masks[1] = True, False
    got = DecodeEngine(code, device=card).decode_batch(masks)
    want = DecodeEngine(code, device="cpu").decode_batch(masks)
    assert_allclose(got.errors, want.errors, rtol=1e-5, atol=1e-6)
    msgs = np.random.default_rng(3).normal(size=(36, 50))
    assert_allclose(DecodeEngine(code, device=card).decode_apply_batch(
        masks, msgs), DecodeEngine(code, device="cpu").decode_apply_batch(
        masks, msgs), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("fused_path", [False, True])
def test_run_distributed_on_the_card(card, fused_path):
    trace = make_trace("pareto", steps=20, n=24, seed=3)
    got = ClusterSim("bgc", trace, "deadline", s=4, device=card) \
        .run_distributed(fused=fused_path)
    want = ClusterSim("bgc", trace, "deadline", s=4, device="cpu") \
        .run_distributed(fused=fused_path)
    assert got.extras["decoded"].device.type == "cuda"
    assert_allclose(got.errors, want.errors, rtol=1e-4, atol=1e-6)
    assert_allclose(got.errors, got.extras["analytic_errors"], rtol=1e-4,
                    atol=1e-6)
