"""The port's four kernels on the CPU: each plain PyTorch version against
the JAX package's Pallas kernel in interpret mode, the dispatch rules of
``kernels.ops``, the checks of the CUDA wrappers, and the build helper.

The CUDA kernels themselves run only on the card: ``chip_smoke.py`` and
``tests/test_torch_cuda.py`` (which also holds the shared ragged cases)
hold them against these plain versions there.  Tolerances are the JAX package's own: 1e-5 for the one-step
decodes, 1e-4 for the weighted accumulates.
"""

from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from numpy.testing import assert_allclose

from repro.kernels import ops as ref_ops

from repro_torch.kernels import batched_decode as bd
from repro_torch.kernels import coded_accumulate as acc
from repro_torch.kernels import cuda
from repro_torch.kernels import fused_decode_apply as fused
from repro_torch.kernels import ops, ref
from test_torch_cuda import ACC_SHAPES, DECODE_SHAPES, _decode_case, _ell

CSRC = Path(__file__).resolve().parent.parent / "src" / "repro_torch" / "csrc"

def _t(*xs):
    return [torch.from_numpy(np.ascontiguousarray(x)) for x in xs]


@pytest.mark.parametrize("B,k,n,p", DECODE_SHAPES)
def test_dense_onestep_plain_matches_pallas(B, k, n, p):
    G, masks, rhos = _decode_case(B, k, n, p)
    want = np.asarray(ref_ops.batched_onestep_decode(
        jnp.asarray(G), jnp.asarray(masks), jnp.asarray(rhos),
        impl="pallas_interpret"))
    got = ops.batched_onestep_decode(*_t(G, masks, rhos))
    assert got.dtype == torch.float32 and tuple(got.shape) == (B, k)
    assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    if B > 1:
        assert np.all(got[-1].numpy() == 0)      # all-straggler row: exact 0


@pytest.mark.parametrize("B,k,n,p", DECODE_SHAPES)
def test_ell_onestep_plain_matches_pallas(B, k, n, p):
    G, masks, rhos = _decode_case(B, k, n, p)
    idx, val = _ell(G)
    want = np.asarray(ref_ops.batched_onestep_decode_ell(
        jnp.asarray(idx), jnp.asarray(val), jnp.asarray(masks),
        jnp.asarray(rhos), impl="pallas_interpret"))
    got = ops.batched_onestep_decode_ell(*_t(idx, val, masks, rhos))
    assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    # the ELL gather and the dense product are the same function
    dense = ops.batched_onestep_decode(*_t(G, masks, rhos))
    assert_allclose(got.numpy(), dense.numpy(), rtol=1e-6, atol=1e-6)


def test_ell_padding_adds_exactly_zero():
    G = np.zeros((3, 6), np.float32)
    G[0, [1, 4]] = 1.0
    G[2, 5] = 2.0
    idx, val = _ell(G)                   # rows 1 and 2 are padded
    masks = np.ones((2, 6), bool)
    masks[1, 0] = False                  # padding points at column 0
    got = ops.batched_onestep_decode_ell(
        *_t(idx, val, masks, np.ones(2, np.float32)))
    np.testing.assert_array_equal(got.numpy(), [[2, 0, 2], [2, 0, 2]])


@pytest.mark.parametrize("L,P,B", ACC_SHAPES)
def test_accumulate_plain_matches_pallas(L, P, B):
    rng = np.random.default_rng(L * 100 + P)
    g = rng.normal(size=(L, P)).astype(np.float32)
    w = rng.normal(size=(B, L)).astype(np.float32)
    want = np.asarray(ref_ops.coded_accumulate_batched(
        jnp.asarray(g), jnp.asarray(w), impl="pallas_interpret"))
    got = ops.coded_accumulate_batched(*_t(g, w))
    assert got.dtype == torch.float32
    assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("L,P,B", ACC_SHAPES)
def test_fused_plain_matches_pallas_and_accumulate(L, P, B):
    rng = np.random.default_rng(L * 100 + P)
    msgs = rng.normal(size=(L, P)).astype(np.float32)
    masks = rng.random((B, L)) < 0.7
    masks[0] = True
    if B > 1:
        masks[-1] = False
    scales = rng.normal(size=B).astype(np.float32)
    want = np.asarray(ref_ops.fused_decode_apply(
        jnp.asarray(msgs), jnp.asarray(masks), jnp.asarray(scales),
        impl="pallas_interpret"))
    got = ops.fused_decode_apply(*_t(msgs, masks, scales))
    assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)
    W = (scales[:, None] * masks).astype(np.float32)
    comp = ops.coded_accumulate_batched(*_t(msgs, W))
    assert_allclose(got.numpy(), comp.numpy(), rtol=1e-5, atol=1e-5)
    if B > 1:
        assert np.all(got[-1].numpy() == 0)


def test_plain_aggregations_follow_fp64():
    rng = np.random.default_rng(3)
    g = rng.normal(size=(5, 7))
    w = rng.normal(size=(3, 5))
    out = ref.coded_accumulate_batched_ref(*_t(g, w))
    assert out.dtype == torch.float64
    assert_allclose(out.numpy(), w @ g, rtol=1e-12)
    m = rng.random((3, 5)) < 0.5
    out = ref.fused_decode_apply_ref(*_t(g, m, w[:, 0]))
    assert out.dtype == torch.float64
    assert_allclose(out.numpy(), (w[:, :1] * m) @ g, rtol=1e-12)


def test_ops_rejects_mixed_and_unknown_devices():
    G = torch.ones(3, 4)
    with pytest.raises(ValueError, match="no kernel"):
        ops.batched_onestep_decode(G.to("meta"), torch.ones(2, 4, dtype=bool,
                                                            device="meta"),
                                   torch.ones(2, device="meta"))
    with pytest.raises(ValueError, match="span devices"):
        ops.coded_accumulate_batched(G, torch.ones(2, 3, device="meta"))


@pytest.mark.parametrize("call", [
    lambda: bd.batched_onestep_decode(torch.ones(3, 4),
                                      torch.ones(2, 4, dtype=torch.bool),
                                      torch.ones(2)),
    lambda: bd.batched_onestep_decode_ell(
        torch.zeros(3, 2, dtype=torch.int32), torch.ones(3, 2),
        torch.ones(2, 4, dtype=torch.bool), torch.ones(2)),
    lambda: acc.coded_accumulate_batched(torch.ones(3, 4), torch.ones(2, 3)),
    lambda: fused.fused_decode_apply(torch.ones(3, 4),
                                     torch.ones(2, 3, dtype=torch.bool),
                                     torch.ones(2)),
])
def test_cuda_wrappers_refuse_cpu_tensors(call):
    """A CUDA wrapper never computes a CPU tensor (no silent plain path)."""
    before = ops.launch_counts()
    with pytest.raises(ValueError, match="CUDA kernel"):
        call()
    assert ops.launch_counts() == before


@pytest.mark.parametrize("x,dtype,shape,msg", [
    (torch.ones(2, 3), torch.float64, (2, 3), "must be torch.float64"),
    (torch.ones(2, 3), torch.float32, (3, 2), "shape"),
    (torch.ones(3, 2).T, torch.float32, (2, 3), "contiguous"),
    (np.ones((2, 3)), torch.float32, (2, 3), "torch.Tensor"),
])
def test_wrapper_checks(x, dtype, shape, msg):
    with pytest.raises((TypeError, ValueError), match=msg):
        cuda.check(x, "x", dtype, shape, torch.device("cpu"))


def test_wrapper_checks_masks_dtype():
    """The mask kernels read bytes: float masks are refused, not cast."""
    with pytest.raises(TypeError, match="torch.bool"):
        bd.batched_onestep_decode(torch.ones(3, 4), torch.ones(2, 4),
                                  torch.ones(2))


def test_launch_counts_cover_the_four_kernels():
    assert set(ops.launch_counts()) == {
        "batched_onestep_decode", "batched_onestep_decode_ell",
        "coded_accumulate_batched", "fused_decode_apply"}
    ops.KERNELS["fused_decode_apply"].launches += 2
    ops.reset_launch_counts()
    assert set(ops.launch_counts().values()) == {0}


def test_library_names_follow_sources(tmp_path, monkeypatch):
    """An edited source gets a new library name, so it is rebuilt."""
    for name in cuda.SOURCES:
        (tmp_path / f"{name}.cu").write_text("// v1\n")
    (tmp_path / "accumulate.cuh").write_text("// h1\n")
    monkeypatch.setattr(cuda, "CSRC", tmp_path)
    first = {n: cuda.library_path(n) for n in cuda.SOURCES}
    assert first == {n: cuda.library_path(n) for n in cuda.SOURCES}
    (tmp_path / "batched_decode.cu").write_text("// v2\n")
    assert cuda.library_path("batched_decode") != first["batched_decode"]
    assert cuda.library_path("coded_accumulate") == first["coded_accumulate"]
    (tmp_path / "accumulate.cuh").write_text("// h2\n")
    assert cuda.library_path("coded_accumulate") != first["coded_accumulate"]
    assert cuda.BUILD_DIR.parts[-2:] == ("build", "repro_torch")
    with pytest.raises(ValueError, match="unknown kernel source"):
        cuda.library_path("flash_attention")


def test_sources_exist_and_carry_their_notes():
    """Every source says which Pallas kernel it replaces, what bounds it
    on the H100, and what its design does about that."""
    for name in cuda.SOURCES:
        text = (CSRC / f"{name}.cu").read_text()
        assert "Replaces repro/kernels/" in text or \
            "replaces repro/kernels/" in text
        assert 'extern "C"' in text
    notes = (CSRC / "batched_decode.cu").read_text() + \
        (CSRC / "accumulate.cuh").read_text()
    assert notes.count("What bounds") >= 2 and notes.count("Design:") >= 2


def test_launchers_match_their_c_signatures():
    """Each launcher's argument spec matches its extern "C" declaration:
    pointers as c_void_p, sizes as 64-bit, the stream last."""
    for k in ops.KERNELS.values():
        text = (CSRC / f"{k.source}.cu").read_text()
        decl = text[text.index(f"int {k.symbol}("):]
        params = decl[decl.index("(") + 1:decl.index(")")].split(",")
        spec = "".join("p" if "void*" in p else "i" for p in params[:-1])
        assert "void* stream" in params[-1]
        assert all(("int64_t" in p) for p, c in zip(params, spec) if c == "i")
        assert spec == k.signature, k.symbol

