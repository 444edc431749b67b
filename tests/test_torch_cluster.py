"""The port's ClusterSim and coded all-reduce against the JAX package's.

``ClusterSim.run`` decodes a whole trace in one batched call; the port
replays the reference's trace (``port_trace``) on the same code
(``port_code``) and must report the same masks, step times and errors.
``run_distributed`` decodes the workers' messages through
``dist.coded_allreduce`` on one rank and must match the reference's
one-device shard_map path, fused and not.  A two-process gloo world must
give the one-process result to 1e-6.
"""

import json
import os
import socket
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch
from numpy.testing import assert_allclose

from repro.core import registry as ref_registry
from repro.dist.coded_allreduce import partition_workers as ref_partition
from repro.sim.cluster import ClusterSim as RefSim
from repro.sim.traces import make_trace as ref_make_trace

from repro_torch.core.engine import DecodeEngine
from repro_torch.dist.coded_allreduce import CodedAllReduce, partition_workers
from repro_torch.sim.cluster import ClusterSim, make_policy
from test_torch_bridge import port_code, port_trace

REPO = Path(__file__).resolve().parent.parent
CPU = "cpu"


def _cell(scheme="bgc", n=16, s=4, steps=30, seed=3):
    code = ref_registry.make(scheme, k=n, n=n, s=s, seed=0)
    trace = ref_make_trace("pareto", steps=steps, n=n, seed=seed)
    return code, trace


@pytest.mark.parametrize("policy", ["sync", "deadline", "backup", "adaptive"])
@pytest.mark.parametrize("staleness", [0, 1])
def test_run_matches_reference(policy, staleness):
    code, trace = _cell()
    want = RefSim(code, trace, policy, backend="pallas_interpret",
                  staleness=staleness, decode_cost=0.3).run()
    sim = ClusterSim(port_code(code), port_trace(trace), policy, device=CPU,
                     staleness=staleness, decode_cost=0.3)
    got = sim.run()
    np.testing.assert_array_equal(got.masks, want.masks)
    np.testing.assert_array_equal(got.step_times, want.step_times)
    assert_allclose(got.errors, want.errors, rtol=1e-5, atol=1e-7)
    assert got.summary().keys() == want.summary().keys()
    assert sim.engine.batch_calls == 1          # one batched decode per run


def test_run_by_scheme_name_matches_reference():
    trace = ref_make_trace("pareto", steps=25, n=20, seed=4)
    want = RefSim("frc", trace, "deadline", s=4, backend="numpy").run()
    got = ClusterSim("frc", port_trace(trace), "deadline", s=4,
                     device=CPU).run()
    assert got.scheme == want.scheme
    assert_allclose(got.errors, want.errors, rtol=1e-5, atol=1e-7)
    with pytest.raises(ValueError, match="explicit s"):
        ClusterSim("frc", port_trace(trace), device=CPU)


def test_make_policy_names():
    for name in ("sync", "deadline", "backup", "adaptive"):
        assert make_policy(name).name == name
    with pytest.raises(ValueError):
        make_policy("nope")


@pytest.mark.parametrize("fused", [False, True])
def test_run_distributed_basis_matches_reference(fused):
    code, trace = _cell()
    want = RefSim(code, trace, "deadline").run_distributed(
        impl="pallas_interpret", fused=fused)
    sim = ClusterSim(port_code(code), port_trace(trace), "deadline",
                     device=CPU)
    got = sim.run_distributed(fused=fused)
    decoded = got.extras["decoded"]
    assert isinstance(decoded, torch.Tensor)
    assert decoded.dtype == torch.float32 and decoded.device.type == "cpu"
    assert_allclose(decoded.numpy(), want.extras["decoded"], rtol=1e-5,
                    atol=1e-6)
    assert_allclose(got.errors, want.errors, rtol=1e-4, atol=1e-6)
    # the reference engine here is its fp64 numpy one; the port's decodes
    # through the fp32 one-step kernel (fused: fp64 scales on the host)
    assert_allclose(got.extras["analytic_errors"],
                    want.extras["analytic_errors"], rtol=1e-5)
    # the reference's invariant: measured errors == analytic errors
    assert_allclose(got.errors, got.extras["analytic_errors"], rtol=1e-4,
                    atol=1e-6)
    assert got.extras["n_devices"] == 1
    assert sim.engine.batch_calls == (0 if fused else 1)


@pytest.mark.parametrize("fused", [False, True])
def test_run_distributed_task_grads_match_reference(fused):
    code, trace = _cell(scheme="frc", n=8, s=2, steps=12)
    grads = np.random.default_rng(6).normal(size=(8, 37))
    want = RefSim(code, trace, "deadline").run_distributed(
        task_grads=grads, impl="pallas_interpret", fused=fused)
    sim = ClusterSim(port_code(code), port_trace(trace), "deadline",
                     device=CPU)
    got64 = sim.run_distributed(task_grads=grads, fused=fused)
    assert got64.extras["decoded"].dtype == torch.float64   # fp64 path
    got32 = sim.run_distributed(task_grads=torch.from_numpy(grads).float(),
                                fused=fused)
    for got in (got64, got32):
        assert_allclose(got.extras["decoded"].double().numpy(),
                        want.extras["decoded"], rtol=1e-5, atol=1e-5)
        assert_allclose(got.errors, want.errors, rtol=1e-4, atol=1e-5)


def test_run_distributed_needs_a_device():
    code, trace = _cell()
    sim = ClusterSim(port_code(code), port_trace(trace), backend="numpy")
    with pytest.raises(ValueError, match="needs a device"):
        sim.run_distributed()
    res = sim.run_distributed(task_grads=torch.eye(16))     # its device
    assert_allclose(res.errors, res.extras["analytic_errors"], rtol=1e-4,
                    atol=1e-6)
    with pytest.raises(ValueError, match="one-step"):
        ClusterSim(port_code(code), port_trace(trace), decoder="optimal",
                   backend="numpy", device=CPU).run_distributed(fused=True)


@pytest.mark.parametrize("n,D", [(8, 1), (9, 2), (7, 3), (2, 4), (16, 8)])
def test_partition_matches_reference(n, D):
    got, want = partition_workers(n, D), ref_partition(n, D)
    np.testing.assert_array_equal(got.worker_ids, want.worker_ids)
    assert got.lanes == want.lanes
    x = np.arange(n * 3.0).reshape(n, 3)
    np.testing.assert_array_equal(got.scatter(x), want.scatter(x))
    np.testing.assert_array_equal(got.gather(got.scatter(x, fill=-1)), x)
    for d in range(D):   # the rank-local slice is the device's real lanes
        ids = got.worker_ids[d]
        np.testing.assert_array_equal(
            np.arange(n)[got.local_slice(d)], ids[ids >= 0])


@pytest.mark.parametrize("renorm", [False, True])
def test_aggregate_fused_equals_weights_then_reduce(renorm):
    code = port_code(ref_registry.make("bgc", k=12, n=12, s=4, seed=9))
    eng = DecodeEngine(code, device=CPU)
    ar = CodedAllReduce(code, engine=eng)
    masks = np.random.default_rng(9).random((5, 12)) < 0.75
    masks[0], masks[1] = True, False
    msgs = torch.from_numpy(np.random.default_rng(1).normal(size=(12, 24)))
    W = ar.weights_for_masks(masks, "onestep", renorm=renorm)
    for m in (msgs, msgs.float()):
        want = ar.aggregate_messages_batch(m, W)
        got = ar.aggregate_messages_fused(m, masks, renorm=renorm)
        assert got.dtype == m.dtype
        assert_allclose(got.double().numpy(), want.double().numpy(),
                        rtol=1e-5, atol=1e-6)
        assert torch.all(got[1] == 0)
        assert_allclose(want.double().numpy(), W @ msgs.numpy(), rtol=1e-5,
                        atol=1e-5)
    single = ar.aggregate_messages(msgs, W[2])
    assert_allclose(single.numpy(), W[2] @ msgs.numpy(), rtol=1e-12)
    assert eng.batch_calls == 1 and eng.fused_calls == 2
    np.testing.assert_array_equal(ar.device_weights(W[2]), W[2][None])


_WORLD = textwrap.dedent("""
    import json, sys
    import numpy as np
    import torch
    import torch.distributed as dist
    from repro_torch.core import registry
    from repro_torch.sim.cluster import ClusterSim
    from repro_torch.sim.traces import make_trace

    rank, world, port, out = (int(sys.argv[1]), int(sys.argv[2]),
                              sys.argv[3], sys.argv[4])
    if world > 1:
        dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                                world_size=world, rank=rank)
    code = registry.make("bgc", k=9, n=9, s=3, seed=0)
    trace = make_trace("pareto", steps=10, n=9, seed=3)
    grads = torch.from_numpy(np.random.default_rng(2).normal(size=(9, 33)))
    res = {}
    for fused in (False, True):
        for g in (None, grads):
            r = ClusterSim(code, trace, "deadline", device="cpu") \\
                .run_distributed(task_grads=g, fused=fused)
            res[f"{fused}-{g is None}"] = dict(
                decoded=r.extras["decoded"].double().tolist(),
                errors=r.errors.tolist(), n_devices=r.extras["n_devices"])
    if rank == 0:
        with open(out, "w") as f:
            json.dump(res, f)
    if world > 1:
        dist.destroy_process_group()
""")


def _free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _run_world(world, tmp_path):
    out = tmp_path / f"world{world}.json"
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    port = str(_free_port())
    procs = [subprocess.Popen([sys.executable, "-c", _WORLD, str(r),
                               str(world), port, str(out)], env=env)
             for r in range(world)]
    for p in procs:
        try:
            assert p.wait(timeout=120) == 0
        finally:
            p.kill()
    return json.loads(out.read_text())


def test_gloo_world_matches_one_process(tmp_path):
    """Two ranks on gloo (n = 9 over 2 ranks: 5 + 4 lanes, one padding
    lane) decode exactly what one process decodes."""
    one, two = _run_world(1, tmp_path), _run_world(2, tmp_path)
    assert one.keys() == two.keys()
    for key in one:
        assert one[key]["n_devices"] == 1 and two[key]["n_devices"] == 2
        assert_allclose(two[key]["decoded"], one[key]["decoded"], rtol=1e-6,
                        atol=1e-6)
        assert_allclose(two[key]["errors"], one[key]["errors"], rtol=1e-6,
                        atol=1e-6)
