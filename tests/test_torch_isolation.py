"""The port stands alone: it imports neither JAX nor the JAX package, and
no entry point moves to the CPU by itself.

A subprocess imports ``repro_torch``, runs a small main-path pass on the
CPU (Monte-Carlo cell, ClusterSim run and the decoded-gradient path) and
then finds neither ``jax`` nor ``repro`` in ``sys.modules``; a static
scan finds no import of either in the package or in ``chip_smoke.py``.
"""

import ast
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest
import torch

from repro_torch.core import registry
from repro_torch.core.engine import DecodeEngine
from repro_torch.core.simulate import monte_carlo_error
from repro_torch.sim.cluster import ClusterSim
from repro_torch.sim.traces import make_trace

REPO = Path(__file__).resolve().parent.parent
PORT_FILES = sorted((REPO / "src" / "repro_torch").rglob("*.py")) \
    + [REPO / "chip_smoke.py"]
FORBIDDEN = ("jax", "jaxlib", "repro")


def _imported_roots(path: Path):
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=[str(p.relative_to(REPO)) for p in PORT_FILES])
def test_no_jax_or_reference_import(path):
    bad = sorted(set(_imported_roots(path)) & set(FORBIDDEN))
    assert not bad, f"{path.relative_to(REPO)} imports {bad}"


def test_main_path_leaves_jax_unloaded():
    code = textwrap.dedent("""
        import sys
        import repro_torch
        from repro_torch.core.simulate import monte_carlo_error
        from repro_torch.sim.cluster import ClusterSim
        from repro_torch.sim.traces import make_trace

        monte_carlo_error("bgc", k=24, n=24, s=3, delta=0.2, trials=32,
                          device="cpu")
        sim = ClusterSim("frc", make_trace("pareto", steps=8, n=8, seed=3),
                         "deadline", s=2, device="cpu")
        sim.run()
        sim.run_distributed(fused=True)
        sim.run_distributed(fused=False)
        bad = sorted(m for m in sys.modules
                     if m.split(".")[0] in ("jax", "jaxlib", "repro"))
        print("LOADED", bad)
        sys.exit(1 if bad else 0)
    """)
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr


@pytest.mark.parametrize("entry", [
    lambda: monte_carlo_error("bgc", k=12, n=12, s=3, delta=0.2, trials=4),
    lambda: ClusterSim("bgc", make_trace("pareto", steps=4, n=12, seed=0),
                       s=3),
    lambda: DecodeEngine(registry.make("bgc", k=12, n=12, s=3, seed=0)),
])
def test_entry_points_default_to_the_card(entry, monkeypatch):
    """Without a card the default entry points raise; none picks the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        entry()


def test_platform_device_rules(monkeypatch):
    from repro_torch import platform

    assert platform.device("cpu") == torch.device("cpu")
    assert platform.backend_key("cpu") == "cpu"
    with pytest.raises(ValueError, match="unsupported"):
        platform.device("meta")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for req in (None, "cuda", "cuda:0"):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            platform.device(req)
