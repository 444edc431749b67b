#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (src/repro_torch) on one NVIDIA GPU.

Drives the port's main path -- code G -> straggler masks -> batched
one-step decode -> coded aggregation of the workers' gradient messages --
through its public entry points, on the card, at the sizes the repo's
users run, and holds every CUDA kernel against its plain PyTorch version:

  1. build the CUDA kernels from src/repro_torch/csrc (one nvcc per source,
     all started together);
  2. run each kernel against its plain version on the card at the
     main-path shapes (tolerance 1e-5 for the one-step decodes, 1e-4 for
     the aggregations; |kernel - plain| <= tol * (1 + |plain|)) and at
     ragged shapes (n not a multiple of 8, B = 1, k != n, all-straggler
     and no-straggler masks, unaligned messages);
  3. monte_carlo_error for bgc and frc at k = n = 256, s = 8 (the ELL
     kernel) and bgc at s = 80 (the dense kernel), delta = 0.2, 1000
     trials, each mean against the port's fp64 numpy backend at rtol 1e-5;
  4. ClusterSim.run of bgc over a 2000-step Pareto trace at n = 256;
  5. ClusterSim.run_distributed, fused and not, at n = 8, s = 2 (frc) over
     16 steps with fp32 task gradients [8, 61,051,392] (one minicpm-2b
     decoder layer) drawn on the card, the decoded [16, P] against an
     fp64 matmul of the weights and the messages at max-norm relative
     error 1e-4; then with basis task gradients at n = 256, whose measured
     errors must equal the engine's analytic errors;
  6. time every kernel (CUDA events over back-to-back calls, and the
     kernel's own device time from torch.profiler), its plain version and
     the one PyTorch library call that computes the same function, and
     print them with each kernel's launch count from phases 3-5 and its
     bound;
  7. trace three main-path cells with torch.profiler and print the
     device's busy share of their wall time.

The launch counters are set to 0 just before phase 3 and read just after
phase 5, so phase 2's and phase 6's launches do not count.

Prints a JSON line of kernel records, the card's name and power limit
(nvidia-smi), and as its last line
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
Exits non-zero, printing no result, if there is no CUDA device, if the
port is not beside this script, or if any phase fails.

    python3 chip_smoke.py
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
import traceback
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

# H100 SXM data-sheet peaks (dense): HBM3 bandwidth, fp32 CUDA-core rate
PEAK_BYTES_PER_S = 3.35e12
PEAK_FP32_FLOPS = 67e12

P_LAYER = 61_051_392     # 4*2304^2 + 3*2304*5760 + 2*2304: one minicpm-2b layer
SRC = "src/repro_torch/csrc/"
REF = "src/repro/kernels/"
KERNELS = {   # name -> (CUDA source, the Pallas kernel's pallas_call line)
    "batched_onestep_decode": (SRC + "batched_decode.cu",
                               REF + "batched_decode.py:96"),
    "batched_onestep_decode_ell": (SRC + "batched_decode.cu",
                                   REF + "batched_decode.py:156"),
    "coded_accumulate_batched": (SRC + "coded_accumulate.cu",
                                 REF + "coded_accumulate.py:125"),
    "fused_decode_apply": (SRC + "fused_decode_apply.cu",
                           REF + "fused_decode_apply.py:81"),
}
TOL = {"batched_onestep_decode": 1e-5, "batched_onestep_decode_ell": 1e-5,
       "coded_accumulate_batched": 1e-4, "fused_decode_apply": 1e-4}


class SmokeFailure(Exception):
    pass


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def log(msg: str) -> None:
    print(msg, flush=True)


def max_err(got, want, tol: float, what: str) -> float:
    """max |got - want|; fails unless |got - want| <= tol * (1 + |want|)."""
    import torch

    require(tuple(got.shape) == tuple(want.shape),
            f"{what}: shape {tuple(got.shape)} != {tuple(want.shape)}")
    require(bool(torch.isfinite(got).all()), f"{what}: non-finite output")
    err, ok = 0.0, True
    step = max(1, (1 << 26) // max(got[0].numel(), 1)) if got.numel() else 1
    for lo in range(0, got.shape[0], step):     # fp64 a few rows at a time
        g, w = got[lo:lo + step].double(), want[lo:lo + step].double()
        diff = (g - w).abs()
        ok = ok and bool((diff <= tol * (1.0 + w.abs())).all())
        err = max(err, float(diff.max()))
    require(ok, f"{what}: max |kernel - plain| = {err:.3e} over tol {tol}")
    return err


# --------------------------------------------------------------------------
# inputs at the main-path shapes
# --------------------------------------------------------------------------


def decode_inputs(dev, *, n: int, s: int, B: int, seed: int = 0):
    """A bgc code at k = n with its masks (delta = 0.2) and rhos, on dev."""
    import numpy as np
    import torch

    from repro_torch.core import registry
    from repro_torch.core.engine import DecodeEngine
    from repro_torch.core.simulate import sample_straggler_masks

    rng = np.random.default_rng(seed)
    code = registry.make("bgc", k=n, n=n, s=s, rng=rng)
    masks = sample_straggler_masks(n, int(round(0.2 * n)), B, rng)
    rhos = DecodeEngine(code, backend="numpy", s=s).rhos_for(masks)
    idx, val = code.ell()
    t = dict(G=torch.from_numpy(code.G.astype(np.float32)).to(dev),
             idx=torch.from_numpy(idx).to(dev),
             val=torch.from_numpy(val).to(dev),
             masks=torch.from_numpy(masks).to(dev),
             rhos=torch.from_numpy(rhos.astype(np.float32)).to(dev))
    return code, t


def aggregate_inputs(dev, *, L: int, P: int, B: int, seed: int = 0):
    import torch

    g = torch.Generator(device=dev).manual_seed(seed)
    return dict(
        msgs=torch.randn(L, P, generator=g, device=dev),
        W=torch.randn(B, L, generator=g, device=dev),
        masks=torch.rand(B, L, generator=g, device=dev) < 0.7,
        scales=torch.rand(B, generator=g, device=dev) + 0.5)


# --------------------------------------------------------------------------
# phases
# --------------------------------------------------------------------------


def phase_build() -> float:
    from repro_torch.kernels import cuda

    t0 = time.perf_counter()
    secs = cuda.build()
    total = time.perf_counter() - t0
    log(f"[1 build] {total:.2f} s wall for {len(secs)} sources in parallel: "
        + ", ".join(f"{k} {v:.2f} s" for k, v in secs.items()))
    for name in cuda.SOURCES:
        text = cuda.library_path(name).with_suffix(".log")
        if text.exists():
            for line in text.read_text().splitlines():
                if "registers" in line or "spill" in line:
                    log(f"    {name}: {line.strip()}")
    return total


def compare_kernels(dev, *, n: int, B_dec: int, L: int, P: int,
                    B_agg: int) -> dict:
    """Each kernel against its plain version at the main-path shapes, and
    at ragged shapes.  Returns the main-path max |kernel - plain|."""
    import torch

    from repro_torch.kernels import batched_decode as bd
    from repro_torch.kernels import coded_accumulate as acc
    from repro_torch.kernels import fused_decode_apply as fused
    from repro_torch.kernels import ref

    errs = {}
    _, sparse = decode_inputs(dev, n=n, s=8, B=B_dec)
    _, dense = decode_inputs(dev, n=n, s=80, B=B_dec)
    errs["batched_onestep_decode"] = max_err(
        bd.batched_onestep_decode(dense["G"], dense["masks"], dense["rhos"]),
        ref.batched_onestep_decode_ref(dense["G"], dense["masks"],
                                       dense["rhos"]),
        TOL["batched_onestep_decode"], "dense one-step")
    errs["batched_onestep_decode_ell"] = max_err(
        bd.batched_onestep_decode_ell(sparse["idx"], sparse["val"],
                                      sparse["masks"], sparse["rhos"]),
        ref.batched_onestep_decode_ell_ref(sparse["idx"], sparse["val"],
                                           sparse["masks"], sparse["rhos"]),
        TOL["batched_onestep_decode_ell"], "ELL one-step")
    a = aggregate_inputs(dev, L=L, P=P, B=B_agg)
    out = acc.coded_accumulate_batched(a["msgs"], a["W"])
    errs["coded_accumulate_batched"] = max_err(
        out, ref.coded_accumulate_batched_ref(a["msgs"], a["W"]),
        TOL["coded_accumulate_batched"], "coded accumulate")
    del out
    out = fused.fused_decode_apply(a["msgs"], a["masks"], a["scales"])
    errs["fused_decode_apply"] = max_err(
        out, ref.fused_decode_apply_ref(a["msgs"], a["masks"], a["scales"]),
        TOL["fused_decode_apply"], "fused decode-apply")
    sw = (a["scales"][:, None] * a["masks"].float()).contiguous()
    max_err(out, acc.coded_accumulate_batched(a["msgs"], sw),
            TOL["fused_decode_apply"], "fused == accumulate(s*m)")
    del out, a
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    log("[2 kernels] main-path max |kernel - plain|: "
        + ", ".join(f"{k} {v:.3e}" for k, v in errs.items()))
    ragged(dev)
    return errs


def ragged(dev) -> None:
    """Ragged edges the kernels mask themselves: n not a multiple of 8,
    B = 1, k != n, all- and no-straggler masks, P not a multiple of 4,
    a message block that is not 16-byte aligned, L past one staged chunk."""
    import numpy as np
    import torch

    from repro_torch.kernels import batched_decode as bd
    from repro_torch.kernels import coded_accumulate as acc
    from repro_torch.kernels import fused_decode_apply as fused
    from repro_torch.kernels import ref

    rng = np.random.default_rng(7)
    for B, k, n, p in [(1, 37, 53, 0.3), (7, 64, 45, 0.2), (33, 45, 130, 0.05),
                       (3, 5, 1, 0.5)]:
        G = (rng.random((k, n)) < p).astype(np.float32)
        G[0, 0] = 1.0
        masks = rng.random((B, n)) < 0.7
        masks[0] = True
        if B > 1:
            masks[-1] = False
        rhos = rng.random(B).astype(np.float32) + 0.5
        nz = G != 0
        rmax = max(int(nz.sum(1).max()), 1)
        idx = np.zeros((k, rmax), np.int32)
        val = np.zeros((k, rmax), np.float32)
        for i in range(k):
            cols = np.flatnonzero(nz[i])
            idx[i, :cols.size], val[i, :cols.size] = cols, G[i, cols]
        t = {x: torch.from_numpy(v).to(dev) for x, v in
             dict(G=G, m=masks, r=rhos, i=idx, v=val).items()}
        want = ref.batched_onestep_decode_ref(t["G"], t["m"], t["r"])
        max_err(bd.batched_onestep_decode(t["G"], t["m"], t["r"]), want,
                1e-5, f"dense one-step B={B} k={k} n={n}")
        max_err(bd.batched_onestep_decode_ell(t["i"], t["v"], t["m"], t["r"]),
                want, 1e-5, f"ELL one-step B={B} k={k} n={n}")
    for L, P, B, offset in [(8, 64, 4, 0), (13, 37, 9, 0), (1, 9, 1, 0),
                            (300, 1027, 17, 0), (8, 4096, 16, 1)]:
        a = aggregate_inputs(dev, L=L, P=P, B=B, seed=L + P)
        msgs = a["msgs"]
        if offset:       # same values at an address 4 bytes past alignment
            buf = torch.empty(L * P + offset, device=dev)
            msgs = buf[offset:].view(L, P)
            msgs.copy_(a["msgs"])
        a["masks"][0] = True
        a["masks"][-1] = False
        max_err(acc.coded_accumulate_batched(msgs, a["W"]),
                ref.coded_accumulate_batched_ref(a["msgs"], a["W"]),
                1e-4, f"coded accumulate L={L} P={P} B={B} offset={offset}")
        got = fused.fused_decode_apply(msgs, a["masks"], a["scales"])
        max_err(got, ref.fused_decode_apply_ref(a["msgs"], a["masks"],
                                                a["scales"]),
                1e-4, f"fused decode-apply L={L} P={P} B={B} offset={offset}")
        if B > 1:
            require(bool((got[-1] == 0).all()),
                    "fused decode-apply: all-straggler row is not exactly 0")
    log("[2 kernels] ragged shapes agree")


def phase_monte_carlo(dev, *, n: int, trials: int) -> None:
    from repro_torch.core.simulate import monte_carlo_error
    from repro_torch.kernels import ops

    for scheme, s, branch in [("bgc", 8, "batched_onestep_decode_ell"),
                              ("frc", 8, "batched_onestep_decode_ell"),
                              ("bgc", 80, "batched_onestep_decode")]:
        before = ops.launch_counts()[branch]
        t0 = time.perf_counter()
        got = monte_carlo_error(scheme, k=n, n=n, s=s, delta=0.2,
                                trials=trials, decoder="onestep", seed=0,
                                device=dev)
        secs = time.perf_counter() - t0
        want = monte_carlo_error(scheme, k=n, n=n, s=s, delta=0.2,
                                 trials=trials, decoder="onestep", seed=0,
                                 backend="numpy")
        require(ops.launch_counts()[branch] > before,
                f"monte_carlo {scheme} s={s} did not run {branch}")
        rel = abs(got.mean - want.mean) / abs(want.mean)
        require(rel <= 1e-5, f"monte_carlo {scheme} s={s}: mean {got.mean} "
                             f"vs numpy {want.mean} (rel {rel:.2e})")
        log(f"[3 monte_carlo] {scheme} k=n={n} s={s} delta=0.2 "
            f"trials={trials}: mean err/k {got.mean:.6f} (numpy "
            f"{want.mean:.6f}, rel {rel:.1e}), p_zero {got.p_zero}, "
            f"{secs:.3f} s on the card via {branch}")


def phase_cluster(dev, *, n: int, steps: int) -> None:
    import numpy as np

    from repro_torch.sim.cluster import ClusterSim
    from repro_torch.sim.traces import make_trace

    trace = make_trace("pareto", steps=steps, n=n, seed=3)
    t0 = time.perf_counter()
    res = ClusterSim("bgc", trace, "deadline", s=8, device=dev).run()
    secs = time.perf_counter() - t0
    want = ClusterSim("bgc", trace, "deadline", s=8, backend="numpy").run()
    require(res.errors.shape == (steps,) and np.isfinite(res.errors).all(),
            "ClusterSim.run: bad errors")
    require(np.allclose(res.errors, want.errors, rtol=1e-5, atol=1e-9),
            "ClusterSim.run: errors differ from the numpy backend")
    log(f"[4 cluster] bgc n={n} s=8 pareto x{steps} deadline: mean err/k "
        f"{res.mean_error:.6f} (numpy {want.mean_error:.6f}), mean "
        f"stragglers {res.mean_stragglers:.2f}, {secs:.3f} s")


def phase_distributed(dev, *, P: int, n_basis: int, steps_basis: int) -> None:
    import numpy as np
    import torch

    from repro_torch.sim.cluster import ClusterSim
    from repro_torch.sim.traces import make_trace

    trace = make_trace("pareto", steps=16, n=8, seed=3)
    g = torch.Generator(device=dev).manual_seed(0)
    task_grads = torch.randn(8, P, generator=g, device=dev)
    for fused in (True, False):
        sim = ClusterSim("frc", trace, "deadline", s=2, device=dev)
        t0 = time.perf_counter()
        res = sim.run_distributed(task_grads=task_grads, fused=fused)
        decoded = res.extras["decoded"]
        if dev.type == "cuda":
            torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        require(tuple(decoded.shape) == (16, P)
                and decoded.dtype == torch.float32
                and decoded.device == task_grads.device,
                f"run_distributed: decoded {tuple(decoded.shape)} "
                f"{decoded.dtype} on {decoded.device}")
        W = sim.engine.rhos_for(res.masks)[:, None] * res.masks    # [16, 8]
        G = torch.as_tensor(sim.code.G, dtype=torch.float32, device=dev)
        msgs64 = (G.T @ task_grads).double()
        W64 = torch.from_numpy(W).to(dev)
        worst = top = 0.0
        for b in range(W.shape[0]):
            want = W64[b] @ msgs64
            worst = max(worst, float((decoded[b].double() - want).abs().max()))
            top = max(top, float(want.abs().max()))
        del msgs64
        rel = worst / top
        require(np.isfinite(res.errors).all() and rel <= 1e-4,
                f"run_distributed fused={fused}: max-norm rel err {rel:.2e}")
        log(f"[5 distributed] frc n=8 s=2 16 steps P={P} fused={fused}: "
            f"max-norm rel err vs fp64 {rel:.2e}, mean err/k "
            f"{res.mean_error:.6f}, {secs:.3f} s")
        del res, decoded
    del task_grads
    trace = make_trace("pareto", steps=steps_basis, n=n_basis, seed=3)
    for fused in (False, True):
        res = ClusterSim("bgc", trace, "deadline", s=8, device=dev) \
            .run_distributed(fused=fused)
        require(np.allclose(res.errors, res.extras["analytic_errors"],
                            rtol=1e-4, atol=1e-6),
                f"run_distributed basis fused={fused}: measured errors "
                f"differ from the analytic errors")
        log(f"[5 distributed] bgc n={n_basis} s=8 basis task grads "
            f"x{steps_basis} fused={fused}: measured == analytic errors, "
            f"mean err/k {res.mean_error:.6f}")
    if dev.type == "cuda":
        torch.cuda.empty_cache()


# --------------------------------------------------------------------------
# timing
# --------------------------------------------------------------------------


def cuda_ms(fn, reps: int, warmup: int = 3) -> float:
    """Mean device milliseconds per call over `reps` calls (CUDA events)."""
    import torch

    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    stop.synchronize()
    return start.elapsed_time(stop) / reps


def device_profile(fn):
    """Run fn() once under torch.profiler.  Returns (wall seconds, device
    busy microseconds, {event name: (count, device microseconds)}) over
    the device's own events (kernels, copies, fills; not the host ops
    that launched them, whose device time would count them twice)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    rows = {e.key: (e.count, e.self_device_time_total)
            for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA
            and e.self_device_time_total > 0}
    return wall, sum(us for _, us in rows.values()), rows


# substrings of each kernel's name in a profiler trace
TRACE_NAMES = {"batched_onestep_decode": "onestep_dense_kernel",
               "batched_onestep_decode_ell": "onestep_ell_kernel",
               "coded_accumulate_batched": "accumulate_kernel<false>",
               "fused_decode_apply": "accumulate_kernel<true>"}


def kernel_device_ms(fn, name: str, reps: int):
    """Mean device time of one launch of kernel `name` over `reps` calls
    of fn, from the profiler's kernel records; None if none was found."""
    _, _, rows = device_profile(lambda: [fn() for _ in range(reps)])
    hits = [(c, us) for key, (c, us) in rows.items()
            if TRACE_NAMES[name] in key]
    count = sum(c for c, _ in hits)
    return sum(us for _, us in hits) / count / 1e3 if count else None


def bound(nbytes: float, flops: float):
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FP32_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def phase_timing(dev, *, n: int, B_dec: int, L: int, P: int,
                 B_agg: int) -> dict:
    import torch

    from repro_torch.kernels import batched_decode as bd
    from repro_torch.kernels import coded_accumulate as acc
    from repro_torch.kernels import fused_decode_apply as fused
    from repro_torch.kernels import ref

    code, dn = decode_inputs(dev, n=n, s=80, B=B_dec)
    k = code.k
    dn_mf = dn["masks"].float()
    sparse_code, sp = decode_inputs(dev, n=n, s=8, B=B_dec)
    sp_mfT = sp["masks"].float().T.contiguous()
    rmax = sp["idx"].shape[1]
    nnz = int((sparse_code.G != 0).sum())
    Gcsr = torch.from_numpy(sparse_code.G.astype("float32")).to(dev) \
        .to_sparse_csr()
    a = aggregate_inputs(dev, L=L, P=P, B=B_agg)
    sw = (a["scales"][:, None] * a["masks"].float()).contiguous()
    dense_args = (dn["G"], dn["masks"], dn["rhos"])
    ell_args = (sp["idx"], sp["val"], sp["masks"], sp["rhos"])
    acc_args = (a["msgs"], a["W"])
    fused_args = (a["msgs"], a["masks"], a["scales"])
    # name -> (kernel, plain version, library call, reps, (bytes, flops))
    cases = {
        "batched_onestep_decode": (
            lambda: bd.batched_onestep_decode(*dense_args),
            lambda: ref.batched_onestep_decode_ref(*dense_args),
            lambda: torch.matmul(dn_mf, dn["G"].T), 200,
            (4 * k * n + B_dec * n + 4 * B_dec + 4 * B_dec * k,
             2 * B_dec * k * n)),
        "batched_onestep_decode_ell": (
            lambda: bd.batched_onestep_decode_ell(*ell_args),
            lambda: ref.batched_onestep_decode_ell_ref(*ell_args),
            lambda: torch.sparse.mm(Gcsr, sp_mfT), 200,
            (8 * k * rmax + B_dec * n + 4 * B_dec + 4 * B_dec * k,
             2 * B_dec * nnz)),
        "coded_accumulate_batched": (
            lambda: acc.coded_accumulate_batched(*acc_args),
            lambda: ref.coded_accumulate_batched_ref(*acc_args),
            lambda: torch.matmul(a["W"], a["msgs"]), 10,
            (4 * (L * P + B_agg * L + B_agg * P), 2 * B_agg * L * P)),
        "fused_decode_apply": (
            lambda: fused.fused_decode_apply(*fused_args),
            lambda: ref.fused_decode_apply_ref(*fused_args),
            lambda: torch.matmul(sw, a["msgs"]), 10,
            (4 * L * P + B_agg * L + 4 * B_agg + 4 * B_agg * P,
             2 * B_agg * L * P + B_agg * P)),
    }
    rows = {}
    for name, (kernel, plain, library, reps, work) in cases.items():
        r = rows[name] = dict(ms=cuda_ms(kernel, reps),
                              plain_ms=cuda_ms(plain, reps),
                              library_ms=cuda_ms(library, reps),
                              bound=bound(*work))
        dms = kernel_device_ms(kernel, name, max(reps // 4, 5))
        log(f"[6 timing] {name}: kernel {r['ms']:.4f} ms per call "
            f"(device time of the kernel alone "
            f"{'not measured' if dms is None else f'{dms:.4f} ms'}), plain "
            f"{r['plain_ms']:.4f} ms, library {r['library_ms']:.4f} ms, "
            f"bound {r['bound'][0]:.4f} ms ({r['bound'][1]})")
    return rows


def phase_trace(dev, *, n: int, trials: int, P: int) -> None:
    """Device busy share of three main-path cells under torch.profiler
    (device time of all kernels and copies over the wall time)."""
    import torch

    from repro_torch.core.simulate import monte_carlo_error
    from repro_torch.sim.cluster import ClusterSim
    from repro_torch.sim.traces import make_trace

    trace = make_trace("pareto", steps=16, n=8, seed=3)
    grads = torch.randn(8, P, device=dev,
                        generator=torch.Generator(device=dev).manual_seed(1))
    cells = {
        f"monte_carlo bgc k=n={n} s=8 x{trials}": lambda: monte_carlo_error(
            "bgc", k=n, n=n, s=8, delta=0.2, trials=trials, device=dev),
        f"ClusterSim.run bgc n={n} x2000": lambda: ClusterSim(
            "bgc", make_trace("pareto", steps=2000, n=n, seed=3),
            "deadline", s=8, device=dev).run(),
        f"run_distributed fused frc n=8 P={P} x16": lambda: ClusterSim(
            "frc", trace, "deadline", s=2, device=dev).run_distributed(
            task_grads=grads, fused=True),
    }
    for cell, fn in cells.items():
        fn()                                             # warm
        wall, busy, rows = device_profile(fn)
        top = sorted(rows.items(), key=lambda kv: -kv[1][1])[:3]
        log(f"[7 trace] {cell}: wall {wall * 1e3:.3f} ms, device busy "
            f"{busy / 1e3:.3f} ms ({100 * busy / 1e6 / wall:.1f} %); top: "
            + "; ".join(f"{k[:48]} x{c} {us / 1e3:.3f} ms"
                        for k, (c, us) in top))
    del grads
    torch.cuda.empty_cache()


# --------------------------------------------------------------------------
# main
# --------------------------------------------------------------------------


def card_name_and_power() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    require(out.returncode == 0 and out.stdout.strip() != "",
            f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this smoke "
              "run needs an NVIDIA GPU", file=sys.stderr)
        return 2
    try:
        from repro_torch.kernels import ops
    except ImportError as e:
        print(f"chip_smoke: cannot import the port from {ROOT / 'src'}: {e}",
              file=sys.stderr)
        return 2
    from repro_torch import platform

    dev = platform.device("cuda:0")
    log(f"[0 device] {torch.cuda.get_device_name(dev)} "
        f"({platform.backend_key(dev)}), torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}")
    # fp32 products in full fp32 for the plain versions and library calls
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()
    try:
        phase_build()
        errs = compare_kernels(dev, n=256, B_dec=1000, L=8, P=P_LAYER,
                               B_agg=16)
        ops.reset_launch_counts()
        phase_monte_carlo(dev, n=256, trials=1000)
        phase_cluster(dev, n=256, steps=2000)
        phase_distributed(dev, P=P_LAYER, n_basis=256, steps_basis=2000)
        torch.cuda.synchronize()
        launches = ops.launch_counts()
        log(f"[3-5 main path] launches: {launches}")
        for name, count in launches.items():
            require(count > 0, f"{name} was not launched on the main path")
        rows = phase_timing(dev, n=256, B_dec=1000, L=8, P=P_LAYER, B_agg=16)
        phase_trace(dev, n=256, trials=1000, P=P_LAYER)
        card = card_name_and_power()
    except SmokeFailure as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1
    except Exception:  # any crash of a phase fails the run, with its trace
        traceback.print_exc()
        print("chip_smoke: FAILED with an exception", file=sys.stderr)
        return 1
    log(f"[done] {time.perf_counter() - t_start:.1f} s")
    records = []
    for name, (source, replaces) in KERNELS.items():
        r = rows[name]
        records.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches[name],
            "max_abs_err": errs[name], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound"][0],
            "bound_by": r["bound"][1], "library_ms": r["library_ms"]})
    print(json.dumps({"kernels": records}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
