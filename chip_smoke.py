#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one CUDA card.

    PYTHONPATH=src python3 chip_smoke.py

Phases, each of which fails the run (non-zero exit, no result line):

1. Setup: needs CUDA; turns TF32 off for matmuls and cuDNN; builds the
   CUDA kernels from ``src/repro_torch/csrc`` (into ``build/kernels``)
   and prints the build time, each kernel's register report and the
   card's name and power limit (``nvidia-smi``).
2. Kernels: each CUDA kernel against its plain PyTorch version on the
   card, at the main path's shapes and at edge cases, with the stated
   tolerance; prints kernel, plain and library-call times and the
   least time the card could take (bytes over the memory rate or flops
   over the f32 rate, whichever is larger).
3. Main path: one Table-I world at full width (N=100 devices, M=5 edges,
   D_n in [400, 700], the paper CNN of 457 532 bytes, H=50, K=10, IKC
   scheduling, geo assignment, 200-step allocation) through
   ``HFLFramework``: the Algorithm-2 clustering and 2 rounds, with both
   kernels on. The launch counters are zeroed just before and read just
   after; each must match the count the path implies. Every output must
   be finite.
4. Oracle round: a third round from the same state, once with the
   kernel aggregation and once with the plain matmul aggregation
   (``agg_kernel=False``): T_i and E_i must be equal and the parameters
   within the stated tolerance.
5. Where the time goes: the setup once more (without PyTorch's one-off
   imports) and a fourth round under ``torch.profiler``: device busy
   time against wall time, and the kernels that took the most.

The line before the last is a JSON object with one entry per kernel;
the last line is ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import copy
import dataclasses
import json
import math
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

AGG_TOL = 1e-5          # |kernel - plain| <= AGG_TOL * (1 + |plain|)
DIST_TOL = 1e-5         # |kernel - plain| <= DIST_TOL * (max|plain| + |plain|)
PARAM_TOL = 1e-4        # kernel vs plain-matmul round: max |Δparam|
F32_FLOPS = 67e12       # H100/H200 SXM f32 rate outside the tensor cores


def check(cond, msg):
    if not cond:
        raise SystemExit(f"chip_smoke: FAILED: {msg}")


def memory_rate(name: str) -> float:
    """Bytes/s of device memory, by the card nvidia-smi names."""
    return 4.8e12 if "H200" in name else 3.35e12


def time_ms(fn, reps: int):
    """(graph_ms, eager_ms) per call of ``fn``: replayed from a CUDA graph
    of ``reps`` calls (the device time, launch gaps inside the graph
    only), and as ``reps`` back-to-back eager calls (what a caller pays,
    host launch overhead included), both timed with CUDA events."""
    import torch
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    eager = start.elapsed_time(end) / reps
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start.record()
    graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps, eager


def agg_case(torch, dev, rng, S, M, H, P, empty=()):
    assign = rng.integers(0, M, (S, H))
    for m in empty:
        assign[assign == m] = (m + 1) % M
    mask = assign[:, None, :] == np.arange(M)[None, :, None]
    sizes = rng.integers(400, 701, (S, H))
    deltas = rng.normal(0, 0.1, (S, H, P))        # weights of order 0.1
    return tuple(torch.tensor(a, dtype=torch.float32, device=dev)
                 for a in (mask, sizes, deltas))


def kernel_phase(torch, rate):
    from repro_torch.kernels.hier_agg import ops as ha
    from repro_torch.kernels.kmeans_dist import ops as kd

    dev = torch.device("cuda")
    rng = np.random.default_rng(0)
    out = {}

    # ---- K1 masked_aggregate: eq. (2) leaves of one edge iteration,
    #      the eq. (3) cloud call, and edge cases
    leaves = (375, 10500, 101248, 2260)           # conv1, conv2, fc1, fc2
    cases = ([("edge", 1, 5, 50, P, ()) for P in leaves]
             + [("cloud", 1, 1, 5, P, ()) for P in leaves]
             + [("empty-edges", 1, 5, 50, 10500, (1, 3)),
                ("unaligned", 1, 3, 13, 257, ()),
                ("lanes", 3, 5, 50, 10500, ()),
                ("large-H", 1, 5, 4096, 10500, ()),
                ("M>8", 1, 12, 50, 2260, (4,))])
    k1 = dict(ms=0.0, plain_ms=0.0, library_ms=0.0, eager_ms=0.0, err=0.0)
    edge_bytes = edge_flops = 0
    for tag, S, M, H, P, empty in cases:
        mask, sizes, deltas = agg_case(torch, dev, rng, S, M, H, P, empty)
        got = ha.masked_aggregate_batched(mask, sizes, deltas)
        ref = ha.masked_aggregate_batched_ref(mask, sizes, deltas)
        torch.cuda.synchronize()
        err = float((got - ref).abs().max())
        check(bool(((got - ref).abs() <= AGG_TOL * (1 + ref.abs())).all()),
              f"masked_aggregate {tag} S={S} M={M} H={H} P={P}: "
              f"max_abs_err {err}")
        for m in empty:
            check(bool((got[:, m] == 0).all()), f"empty edge {m} not zero")
        w = mask * sizes[:, None, :]
        w = w / w.sum(2, keepdim=True).clamp_min(1.0)
        reps = 50 if H * P > 1e7 else 200
        t_k, e_k = time_ms(lambda: ha.masked_aggregate_batched(
            mask, sizes, deltas), reps)
        t_p, e_p = time_ms(lambda: ha.masked_aggregate_batched_ref(
            mask, sizes, deltas), reps)
        t_l, e_l = time_ms(lambda: torch.bmm(w, deltas), reps)
        nbytes = 4 * (S * M * H + S * H + S * H * P + S * M * P)
        flops = 2 * S * M * H * P
        bound = max(nbytes / rate, flops / F32_FLOPS) * 1e3
        print(f"masked_aggregate {tag:11s} S={S} M={M:2d} H={H:4d} "
              f"P={P:6d}: kernel_ms={t_k:.5f} plain_ms={t_p:.5f} "
              f"library_ms={t_l:.5f} bound_us={bound * 1e3:.3f} "
              f"max_abs_err={err:.3e} | eager kernel/plain/library_ms="
              f"{e_k:.5f}/{e_p:.5f}/{e_l:.5f}")
        k1["err"] = max(k1["err"], err)
        if tag == "edge":                       # one edge iteration
            k1["ms"] += t_k
            k1["plain_ms"] += t_p
            k1["library_ms"] += t_l
            k1["eager_ms"] += e_k
            edge_bytes += nbytes
            edge_flops += flops
    k1["bound_ms"] = max(edge_bytes / rate, edge_flops / F32_FLOPS) * 1e3
    k1["bound_by"] = ("bytes" if edge_bytes / rate >= edge_flops / F32_FLOPS
                      else "operations")
    out["masked_aggregate"] = k1

    # ---- K2 pairwise_sq_dists: the clustering's shape and K > 128
    k2 = {}
    for tag, N, P, K in (("clustering", 100, 1640, 10),
                         ("K>128", 1000, 1000, 200),
                         ("unaligned", 37, 130, 3)):
        x = torch.randn(N, P, device=dev)
        c = torch.randn(K, P, device=dev)
        got = kd.pairwise_sq_dists(x, c)
        ref = kd.pairwise_sq_dists_ref(x, c)
        torch.cuda.synchronize()
        err = float((got - ref).abs().max())
        check(bool(((got - ref).abs()
                    <= DIST_TOL * (ref.abs().max() + ref.abs())).all()),
              f"pairwise_sq_dists {tag} N={N} P={P} K={K}: "
              f"max_abs_err {err}")
        t_k, e_k = time_ms(lambda: kd.pairwise_sq_dists(x, c), 200)
        t_p, e_p = time_ms(lambda: kd.pairwise_sq_dists_ref(x, c), 200)
        t_l, e_l = time_ms(lambda: torch.cdist(x, c).square_(), 200)
        nbytes = 4 * (N * P + K * P + N * K)
        flops = 2 * N * K * P + 2 * (N + K) * P + 3 * N * K
        bound = max(nbytes / rate, flops / F32_FLOPS) * 1e3
        by = "bytes" if nbytes / rate >= flops / F32_FLOPS else "operations"
        print(f"pairwise_sq_dists {tag:10s} N={N:4d} P={P:4d} K={K:3d}: "
              f"kernel_ms={t_k:.5f} plain_ms={t_p:.5f} library_ms={t_l:.5f} "
              f"bound_us={bound * 1e3:.3f} ({by}) max_abs_err={err:.3e} | "
              f"eager kernel/plain/library_ms={e_k:.5f}/{e_p:.5f}/{e_l:.5f}")
        k2["err"] = max(k2.get("err", 0.0), err)
        if tag == "clustering":
            k2.update(ms=t_k, plain_ms=t_p, library_ms=t_l, eager_ms=e_k,
                      bound_ms=bound, bound_by=by)
    out["pairwise_sq_dists"] = k2
    return out


def fork(fw, **cfg_changes):
    """A framework sharing ``fw``'s world, with its own copy of the
    round state (params, scheduler, rng), so two rounds can start from
    the same state."""
    twin = copy.copy(fw)
    twin.cfg = dataclasses.replace(fw.cfg, **cfg_changes)
    twin.scheduler = copy.deepcopy(fw.scheduler)
    twin.rng = copy.deepcopy(fw.rng)
    twin.model_params = {k: v.clone() for k, v in fw.model_params.items()}
    twin.history = list(fw.history)
    return twin


def main() -> int:
    import torch
    from torch.profiler import ProfilerActivity, profile
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script needs a card",
              file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")

    from repro_torch.core.cost_model import SystemParams, sample_population
    from repro_torch.core.framework import FrameworkConfig, HFLFramework
    from repro_torch.data import make_dataset, partition_noniid
    from repro_torch.kernels import build
    from repro_torch.kernels.hier_agg import ops as ha
    from repro_torch.kernels.kmeans_dist import ops as kd

    # ------------------------------------------------------------ setup
    t0 = time.perf_counter()
    logs = build.build()
    print(f"build: {time.perf_counter() - t0:.1f} s for "
          f"{sorted(logs) or 'nothing (cached)'} "
          f"({' '.join(a for a in build.NVCC_FLAGS if 'sm_' in a)})")
    for name, log in sorted(logs.items()):
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  ptxas {name}: {line.strip()}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    print(smi)
    name = torch.cuda.get_device_name(0)
    rate = memory_rate(name)
    print(f"torch {torch.__version__} cuda {torch.version.cuda}; bound "
          f"rates: {rate / 1e12:.2f} TB/s, {F32_FLOPS / 1e12:.0f} TFLOP/s "
          f"f32")

    # ---------------------------------------------------------- kernels
    kres = kernel_phase(torch, rate)

    # -------------------------------------------------------- main path
    sp = SystemParams()
    pop = sample_population(sp, seed=0)
    X, y, Xt, yt = make_dataset("fmnist_syn")
    fed = partition_noniid(X, y, Xt, yt, n_devices=sp.n_devices,
                           size_range=(400, 700), seed=0)
    cfg = FrameworkConfig(H=50, K=10, scheduler="ikc", assigner="geo",
                          agg_kernel=True, use_kernel=True, alloc_steps=200)
    torch.cuda.reset_peak_memory_stats()
    ha.masked_aggregate_batched_cuda.launches = 0
    kd.pairwise_sq_dists_cuda.launches = 0
    t0 = time.perf_counter()
    fw = HFLFramework(sp, pop, fed, cfg)
    setup_s = time.perf_counter() - t0
    check(fw.model_bits == 457532 * 8, f"model bytes {fw.model_bits / 8}")
    print(f"setup: {setup_s:.3f} s (clustering "
          f"{fw.setup_seconds['cluster']:.3f} s), ari="
          f"{fw.clustering_stats['ari']:.3f}, clustering delay="
          f"{fw.clustering_stats['delay_s']:.3f} s energy="
          f"{fw.clustering_stats['energy_j']:.3f} J")
    for i in (1, 2):
        t0 = time.perf_counter()
        rec = fw.run_round(i)
        rec["wall_s"] = time.perf_counter() - t0
        rec["max_memory_allocated"] = torch.cuda.max_memory_allocated()
        split = " ".join(f"{k}={v:.4f}" for k, v in rec["seconds"].items())
        print(f"round {i}: acc={rec['acc']:.4f} T_i={rec['T_i']:.4f} "
              f"E_i={rec['E_i']:.4f} wall_s={rec['wall_s']:.4f} [{split}] "
              f"max_memory_allocated={rec['max_memory_allocated']}")
        check(all(math.isfinite(rec[k]) for k in ("acc", "T_i", "E_i")),
              f"round {i} record not finite: {rec}")
    launches = {"masked_aggregate": ha.masked_aggregate_batched_cuda.launches,
                "pairwise_sq_dists": kd.pairwise_sq_dists_cuda.launches}
    # K1: per round Q edge aggregations + 1 cloud one, per leaf; K2: per
    # restart (8) K-1 kmeans++ passes, 50 Lloyd steps and the labels
    n_leaves = len(fw.model_params)
    expect = {"masked_aggregate": 2 * (sp.Q + 1) * n_leaves,
              "pairwise_sq_dists": 8 * ((cfg.K - 1) + 50 + 1)}
    print(f"main-path launches: {launches} (expected {expect})")
    check(all(v > 0 for v in launches.values()), "a kernel never launched")
    check(launches == expect, "launch counts differ from the path's")
    check(all(bool(torch.isfinite(v).all())
              for v in fw.model_params.values()), "non-finite params")

    # ---------------------------------------------------- oracle round
    plain = fork(fw, agg_kernel=False)
    rk, rp = fw.run_round(3), plain.run_round(3)
    dmax = max(float((fw.model_params[k] - plain.model_params[k]).abs().max())
               for k in fw.model_params)
    print(f"round 3 kernel vs plain matmul: T_i {rk['T_i']} vs {rp['T_i']}, "
          f"E_i {rk['E_i']} vs {rp['E_i']}, acc {rk['acc']} vs {rp['acc']}, "
          f"max |dparam| {dmax:.3e} (tolerance {PARAM_TOL})")
    check(rk["T_i"] == rp["T_i"] and rk["E_i"] == rp["E_i"],
          "T_i/E_i differ between the aggregation backends")
    check(dmax <= PARAM_TOL, f"params differ by {dmax}")

    # ------------------------------------------------ where time goes
    # setup again: the first construction also paid PyTorch's one-off
    # lazy imports (torch.func pulls in torch._dynamo and sympy)
    t0 = time.perf_counter()
    again = HFLFramework(sp, pop, fed, cfg)
    print(f"setup again: {time.perf_counter() - t0:.3f} s (clustering "
          f"{again.setup_seconds['cluster']:.3f} s)")
    del again
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fw.run_round(4)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    kern = [e for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA]
    busy = sum(e.self_device_time_total for e in kern) / 1e6
    top = sorted(kern, key=lambda e: -e.self_device_time_total)[:6]
    print(f"profiled round 4: wall {wall:.3f} s, device busy {busy:.3f} s "
          f"({busy / wall:.1%}); top device time: " + "; ".join(
              f"{e.key[:60]} {e.self_device_time_total / 1e3:.1f} ms "
              f"x{e.count}" for e in top))

    # ----------------------------------------------------------- result
    routes = {
        "masked_aggregate": ("src/repro_torch/csrc/hier_agg.cu",
                             "src/repro/kernels/hier_agg/hier_agg.py:111",
                             "one edge iteration: 4 leaf launches, H=50, "
                             "M=5, P=375+10500+101248+2260"),
        "pairwise_sq_dists": ("src/repro_torch/csrc/kmeans_dist.cu",
                              "src/repro/kernels/kmeans_dist/kmeans_dist.py:50",
                              "one launch, N=100, P=1640, K=10")}
    kernels = []
    for kname, (src, replaces, work) in routes.items():
        r = kres[kname]
        kernels.append({
            "name": kname, "route": "cuda", "source": src,
            "replaces": replaces, "launches": launches[kname],
            "max_abs_err": r["err"], "ms": r["ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
            "library_ms": r["library_ms"], "eager_ms": r["eager_ms"],
            "work": work})
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
