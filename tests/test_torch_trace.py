"""The port's tracer (``repro_torch.trace``) and what the round, sweep
and set-up paths record with it, on the CPU at a tiny size; one test
on a card holds the round and the fused sweep to no synchronise.

This file imports neither JAX nor ``repro``, so the card test runs
where only torch is installed:

    PYTHONPATH=src python -m pytest -q --noconftest -m cuda tests/test_torch_trace.py

On the CPU a span's device ms is its host ms; the counters are exact
integers (sample-steps and solver steps), so they are held exactly.
"""
import builtins

import numpy as np
import pytest
import torch

import repro_torch.core.cost_model as tcm
import repro_torch.core.resource as ra
import repro_torch.data as tdata
from repro_torch import trace
from repro_torch.core import sweep as tsw
from repro_torch.core.framework import FrameworkConfig, HFLFramework

N, M, H, K, L, Q = 12, 3, 6, 3, 2, 2
ALLOC_STEPS = 7
PHASES = {"schedule", "assign", "allocate", "train", "aggregate", "eval"}


@pytest.fixture(autouse=True)
def one_torch_thread():
    """One intra-op thread, as the suite runs several processes."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _world(seed=0, device="cpu"):
    sp = tcm.SystemParams(n_devices=N, n_edges=M, L=L, Q=Q)
    pop = tcm.sample_population(sp, seed=seed, device=device)
    X, y, Xt, yt = tdata.make_dataset("fmnist_syn", n_train=300, n_test=60,
                                      seed=0)
    fed = tdata.partition_noniid(X, y, Xt, yt, n_devices=N,
                                 size_range=(10, 20), seed=seed)
    return sp, pop, fed


def _framework(device="cpu", **kw):
    cfg = FrameworkConfig(H=H, K=K, alloc_steps=ALLOC_STEPS, device=device,
                          **kw)
    return HFLFramework(*_world(device=device), cfg)


def _children(spans, parent):
    return [s for s in spans if s["parent"] == parent["id"]]


# ------------------------------------------------------------- tracer

def test_spans_nest_with_parents_units_and_attributes():
    tr = trace.Tracer("cpu", unit=7)
    assert trace.current() is None
    with trace.use(tr):
        assert trace.current() is tr
        with trace.span("outer"):
            with trace.span("inner", hop=3):
                pass
            with trace.span("other", unit=(0, 1)):
                with trace.span("leaf"):
                    pass
    assert trace.current() is None
    tr.finish()
    outer, inner, other, leaf = tr.spans
    assert [s["id"] for s in tr.spans] == [0, 1, 2, 3]
    assert outer["parent"] is None and outer["unit"] == 7
    assert inner["parent"] == outer["id"] and inner["unit"] == 7
    assert inner["attrs"] == {"hop": 3}
    assert other["parent"] == outer["id"] and other["unit"] == (0, 1)
    assert leaf["parent"] == other["id"] and leaf["unit"] == (0, 1)
    for s in tr.spans:
        assert s["start_ns"] <= s["end_ns"]
        assert s["device_ms"] == s["host_ms"] >= 0.0
    assert outer["start_ns"] <= inner["start_ns"] <= leaf["end_ns"] \
        <= outer["end_ns"]
    assert tr.seconds("inner") == inner["device_ms"] / 1e3


def test_counters_sum_host_numbers_and_device_tensors():
    tr = trace.Tracer("cpu")
    with trace.use(tr):
        trace.count("n", 2)
        trace.count("n", 3)
        trace.count("dev", torch.tensor(4.0))
        trace.count("dev", torch.tensor([2.0]).sum() * 5)
    assert tr.counters == {"n": 5}          # device counts wait for finish
    assert tr.finish().record()["counters"] == {"n": 5, "dev": 14.0}


def test_a_marked_span_on_the_cpu_launches_nothing_and_times_as_any():
    """``mark`` only launches device markers; on the CPU, where there is
    no device trace, it leaves the span as an unmarked one."""
    tr = trace.Tracer("cpu")
    with trace.use(tr), trace.span("allocate", mark=True, hop=0):
        pass
    (rec,) = tr.finish().spans
    assert rec["name"] == "allocate" and rec["attrs"] == {"hop": 0}
    assert rec["device_ms"] == rec["host_ms"] >= 0.0


def test_without_a_tracer_spans_and_counts_do_nothing():
    with trace.span("x", hop=1) as rec:
        assert rec is None
    trace.count("x", 1)
    assert trace.current() is None


# ------------------------------------------------------------- rounds

@pytest.fixture(scope="module")
def rounds():
    """A framework whose scheduler's cohorts are kept, and its rounds 1
    and 2."""
    fw = _framework(use_kernel=True, agg_kernel=True)
    cohorts = []
    real = fw.scheduler.schedule

    def schedule(rng):
        out = real(rng)
        cohorts.append(np.array(out))
        return out
    fw.scheduler.schedule = schedule
    return fw, [fw.run_round(i) for i in (1, 2)], cohorts


def test_round_seconds_keep_their_six_phases(rounds):
    _, recs, _ = rounds
    for rec in recs:
        assert set(rec["seconds"]) == PHASES
        assert all(v > 0 for v in rec["seconds"].values()), rec["seconds"]
        assert "assign_latency_s" not in rec


def test_round_spans_nest_under_the_round_with_its_index(rounds):
    _, recs, _ = rounds
    for i, rec in zip((1, 2), recs):
        spans = rec["trace"]["spans"]
        root = spans[0]
        assert root["name"] == "round" and root["parent"] is None
        assert all(s["unit"] == i for s in spans)
        kids = _children(spans, root)
        assert [s["name"] for s in kids] == (
            ["schedule", "assign", "allocate"] + ["train", "aggregate"] * Q
            + ["aggregate", "eval"])
        assert [s["attrs"]["hop"] for s in kids if s["name"] == "train"] \
            == list(range(Q))
        assert [s["attrs"]["hop"] for s in kids
                if s["name"] == "aggregate"] == list(range(Q + 1))
        for s in kids:
            assert root["start_ns"] <= s["start_ns"] <= s["end_ns"] \
                <= root["end_ns"]
        assert {s["name"] for s in spans} == PHASES | {"round"}
        for name in ("allocate", "train", "aggregate", "eval"):
            assert rec["seconds"][name] == pytest.approx(sum(
                s["device_ms"] for s in spans if s["name"] == name) / 1e3)


def test_round_counts_the_allocator_solves_and_steps(rounds):
    _, recs, _ = rounds
    for rec in recs:
        c = rec["trace"]["counters"]
        assert c["alloc.solves"] == 1
        assert c["alloc.steps"] == ALLOC_STEPS * c["alloc.solves"]


@pytest.mark.parametrize("cut", [0, 2])
def test_a_solve_counts_the_adam_steps_it_ran(cut, monkeypatch):
    """``alloc.steps`` counts the iterations the loop ran, not the
    ``steps`` asked for: a loop stopped ``cut`` steps early counts
    ``cut`` fewer."""
    monkeypatch.setattr(ra, "range", lambda n: builtins.range(n - cut),
                        raising=False)
    sp, pop, _ = _world()
    s = torch.arange(H)
    tr = trace.Tracer("cpu")
    with trace.use(tr):
        ra.allocate_all_edges(sp, pop, s, s % M, steps=ALLOC_STEPS)
    assert tr.finish().counters == {"alloc.solves": 1,
                                    "alloc.steps": ALLOC_STEPS - cut}


def test_round_counts_real_and_padded_sample_steps(rounds):
    fw, recs, cohorts = rounds
    sizes = np.array([len(y) for y in fw.fed.y])
    d_max = fw.mask.shape[1]
    for rec, cohort in zip(recs, cohorts):
        c = rec["trace"]["counters"]
        assert c["train.real_sample_steps"] == sizes[cohort].sum() * L * Q
        assert c["train.sample_steps"] == len(cohort) * d_max * L * Q


def test_sequential_engine_counts_one_solve_an_edge():
    rec = _framework(engine="sequential").run_round(1)
    c = rec["trace"]["counters"]
    assert c["alloc.solves"] == M
    assert c["alloc.steps"] == ALLOC_STEPS * M
    assert set(rec["seconds"]) == PHASES


def test_setup_seconds_split_the_clustering(rounds):
    fw, _, _ = rounds
    s = fw.setup_seconds
    assert set(s) == {"cluster", "aux_train", "kmeans"}
    assert s["aux_train"] > 0 and s["kmeans"] > 0
    assert s["aux_train"] + s["kmeans"] <= s["cluster"]


# -------------------------------------------------------------- sweep

def _runner(device="cpu"):
    worlds = [_world(seed=s, device=device)[1:] for s in range(2)]
    sp = tcm.SystemParams(n_devices=N, n_edges=M, L=L, Q=Q)
    return sp, tsw.SweepRunner(sp, worlds, alloc_steps=ALLOC_STEPS,
                               agg_kernel=True, device=device)


def _schedulers(sp, runner):
    return [tsw.build_scheduler("ikc", runner.feds[s], sp, H, K=K, seed=s,
                                device=runner.device) for s in range(2)]


@pytest.mark.parametrize("fused", [True, "oracle"])
def test_fused_sweep_traces_every_phase_of_every_round(fused):
    sp, runner = _runner()
    R = 2
    out = runner.run(_schedulers(sp, runner), R, fused=fused)
    spans = out["trace"]["spans"]
    root = spans[0]
    assert root["name"] == "dispatch" and root["parent"] is None
    kids = _children(spans, root)
    reads = 1 if fused is True else R
    assert [s["name"] for s in kids] == (
        ["schedule"] + (["round"] * R + ["readback"] if fused is True
                        else ["round", "readback"] * R))
    rounds_ = [s for s in kids if s["name"] == "round"]
    assert [s["unit"] for s in rounds_] == (
        [(0, r) for r in range(R)] if fused is True
        else [(r, r) for r in range(R)])
    for rnd in rounds_:
        names = [s["name"] for s in _children(spans, rnd)]
        assert names == (["assign", "allocate"] + ["train", "aggregate"] * Q
                         + ["aggregate", "eval"])
        assert all(s["unit"] == rnd["unit"] for s in spans
                   if s["parent"] == rnd["id"])
    assert sum(s["name"] == "readback" for s in spans) == reads
    c = out["trace"]["counters"]
    assert c["alloc.solves"] == R
    assert c["alloc.steps"] == ALLOC_STEPS * R
    sizes = np.array([[len(y) for y in f.y] for f in runner.feds])
    assert c["train.sample_steps"] == R * 2 * H * runner.mask_b.shape[2] \
        * L * Q
    assert 0 < c["train.real_sample_steps"] <= sizes.sum() * R * L * Q


# --------------------------------------------------------------- card

@pytest.mark.cuda
def test_round_and_fused_sweep_never_synchronise(monkeypatch):
    """``torch.cuda.synchronize`` wrapped: a framework round and a fused
    dispatch, set-up excluded, call it not once, and their spans still
    read device times."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    fw = _framework(device="cuda", use_kernel=True, agg_kernel=True)
    sp, runner = _runner(device="cuda")
    scheds = _schedulers(sp, runner)
    fw.run_round(0)                     # warm-up: builds and first calls
    runner.run(scheds, 2, fused=True)
    calls = []
    real = torch.cuda.synchronize

    def counted(*a, **kw):
        calls.append(a)
        return real(*a, **kw)
    monkeypatch.setattr(torch.cuda, "synchronize", counted)
    rec = fw.run_round(1)
    out = runner.run(scheds, 2, fused=True)
    assert calls == []
    for spans in (rec["trace"]["spans"], out["trace"]["spans"]):
        assert all(s["device_ms"] >= 0 for s in spans)
        assert sum(s["device_ms"] for s in spans
                   if s["name"] == "train") > 0
    assert set(rec["seconds"]) == PHASES


@pytest.mark.cuda
def test_the_allocate_span_is_marked_on_the_device():
    """In a profiler's device trace of a round, the allocate span's two
    marker kernels are there, in order, with the solve's operations
    between them and the training's after them."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from torch.profiler import ProfilerActivity, profile
    fw = _framework(device="cuda", use_kernel=True, agg_kernel=True)
    fw.run_round(0)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        rec = fw.run_round(1)
    ops = sorted((e.start_ns(), e.name())
                 for e in prof.profiler.kineto_results.events()
                 if e.device_type() == torch.autograd.DeviceType.CUDA
                 and e.duration_ns() > 0)
    at = [i for i, (_, name) in enumerate(ops) if trace.MARKER in name]
    assert len(at) == 2
    between = at[1] - at[0] - 1
    steps = rec["trace"]["counters"]["alloc.steps"]
    assert steps == ALLOC_STEPS and between >= steps
    assert len(ops) - at[1] - 1 > 0    # training, aggregation, eval after
