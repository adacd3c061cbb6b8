"""The readers of the program's own spans and counters, on the CPU at a
tiny size: each gives its value from a short run of its cells' drivers,
and none where the program recorded nothing (a program without the
tracer) or where its counters disagree with the configuration.

    python -m pytest -q hflbench/tests
"""
import builtins
import copy
import sys
import time
import types
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

from hflbench import harness  # noqa: E402

SEED = 2 ** 31 + 4321
NEW = ("alloc_step_us", "alloc_ops_per_step", "pad_share_pct",
       "cluster_kmeans_s", "sweep_allocate_ms", "sweep_train_ms",
       "sweep_aggregate_ms")


def _tiny(name, world=(12, 2, 3, 6), d=(20, 40)):
    N, M, K, H = world
    cell = harness.find_cell(name)
    cell.cfg.update(n_devices=N, n_edges=M, K=K, d_min=d[0], d_max=d[1],
                    n_train=2000, n_test=200)
    cell.traffic = dict(cell.traffic, H=H)
    if "lanes" in cell.traffic:
        cell.traffic.update(lanes=2)
    return cell


def _run(name):
    """A short window of the cell's driver, in the form the readers
    read (no device trace on the CPU)."""
    torch.set_num_threads(2)
    cell = _tiny(name)
    drv = harness.driver(cell.traffic["driver"]).Driver(
        cell, SEED, torch.device("cpu"))
    drv.setup()
    w0 = time.perf_counter_ns()
    work = drv.run(0.5)
    w1 = time.perf_counter_ns()
    drv.release()
    return types.SimpleNamespace(
        cell=cell, driver=drv, work=work, walls=list(drv.walls),
        window_s=(w1 - w0) / 1e9, setup_s=0.0, window_peak=0, launches=0,
        events=None, trace=None)


@pytest.fixture(scope="module")
def round_run():
    return _run("fmnist-round-h50")


@pytest.fixture(scope="module")
def sweep_run():
    return _run("fmnist-sweep-s4")


def read(name, run):
    return harness.metric_reader(name)(run)


def _reported(cell):
    return {m["name"] for m in harness.find_cell(cell).per_layer}


def test_each_cell_lists_the_readers_that_find_something():
    assert set(NEW) - {"sweep_allocate_ms", "sweep_train_ms",
                       "sweep_aggregate_ms"} <= _reported("fmnist-round-h50")
    assert {"sweep_alloc_step_us", "sweep_pad_share_pct",
            "sweep_allocate_ms", "sweep_train_ms", "sweep_aggregate_ms"} <= \
        _reported("fmnist-sweep-s4")
    assert not {"alloc_ops_per_step", "cluster_kmeans_s"} & \
        _reported("fmnist-sweep-s4")


def test_round_readers(round_run):
    run = round_run
    us = read("alloc_step_us", run)
    allocate_ms = np.mean([r["seconds"]["allocate"] for r in
                           run.driver.records]) * 1e3
    assert 0 < us and us * run.cell.cfg["alloc_steps"] / 1e3 == \
        pytest.approx(allocate_ms)
    pad = read("pad_share_pct", run)
    # D_n in [20, 40], every device padded to the largest
    assert 0 < pad < 50
    kmeans = read("cluster_kmeans_s", run)
    assert 0 < kmeans < run.driver.setup_seconds["cluster"]
    for name in ("sweep_allocate_ms", "sweep_train_ms",
                 "sweep_aggregate_ms"):
        assert read(name, run) is None


def test_sweep_readers(sweep_run):
    run = sweep_run
    R = run.cell.traffic["rounds_per_dispatch"]
    results = run.driver.results[1:]
    for phase in ("allocate", "train", "aggregate"):
        ms = read(f"sweep_{phase}_ms", run)
        want = sum(s["device_ms"] for r in results
                   for s in r["trace"]["spans"]
                   if s["name"] == phase) / (len(results) * R)
        assert ms > 0 and ms == pytest.approx(want)
    assert read("alloc_step_us", run) > 0
    assert 0 < read("pad_share_pct", run) < 50
    assert read("cluster_kmeans_s", run) is None


def _marked_events(run, k, around=7, pairs=None):
    """A device trace in which each window round's allocate span issued
    k operations a step and ``around`` more between its two markers,
    with operations before and after them; ``pairs`` marker pairs in
    all (one a round by default)."""
    t, events = 0, []

    def op(name):
        nonlocal t
        events.append((name, t, t + 1))
        t += 2
    recs = run.driver.records
    for rec in recs[:len(recs) if pairs is None else pairs]:
        op("before")
        op("void spin_kernel(long)")
        for _ in range(k * rec["trace"]["counters"]["alloc.steps"] + around):
            op("op")
        op("void spin_kernel(long)")
        op("after")
    return events


def test_the_op_count_reads_the_trace_between_the_allocate_markers(
        round_run):
    """Without a trace nothing; with one, the operations between each
    round's pair of allocate markers, k a step and a few around the
    loop, read k, however late the device ran them."""
    run = copy.copy(round_run)
    assert read("alloc_ops_per_step", run) is None
    run.events = _marked_events(run, k=3)
    assert read("alloc_ops_per_step", run) == 3


def test_the_op_count_refuses_markers_that_do_not_pair_with_the_spans(
        round_run):
    run = copy.copy(round_run)
    run.events = _marked_events(run, k=3, pairs=len(run.driver.records) - 1)
    assert read("alloc_ops_per_step", run) is None
    run.events = [e for e in _marked_events(run, k=3) if e[0] != "op"] \
        + [("void spin_kernel(long)", 10 ** 9, 10 ** 9 + 1)]
    assert read("alloc_ops_per_step", run) is None


def test_a_solve_that_runs_fewer_steps_reads_no_step_time(monkeypatch):
    """A solve whose loop stops early, its ``steps`` argument still the
    configuration's: ``alloc.steps`` counts the steps it ran, so the
    step readers refuse it instead of dividing by steps never run."""
    import repro_torch.core.resource as ra
    monkeypatch.setattr(ra, "range", lambda n: builtins.range(n // 2),
                        raising=False)
    run = _run("fmnist-round-h50")
    steps = run.cell.cfg["alloc_steps"]
    for rec in run.driver.records:
        c = rec["trace"]["counters"]
        assert c["alloc.steps"] == steps // 2 * c["alloc.solves"]
    assert read("alloc_step_us", run) is None
    run.events = _marked_events(run, k=3)
    assert read("alloc_ops_per_step", run) is None


def test_step_readers_refuse_a_count_the_config_disagrees_with(round_run):
    run = copy.copy(round_run)
    run.cell = copy.deepcopy(run.cell)
    run.cell.cfg["alloc_steps"] += 1
    run.events = [("op", 0, 1)]
    assert read("alloc_step_us", run) is None
    assert read("alloc_ops_per_step", run) is None


@pytest.mark.parametrize("which", ["round", "sweep"])
def test_a_program_without_the_tracer_gives_none(which, round_run,
                                                 sweep_run):
    """The records of a program that records no spans or counters, as
    the program before the tracer: every new reader returns None."""
    run = copy.copy(round_run if which == "round" else sweep_run)
    drv = copy.copy(run.driver)
    if which == "round":
        drv.records = [{k: v for k, v in r.items() if k != "trace"}
                       for r in drv.records]
        drv.setup_seconds = {"cluster": 1.0}
    else:
        drv.results = [{k: v for k, v in r.items() if k != "trace"}
                       for r in drv.results]
    run.driver = drv
    run.events = [("op", 0, 1)]
    for name in NEW:
        assert read(name, run) is None, name


# ------------------------------------------- the round cells' device time

SHARED = ("k1_roofline_pct", "idle_pct", "peak_gb", "alloc_step_us",
          "pad_share_pct", "conv_kernel_share_pct")


def _traced(run, busy_s, window_s=10.0):
    run = copy.copy(run)
    run.trace = {"busy_s": busy_s, "window_s": window_s}
    return run


def test_device_ms_per_round_is_the_device_time_over_the_rounds(round_run):
    run = _traced(round_run, 2.5)
    assert read("device_ms_per_round", run) == pytest.approx(
        2500.0 / round_run.work)
    assert read("device_ms_per_round", round_run) is None
    idle = copy.copy(run)
    idle.work = 0
    assert read("device_ms_per_round", idle) is None


def test_step_mfu_is_the_window_flops_over_the_device_time(round_run):
    from hflbench import arith
    run = _traced(round_run, 0.5)
    flops = round_run.driver.window_flops()
    assert flops > 0
    assert read("step_mfu_pct", run) == pytest.approx(
        100.0 * flops / (0.5 * arith.PEAK_F32_FLOPS))
    # never above the window's share, which counts the idle time too
    assert read("step_mfu_pct", run) >= read("mfu_pct", run)
    assert read("step_mfu_pct", round_run) is None
    assert read("step_mfu_pct", _traced(round_run, 0.0)) is None


def test_the_loop_rate_is_rounds_per_s(round_run):
    assert read("loop_rounds_per_s", round_run) == \
        read("rounds_per_s", round_run) > 0


@pytest.mark.parametrize("name", SHARED)
def test_the_sweeps_copy_reads_as_the_round_cells_reader(name, sweep_run):
    run = _traced(sweep_run, 1.0)
    run.window_peak = 5e9
    run.events = []
    assert read(f"sweep_{name}", run) == read(name, run)
    cell = harness.find_cell("fmnist-sweep-s4")
    assert f"sweep_{name}" in {m["name"] for m in cell.per_layer}
    assert name not in {m["name"] for m in cell.per_layer}


def test_only_the_round_cells_record_the_trace_untraced():
    """The sweep's rate is never read under the profiler; each round
    cell's device time is read from a trace in every run."""
    assert not harness.reads_the_trace(
        harness.find_cell("fmnist-sweep-s4").end_to_end)
    for cell in ("fmnist-round-h50", "cifar-round-h50", "fmnist-round-h30"):
        ends = harness.find_cell(cell).end_to_end
        assert harness.reads_the_trace(ends)
        assert {m["name"] for m in ends} == {"device_ms_per_round",
                                              "setup_s"}
