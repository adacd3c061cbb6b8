"""Whole runs of the benchmark on the CPU at a tiny size: the program
(its plain versions of the kernels) agrees with the reference; the
lower-precision control and each fault a cell can have come out not
correct; on a card, one short run of a cell is correct.

    python -m pytest -q hflbench/tests
"""
import json
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

from hflbench import calibrate, check, harness  # noqa: E402
from hflbench.run import measure  # noqa: E402

SEED = 2 ** 31 + 12345          # larger than 32 signed bits hold


def tiny(name, d=(20, 40), world=(12, 2, 3, 6)):
    """The cell at a size a CPU test holds: ``world`` = (devices, edges,
    clusters, cohort), 12, 2, 3 and 6 by default, ``d`` samples a
    device, 2 sweep lanes."""
    N, M, K, H = world
    cell = harness.find_cell(name)
    cell.cfg.update(n_devices=N, n_edges=M, K=K, d_min=d[0], d_max=d[1],
                    n_train=2000, n_test=200)
    cell.traffic = dict(cell.traffic, H=H)
    if "lanes" in cell.traffic:
        cell.traffic.update(lanes=2)
    return cell


def run_tiny(name, capsys, seconds=1.0, d=(20, 40), world=(12, 2, 3, 6)):
    rc = measure(tiny(name, d, world), SEED, seconds, False,
                 torch.device("cpu"), time.perf_counter())
    assert rc == 0
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


@pytest.mark.parametrize("name", ["fmnist-round-h50", "cifar-round-h50",
                                  "fmnist-sweep-s4", "fmnist-round-h30"])
def test_the_program_agrees_with_the_reference(name, capsys):
    """At 150-200 samples a device: with fewer, a round's 25 steps
    amplify float32 rounding beyond the limits set at the cells' size
    (PERF.md, update_gap)."""
    res = run_tiny(name, capsys, d=(150, 200))
    assert res["correct"], res["checks"]
    assert res["failed"] == 0 and res["attempted"] >= 1
    assert list(res)[-1] == "checks"
    # the CPU records no device trace: the host's metrics alone
    host = {m["name"] for m in harness.find_cell(name).end_to_end
            if m["source"] == "host_clock"}
    assert "setup_s" in host and set(res["metrics"]) == host


def test_the_lower_precision_control_is_not_correct():
    """The TF32 reference in the program's place fails a number."""
    rows = calibrate.readings(tiny("fmnist-round-h50"), SEED, 1.0,
                              torch.device("cpu"), control=True)
    lim = check.limits("fmnist-round-h50")
    kinds = dict(rows)
    assert all(v <= lim[k] for k, v in kinds["sound"].items())
    assert any(v > lim[k] for k, v in kinds["control"].items()), kinds


# -------------------------------------------------------------- faults

def _unchanged(monkeypatch):
    from repro_torch.core import framework

    def step(apply_fn, global_params, *a, **kw):
        return {k: v.clone() for k, v in global_params.items()}
    monkeypatch.setattr(framework, "hfl_global_iteration_lanes", step)


def _half_batch(monkeypatch):
    from repro_torch.core import hfl
    real = hfl.cohort_local_sgd

    def sgd(apply_fn, params, X, y, mask, L, lr):
        keep = torch.cumsum(mask, dim=-1) <= mask.sum(-1, keepdim=True) / 2
        return real(apply_fn, params, X, y, mask * keep, L, lr)
    monkeypatch.setattr(hfl, "cohort_local_sgd", sgd)


def _altered_cohort(monkeypatch):
    from repro_torch.core.scheduling import schedulers
    real = schedulers.IKCScheduler.schedule

    def schedule(self, rng):
        out = real(self, rng).copy()
        out[0] = (out[0] + 1) % self.n_devices
        return out
    monkeypatch.setattr(schedulers.IKCScheduler, "schedule", schedule)


def _altered_answer(monkeypatch):
    from repro_torch.core import hfl
    real = hfl._count_correct
    monkeypatch.setattr(hfl, "_count_correct",
                        lambda *a: real(*a) + 1)


def _allocation_unchanged(monkeypatch):
    from repro_torch.core import resource
    real = resource.allocate_batch
    monkeypatch.setattr(resource, "allocate_batch",
                        lambda *a, steps=300: real(*a, steps=0))


def _allocation_cut(monkeypatch):
    """The reference's solve, in float32, in the program's place, stopped
    after half its steps, mid-anneal."""
    from hflbench import reference as ref
    from repro_torch.core import resource
    cm = ref.CostModel(tiny("fmnist-round-h50").cfg)

    def allocate_batch(sp, u, D, p, g, B_m, mask, steps=300):
        b, f = ref.allocate(cm, u, D, p, g, B_m, mask, steps, steps // 2)
        t, e = resource._edge_terms(sp, u, D, p, g, b.clamp_min(1.0), f,
                                    mask)
        T, E = sp.Q * t.amax(-1), sp.Q * e.sum(-1)
        return resource.AllocResult(b, f, T, E, E + sp.lam * T)
    monkeypatch.setattr(resource, "allocate_batch", allocate_batch)


@pytest.mark.parametrize("fault,number,world", [
    (_unchanged, "update_gap", (12, 2, 3, 6)),
    (_half_batch, "update_gap", (12, 2, 3, 6)),
    (_altered_cohort, "cohort_mismatch", (12, 2, 3, 6)),
    (_altered_answer, "acc_gap", (12, 2, 3, 6)),
    # several devices an edge, as at the cells' size: with 3 an edge the
    # solver's start lies within 25 % of its end
    (_allocation_unchanged, "alloc_excess", (40, 5, 4, 20)),
    (_allocation_cut, "alloc_excess_mean", (100, 5, 10, 50))])
def test_a_fault_in_the_timed_path_is_not_correct(fault, number, world,
                                                   monkeypatch, capsys):
    fault(monkeypatch)
    res = run_tiny("fmnist-round-h50", capsys, world=world)
    assert not res["correct"]
    row = res["checks"][number]
    assert row["value"] > row["limit"], res["checks"]


def test_a_fault_in_the_sweep_is_not_correct(monkeypatch, capsys):
    _half_batch(monkeypatch)
    res = run_tiny("fmnist-sweep-s4", capsys)
    assert not res["correct"]
    assert res["checks"]["update_gap"]["value"] > \
        res["checks"]["update_gap"]["limit"]


# ------------------------------------------- the program's internals

def _round_body_renamed(monkeypatch):
    from repro_torch.core import framework
    monkeypatch.delattr(framework, "round_step_lanes")


def _round_body_resigned(monkeypatch):
    from repro_torch.core import framework
    real = framework.round_step_lanes
    monkeypatch.setattr(framework, "round_step_lanes",
                        lambda apply_fn, sp, state, *a, **kw:
                        real(apply_fn, sp, state, *a, **kw))


@pytest.mark.parametrize("change", [_round_body_renamed,
                                    _round_body_resigned])
def test_a_changed_program_internal_stops_the_run_loudly(change,
                                                         monkeypatch):
    from hflbench.recorder import ProgramChanged
    change(monkeypatch)
    with pytest.raises(ProgramChanged, match="round_step_lanes"):
        measure(tiny("fmnist-round-h50"), SEED, 1.0, False,
                torch.device("cpu"), time.perf_counter())


def test_a_wrapper_the_program_no_longer_calls_stops_the_run_loudly():
    from hflbench.recorder import ProgramChanged, Recorder
    rec = Recorder()
    rec.calls.update({"round body": 1, "allocate": 1, "algorithm 1": 1})
    with pytest.raises(ProgramChanged, match="eval"):
        rec.expect_seen()


# ---------------------------------------------------------------- card

@pytest.mark.cuda
def test_a_short_run_on_the_card_is_correct():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    p = subprocess.run([sys.executable, "hflbench/run.py", "--workload",
                        "fmnist-round-h50", "--seed", str(SEED),
                        "--seconds", "5", "--trace", "1"], cwd=ROOT,
                       capture_output=True, text=True,
                       env={k: v for k, v in os.environ.items()
                            if k != "PYTHONPATH"})
    assert p.returncode == 0, p.stderr[-3000:]
    res = json.loads(p.stdout.strip().splitlines()[-1])
    assert res["correct"], res["checks"]
    assert 0 < res["device"]["busy_s"] <= res["device"]["window_s"]
    assert np.isfinite(res["metrics"]["idle_pct"]["value"])
