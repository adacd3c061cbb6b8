"""The reader of the conv blocks' kernel share (``conv_kernel_share_pct``)
on the CPU: 100 where every block ran on the kernel, the share where both
counters count, None where the program counted neither (a program
without the kernel), and the counters as a short CPU window of a round
cell records them (every block plain there).

    python -m pytest -q hflbench/tests
"""
import sys
import types
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

from hflbench import harness  # noqa: E402

read = harness.metric_reader("conv_kernel_share_pct")


def _run(*counters, sweep=False):
    units = [{"trace": {"spans": [], "counters": c}} for c in counters]
    if sweep:                  # the sweep's first dispatch is the warm-up
        return types.SimpleNamespace(driver=types.SimpleNamespace(
            results=[{"trace": {"spans": [], "counters": {}}}] + units))
    return types.SimpleNamespace(driver=types.SimpleNamespace(records=units))


@pytest.mark.parametrize("sweep", [False, True])
def test_kernel_blocks_only_read_100(sweep):
    assert read(_run({"conv.kernel_blocks": 52}, {"conv.kernel_blocks": 52},
                     sweep=sweep)) == 100.0


def test_both_counters_read_the_share_over_the_window():
    run = _run({"conv.kernel_blocks": 30, "conv.plain_blocks": 10},
               {"conv.plain_blocks": 10})
    assert read(run) == pytest.approx(60.0)


def test_neither_counter_reads_none():
    assert read(_run({"train.sample_steps": 5}, {})) is None
    assert read(types.SimpleNamespace(driver=types.SimpleNamespace(
        records=[{"seconds": {}}]))) is None


def test_every_cell_reports_it():
    for cell, name in (("fmnist-round-h50", "conv_kernel_share_pct"),
                       ("cifar-round-h50", "conv_kernel_share_pct"),
                       ("fmnist-round-h30", "conv_kernel_share_pct"),
                       ("fmnist-sweep-s4", "sweep_conv_kernel_share_pct")):
        names = {m["name"] for m in harness.find_cell(cell).per_layer}
        assert name in names


def test_a_cpu_window_counts_every_block_plain():
    from test_hflbench_trace import _run as window
    run = window("fmnist-round-h50")
    counters = [r["trace"]["counters"] for r in run.driver.records]
    assert all(c["conv.plain_blocks"] > 0 for c in counters)
    assert not any("conv.kernel_blocks" in c for c in counters)
    assert read(run) == 0.0
