"""Readers of the program's own spans and counters (``repro_torch.trace``):
the ``trace`` of each window round's record (``HFLFramework.run_round``)
or of each window dispatch's result (``SweepRunner.run(fused=True)``).
Each span holds its name, id, parent, unit, start and end on
``time.perf_counter_ns()`` (the clock the device trace is mapped onto)
and its device ms, timed by CUDA events on the program's stream. A
program that records no trace gives None here, so a metric that reads
one is left out of the result line."""
from __future__ import annotations

from typing import Dict, List, Optional


def window_traces(run) -> Optional[List[Dict]]:
    """The ``trace`` of every unit of work in the window: the round
    records, or the sweep's dispatch results after the warm-up one;
    None where the window has none or a unit lacks one."""
    units = getattr(run.driver, "records", None)
    if units is None:
        results = getattr(run.driver, "results", None) or []
        units = results[1:]
    if not units or any("trace" not in u for u in units):
        return None
    return [u["trace"] for u in units]


def counter(traces: List[Dict], name: str):
    """Counter ``name`` summed over the window; None where a unit of
    work did not count it."""
    if any(name not in t["counters"] for t in traces):
        return None
    return sum(t["counters"][name] for t in traces)


def span_ms(traces: List[Dict], name: str) -> float:
    """Device ms of the spans called ``name``, summed over the window."""
    return sum(s["device_ms"] for t in traces for s in t["spans"]
               if s["name"] == name)


def solver_steps(run, traces) -> Optional[int]:
    """The allocator's Adam steps over the window (``alloc.steps``), or
    None unless every solve ran the configuration's ``alloc_steps``."""
    if traces is None:
        return None
    steps = counter(traces, "alloc.steps")
    solves = counter(traces, "alloc.solves")
    if not steps or steps != run.cell.cfg["alloc_steps"] * solves:
        return None
    return steps


def sweep_phase_ms(run, phase: str) -> Optional[float]:
    """Device ms a round of a sweep dispatch spends in ``phase``: the
    phase's spans summed over the window's dispatches, over the rounds
    those dispatches ran. None outside a sweep."""
    if getattr(run.driver, "results", None) is None:
        return None
    traces = window_traces(run)
    if traces is None:
        return None
    rounds = len(traces) * run.cell.traffic["rounds_per_dispatch"]
    return span_ms(traces, phase) / rounds
