"""What the benchmark reads from the program while it runs.

``Recorder`` wraps a few of the program's functions so that each call
passes through unchanged and leaves behind what the correctness check
judges: the cohort each scheduler drew, and each round body's
parameters in and out, assignment, allocation (b, f) and priced costs.
For the units of work that ``keep(unit)`` picks (a round, or a sweep
dispatch) it also keeps what the first edge iteration's local training
returned for every device. It keeps references to the program's
tensors (no copy, no device synchronise), so the timed path is the same
with and without it. It also notes on the host clock when the program
was in which phase (schedule, allocate, Algorithm 1, eval), which names
the idle gaps of the device trace.

It relies on the program's internals: the names of the functions it
wraps, their module attributes (through which the program calls them),
the leading parameters of the round body, and the round body's
returning its (T_i, E_i, ., ., b, f) last. Where any of that has
changed it raises ``ProgramChanged``, naming what, and the run ends
without a result.
"""
from __future__ import annotations

import collections
import inspect
import time
from typing import Dict, List, Tuple

# the leading parameters of the round body, whose arguments are read
ROUND_PARAMS = ("apply_fn", "sp", "params", "u", "D", "p", "g", "g_cloud",
                "B_m", "X", "y", "mask", "sizes", "assign", "lr")


class ProgramChanged(RuntimeError):
    """What the recorder reads off the program is no longer there."""


class Recorder:
    def __init__(self, keep=lambda unit: False, rounds_per_unit: int = 1):
        self.keep, self.per_unit = keep, rounds_per_unit
        self.rounds: List[Dict] = []          # one entry a round body call
        self.local: Dict[int, Dict] = {}      # round -> first hop's devices
        self._hop = 0
        self.cohorts: List[List] = []         # a scheduler's cohorts
        self.spans: List[Tuple[str, int, int]] = []   # (phase, t0, t1) ns
        self.calls = collections.Counter()    # calls of each wrapper
        self._undo: List[Tuple[object, str, object]] = []

    # ------------------------------------------------------ patching

    def _patch(self, owner, name: str, wrapper_of, params=()):
        where = f"{owner.__name__}.{name}"
        original = getattr(owner, name, None)
        if not callable(original):
            raise ProgramChanged(f"{where} is gone; hflbench/recorder.py "
                                 "reads the program through it")
        got = tuple(inspect.signature(original).parameters)[:len(params)]
        if got != tuple(params):
            raise ProgramChanged(f"{where} takes {got}, where "
                                 f"hflbench/recorder.py expects {params}")
        self._undo.append((owner, name, original))
        setattr(owner, name, wrapper_of(original))

    def _timed(self, phase: str):
        def wrapper_of(fn):
            def wrapped(*a, **kw):
                t0 = time.perf_counter_ns()
                self.calls[phase] += 1
                try:
                    return fn(*a, **kw)
                finally:
                    self.spans.append((phase, t0, time.perf_counter_ns()))
            return wrapped
        return wrapper_of

    def install(self):
        """Wrap the program's round body (the lane-batched round of the
        framework and of the sweep) and its phases."""
        from repro_torch.core import framework, hfl, resource, sweep

        def round_wrapper(fn):
            def wrapped(apply_fn, sp, params, u, D, p, g, g_cloud, B_m, X, y,
                        mask, sizes, assign, lr, **kw):
                t0 = time.perf_counter_ns()
                self._hop = 0
                out = fn(apply_fn, sp, params, u, D, p, g, g_cloud, B_m, X,
                         y, mask, sizes, assign, lr, **kw)
                self.spans.append(("round body", t0, time.perf_counter_ns()))
                self.calls["round body"] += 1
                if not (isinstance(out[-1], tuple) and len(out[-1]) == 6):
                    raise ProgramChanged(
                        "round_step_lanes no longer returns (T_i, E_i, ., ., "
                        "b, f) last; hflbench/recorder.py reads them there")
                T_i, E_i, _, _, b, f = out[-1]
                self.rounds.append(dict(params_in=params, params_out=out[0],
                                        assign=assign, b=b, f=f, T_i=T_i,
                                        E_i=E_i))
                return out
            return wrapped

        def local_wrapper(fn):
            def wrapped(*a, **kw):
                out = fn(*a, **kw)
                i = len(self.rounds)
                if self._hop == 0 and self.keep(i // self.per_unit):
                    self.local[i] = out
                self._hop += 1
                return out
            return wrapped

        self._patch(framework, "round_step_lanes", round_wrapper,
                    ROUND_PARAMS)
        self._patch(hfl, "cohort_local_sgd", local_wrapper)
        self._patch(sweep, "round_step_lanes", round_wrapper, ROUND_PARAMS)
        self._patch(resource, "allocate_batch", self._timed("allocate"))
        self._patch(framework, "hfl_global_iteration_lanes",
                    self._timed("algorithm 1"))
        self._patch(hfl, "_count_correct", self._timed("eval"))
        self._patch(sweep, "sweep_eval", self._timed("eval"))
        return self

    def expect_seen(self):
        """Raise ``ProgramChanged`` unless a unit of work (the warm-up)
        went through every wrapper: the program calls what it wraps."""
        for what in ("round body", "allocate", "algorithm 1", "eval"):
            if not self.calls[what]:
                raise ProgramChanged(
                    f"the program's {what} never passed through "
                    "hflbench/recorder.py's wrapper: it is no longer "
                    "called through the module attribute the recorder "
                    "wraps")

    def watch_scheduler(self, sched):
        """Record every cohort ``sched`` draws, in order."""
        key = len(self.cohorts)
        self.cohorts.append([])
        original = sched.schedule

        def schedule(rng):
            t0 = time.perf_counter_ns()
            out = original(rng)
            self.spans.append(("schedule", t0, time.perf_counter_ns()))
            self.cohorts[key].append(out.copy())
            return out

        sched.schedule = schedule
        return key

    def uninstall(self):
        for owner, name, original in reversed(self._undo):
            setattr(owner, name, original)
        self._undo.clear()
