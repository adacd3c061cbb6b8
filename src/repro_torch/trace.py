"""Phase spans and counters of the round, sweep and set-up paths.

A :class:`Tracer` records spans and counters for one unit of work (a
round of ``HFLFramework.run_round``, a ``SweepRunner.run(fused=True)``
call, the framework's set-up). A span holds its name, its id, its
parent's id (from the nesting), the unit of work it belongs to, its
attributes, and its start and end on ``time.perf_counter_ns()`` (the
clock a device trace can be mapped onto). On a CUDA device it also
records a ``torch.cuda.Event`` pair on the current stream; nothing
synchronises. A span opened with ``mark=True`` also launches
:data:`MARKER`'s kernel at its start and at its end, on the same
stream: in a device trace the operations between the two markers are
the ones the span issued, whenever the device ran them.
:meth:`Tracer.finish`, which the owner calls after its
own read-back, reads each pair's elapsed time, the span's ``device_ms``
(on the CPU it equals ``host_ms``), and the counts summed on the device.

The tracer is context-local: the owner sets it with :func:`use`, and the
layers below call :func:`span` and :func:`count`, which do nothing when
no tracer is current. Spans stay in memory on the owner's record
(:meth:`Tracer.record`); nothing is written out.
"""
from __future__ import annotations

import contextlib
import contextvars
import time
from typing import Dict, List, Optional, Tuple

import torch

_CURRENT: contextvars.ContextVar[Optional["Tracer"]] = contextvars.ContextVar(
    "repro_torch_tracer", default=None)
_INHERIT = object()     # a span's unit: its parent's, else the tracer's
# the kernel ``torch.cuda._sleep`` launches: one thread, no memory, a
# name nothing else in the program's device trace carries
MARKER = "spin_kernel"


def _mark() -> None:
    torch.cuda._sleep(0)


class Tracer:
    """Spans and counters of one unit of work on ``device``; ``unit``
    is the unit id of its outermost spans."""

    def __init__(self, device, unit=None):
        self.cuda = torch.device(device).type == "cuda"
        self.unit = unit
        self.spans: List[Dict] = []              # in start order
        self.counters: Dict[str, float] = {}
        self._on_device: Dict[str, List[torch.Tensor]] = {}
        self._events: List[Tuple[Dict, object, object]] = []
        self._open: List[Dict] = []

    @contextlib.contextmanager
    def span(self, name: str, unit=_INHERIT, mark: bool = False, **attrs):
        mark = mark and self.cuda
        parent = self._open[-1] if self._open else None
        if unit is _INHERIT:
            unit = parent["unit"] if parent else self.unit
        rec = {"name": name, "id": len(self.spans),
               "parent": parent["id"] if parent else None, "unit": unit,
               "attrs": attrs, "start_ns": time.perf_counter_ns()}
        self.spans.append(rec)
        self._open.append(rec)
        if self.cuda:
            start = torch.cuda.Event(enable_timing=True)
            start.record()
        if mark:
            _mark()
        try:
            yield rec
        finally:
            if mark:
                _mark()
            if self.cuda:
                end = torch.cuda.Event(enable_timing=True)
                end.record()
                self._events.append((rec, start, end))
            rec["end_ns"] = time.perf_counter_ns()
            rec["host_ms"] = (rec["end_ns"] - rec["start_ns"]) / 1e6
            self._open.pop()

    def count(self, name: str, n) -> None:
        """Add ``n`` to counter ``name``: a number on the host, or a
        tensor summed on its device and read by :meth:`finish`."""
        if isinstance(n, torch.Tensor):
            self._on_device.setdefault(name, []).append(n.detach())
        else:
            self.counters[name] = self.counters.get(name, 0) + n

    def finish(self) -> "Tracer":
        """Read every span's device ms and the device counts. Call it
        after the owner's read-back: the stream then holds at most the
        end markers recorded after it, which ``Event.query`` sees
        complete at once."""
        for rec, start, end in self._events:
            while not end.query():
                time.sleep(0)
            rec["device_ms"] = start.elapsed_time(end)
        self._events.clear()
        for rec in self.spans:
            rec.setdefault("device_ms", rec["host_ms"])
        for name, parts in self._on_device.items():
            total = torch.stack([p.reshape(()).double() for p in parts]).sum()
            self.counters[name] = self.counters.get(name, 0) + total.item()
        self._on_device.clear()
        return self

    def seconds(self, name: str, host: bool = False) -> float:
        """Seconds summed over the spans called ``name``: device time,
        or host time with ``host``."""
        key = "host_ms" if host else "device_ms"
        return sum(s[key] for s in self.spans if s["name"] == name) / 1e3

    def record(self) -> Dict:
        """The spans and counters, for the owner's record."""
        return {"spans": self.spans, "counters": dict(self.counters)}


def current() -> Optional[Tracer]:
    return _CURRENT.get()


@contextlib.contextmanager
def use(tracer: Tracer):
    """Make ``tracer`` the current one inside the block."""
    token = _CURRENT.set(tracer)
    try:
        yield tracer
    finally:
        _CURRENT.reset(token)


def span(name: str, unit=_INHERIT, mark: bool = False, **attrs):
    """A span of the current tracer; a no-op context without one."""
    tracer = _CURRENT.get()
    if tracer is None:
        return contextlib.nullcontext()
    return tracer.span(name, unit, mark, **attrs)


def count(name: str, n) -> None:
    """Add ``n`` to the current tracer's counter ``name``, if any."""
    tracer = _CURRENT.get()
    if tracer is not None:
        tracer.count(name, n)
