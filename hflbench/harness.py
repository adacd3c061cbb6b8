"""The benchmark's general parts: finding a cell's files by the names in
``BENCHMARK.json``, the device trace and its reduction to busy time,
idle gaps and kernel times, the per-layer metric readers, and the
guard against the JAX package in the measured process.
"""
from __future__ import annotations

import bisect
import dataclasses
import importlib
import importlib.util
import json
import sys
import time
from pathlib import Path
from typing import Dict, List, Tuple

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent

# top-level module names that may not be loaded in the measured process
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def forbidden_modules(names) -> List[str]:
    """The loaded modules whose top-level name (before the first dot) is
    one of FORBIDDEN, compared whole: ``repro_torch`` is not ``repro``."""
    return sorted({n for n in names if n.split(".")[0] in FORBIDDEN})


# -------------------------------------------------------------- files

def load_benchmark(root: Path = ROOT) -> Dict:
    return json.loads((root / "BENCHMARK.json").read_text())


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    cfg: Dict            # configs/<config>.json
    traffic: Dict        # traffic/<traffic>.json
    end_to_end: List[Dict]
    per_layer: List[Dict]


def _reports(metric: Dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def find_cell(name: str, root: Path = ROOT) -> Cell:
    """The cell ``name`` of BENCHMARK.json with its configuration and
    traffic files and the metrics it reports."""
    bench = load_benchmark(root)
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise SystemExit(f"hflbench: no workload {name!r} in BENCHMARK.json"
                         f" (known: {', '.join(cells)})")
    w = cells[name]
    cfgs = {c["name"]: c for c in bench["configs"]}
    cfg = json.loads((root / cfgs[w["config"]]["file"]).read_text())
    traffic = json.loads((root / "hflbench" / "traffic"
                          / f"{w['traffic']}.json").read_text())
    return Cell(name, w["chips"], cfg, traffic,
                [m for m in bench["end_to_end"] if _reports(m, name)],
                [m for m in bench["per_layer"] if _reports(m, name)])


def reads_the_trace(metrics: List[Dict]) -> bool:
    """Whether any of ``metrics`` is read from the device trace."""
    return any(m["source"] == "device_trace" for m in metrics)


def driver(name: str):
    """The traffic driver ``drivers/<name>.py``."""
    return importlib.import_module(f"hflbench.drivers.{name}")


def metric_reader(name: str, root: Path = ROOT):
    """The ``read(run) -> float | None`` of ``metrics/<name>.py`` (an
    end-to-end or a per-layer metric)."""
    path = root / "hflbench" / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"hflbench.metrics.{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


# -------------------------------------------------------------- trace

class DeviceTrace:
    """``torch.profiler`` over the measured window, CUDA activity only
    (recording the host's activity too makes the trace's reduction take
    tens of seconds on a sweep). The host clock and the trace's clock
    are tied by a marker launched after a synchronise, before the
    window: the first device operation of the trace."""

    def __init__(self, torch):
        self.torch = torch
        self.prof = None
        self.offset_ns = 0

    def __enter__(self):
        torch = self.torch
        from torch.profiler import ProfilerActivity, profile
        self.prof = profile(activities=[ProfilerActivity.CUDA])
        self.prof.__enter__()
        torch.cuda.synchronize()
        self._marker_host = time.perf_counter_ns()
        torch.ones(1, device="cuda").add_(1)
        torch.cuda.synchronize()
        return self

    def __exit__(self, *exc):
        self.prof.__exit__(*exc)
        return False

    def events(self) -> List[Tuple[str, int, int]]:
        """(name, start, end) of every device operation, ns on the host's
        perf_counter clock, in start order."""
        torch = self.torch
        raw = [(e.name(), e.start_ns(), e.start_ns() + e.duration_ns())
               for e in self.prof.profiler.kineto_results.events()
               if e.device_type() == torch.autograd.DeviceType.CUDA
               and e.duration_ns() > 0]
        raw.sort(key=lambda e: e[1])
        if not raw:
            return []
        self.offset_ns = raw[0][1] - self._marker_host
        return [(n, s - self.offset_ns, t - self.offset_ns)
                for n, s, t in raw[1:]]


def busy_intervals(events, lo: int, hi: int) -> List[Tuple[int, int]]:
    """The union of the events' intervals, clipped to [lo, hi]."""
    out: List[List[int]] = []
    for _, s, t in events:
        s, t = max(s, lo), min(t, hi)
        if t <= s:
            continue
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], t)
        else:
            out.append([s, t])
    return [tuple(x) for x in out]


def phase_segments(spans):
    """The host timeline as (start, end, phase) segments, each under the
    innermost recorded phase running then (spans nest)."""
    cuts = sorted({t for _, s, e in spans for t in (s, e)})
    segs = []
    for a, b in zip(cuts, cuts[1:]):
        inner = [(e - s, name) for name, s, e in spans if s <= a and b <= e]
        if inner:
            segs.append((a, b, min(inner)[1]))
    return segs


def phase_at(segs, starts, t: int) -> str:
    """The phase of ``phase_segments`` at host time ``t`` (``starts``:
    the segments' starts)."""
    i = bisect.bisect_right(starts, t) - 1
    if i >= 0 and t <= segs[i][1]:
        return segs[i][2]
    return "harness"


def reduce_trace(events, spans, lo: int, hi: int, top: int = 10) -> Dict:
    """busy_s, window_s and the breakdown of the window [lo, hi]: the
    device operations that took the most time, and the idle time by the
    host phase each gap ended in."""
    busy = busy_intervals(events, lo, hi)
    busy_s = sum(t - s for s, t in busy) / 1e9
    by_op: Dict[str, float] = {}
    for n, s, t in events:
        s, t = max(s, lo), min(t, hi)
        if t > s:
            by_op[n] = by_op.get(n, 0.0) + (t - s) / 1e9
    gaps: Dict[str, float] = {}
    edges = [lo] + [x for iv in busy for x in iv] + [hi]
    segs = phase_segments(spans)
    starts = [g[0] for g in segs]
    for s, t in zip(edges[0::2], edges[1::2]):
        if t > s:
            name = phase_at(segs, starts, t)
            gaps[name] = gaps.get(name, 0.0) + (t - s) / 1e9

    def top_of(d):
        return [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])
                [:top]]

    return {"busy_s": busy_s, "window_s": (hi - lo) / 1e9,
            "breakdown": {"device_ops": top_of(by_op),
                          "idle_gaps": top_of(gaps)}}


# -------------------------------------------------------------- result

def device_info(torch, count: int, peak: int) -> Dict:
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": count, "memory_peak_bytes": int(peak)}


def emit(result: Dict, checks: Dict) -> None:
    """The numbers compared, beside their limits, as the last lines on
    standard error; then the result line, ``checks`` last, as the last
    line on standard output."""
    for name, row in checks.items():
        print(f"check {name} {row['value']!r} limit {row['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps({**result, "checks": checks}))
    sys.stdout.flush()
