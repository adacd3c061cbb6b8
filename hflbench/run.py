"""Run one cell of the benchmark and print its result line.

    python3 hflbench/run.py --workload NAME --seed N --seconds S --trace 0|1

from the root of a checkout. Set-up (imports, the kernels' build when
missing, the world, the program's set-up and one warm-up unit of work)
is timed as ``setup_s``; the window then runs whole units of work back
to back until ``--seconds`` have passed. ``--trace 1`` records the
device trace of the window and reports the cell's per-layer metrics
instead of its end-to-end ones; a cell whose end-to-end metrics read
the device trace records it in every run on the card. After the window
the program's state is freed and the reference judges what the program
produced; the numbers compared are printed beside their limits, and the
last line of standard output is the result as JSON.
"""
import time

_T0 = time.perf_counter()

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
import types  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent


def _environment():
    """Caches inside the checkout, at fixed paths; the program's source
    and this package on the path; no JAX for any library that asks."""
    cache = ROOT / "build" / "hflbench-cache"
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(cache / "torch_ext"))
    os.environ.setdefault("TRITON_CACHE_DIR", str(cache / "triton"))
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"
    for p in (str(ROOT / "src"), str(ROOT)):
        if p not in sys.path:
            sys.path.insert(0, p)


def parse(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = parse(argv)
    _environment()
    from hflbench import harness
    cell = harness.find_cell(args.workload)

    import torch
    found = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if found < cell.chips:
        print(f"hflbench: {args.workload} needs {cell.chips} CUDA device(s);"
              f" found {found}", file=sys.stderr)
        return 2
    return measure(cell, args.seed, args.seconds, bool(args.trace),
                   torch.device("cuda"), _T0)


def measure(cell, seed: int, seconds: float, trace: bool, device,
            t_start: float) -> int:
    """Set up, measure, judge and print one run of ``cell``. Also the
    entry of the tests, on the CPU (no trace there)."""
    import torch
    from hflbench import check, harness
    from hflbench.drivers import program
    tf32 = cell.cfg["precision"] == "tf32"
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    torch.set_num_threads(4)
    on_card = device.type == "cuda"
    stages = [("imports", time.perf_counter() - t_start)]
    if on_card:
        from repro_torch.kernels import build
        t = time.perf_counter()
        build.build()
        stages.append(("kernel build", time.perf_counter() - t))

    drv = harness.driver(cell.traffic["driver"]).Driver(cell, seed, device)
    drv.setup()
    if on_card:
        torch.cuda.synchronize()
    setup_s = time.perf_counter() - t_start
    for name, sec in stages + drv.stages:
        print(f"setup {name} {sec:.3f} s", file=sys.stderr)

    setup_peak = torch.cuda.max_memory_allocated() if on_card else 0
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    launches0 = program.aggregation_launches()
    # the device trace runs in every traced run, and on the card in each
    # run of a cell whose end-to-end metrics read it
    traced = trace or (on_card and harness.reads_the_trace(cell.end_to_end))
    tracer = harness.DeviceTrace(torch) if traced else None
    if tracer:
        tracer.__enter__()
    w0 = time.perf_counter_ns()
    work = drv.run(seconds)
    w1 = time.perf_counter_ns()
    if tracer:
        tracer.__exit__(None, None, None)
    window_peak = torch.cuda.max_memory_allocated() if on_card else 0
    launches = program.aggregation_launches() - launches0

    # what the per-layer metric readers read
    run = types.SimpleNamespace(
        cell=cell, driver=drv, work=work, walls=list(drv.walls),
        window_s=(w1 - w0) / 1e9, setup_s=setup_s, window_peak=window_peak,
        launches=launches, events=None, trace=None)
    if tracer:
        events = tracer.events()
        run.events = [e for e in events if e[2] > w0 and e[1] < w1]
        run.trace = harness.reduce_trace(run.events, drv.rec.spans, w0, w1)
        del tracer
        print(f"trace {len(run.events)} device operations read in "
              f"{(time.perf_counter_ns() - w1) / 1e9:.3f} s", file=sys.stderr)

    drv.release()
    if on_card:
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
    t = time.perf_counter()
    lim = check.limits(cell.name)
    numbers, rows = drv.judge()
    bad = check.failed(numbers, rows, lim)
    print(f"check {time.perf_counter() - t:.3f} s, run "
          f"{time.perf_counter() - t_start:.3f} s", file=sys.stderr)
    correct, checks = check.verdict(numbers, lim)

    metrics = {}
    for m in cell.per_layer if trace else cell.end_to_end:
        value = harness.metric_reader(m["name"])(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}

    found = harness.forbidden_modules(sys.modules)
    if found:
        print("hflbench: loaded in the measured process: "
              + ", ".join(found), file=sys.stderr)
        return 3
    result = {"correct": bool(correct and not bad),
              "attempted": len(drv.lanes),
              "failed": len(bad),
              "metrics": metrics,
              "device": (harness.device_info(torch, cell.chips,
                                             max(setup_peak, window_peak))
                         if on_card else {"platform": "cpu", "count": 1}),
              }
    if trace:
        result["device"]["busy_s"] = run.trace["busy_s"]
        result["device"]["window_s"] = run.trace["window_s"]
        result["breakdown"] = run.trace["breakdown"]
    harness.emit(result, checks)
    return 0


if __name__ == "__main__":
    sys.exit(main())
