"""k1_roofline_pct: K1 (the masked aggregation, ``csrc/hier_agg.cu``)
against its bytes bound: the bytes its window launches must move (mask,
sizes and updates read once, output written once; ``arith.agg_bytes``)
at 3.35 TB/s, over the device time of those launches in the trace.
Nothing is read unless the trace holds exactly the launches the window's
rounds make."""
from hflbench import arith

NAME = "aggregate_kernel"


def read(run):
    if not run.events:
        return None
    times = [t - s for n, s, t in run.events if NAME in n]
    want = run.driver.window_launches()
    if not times or len(times) != want or run.launches != want:
        return None
    bound_s = run.driver.window_agg_bytes() / arith.PEAK_BYTES_S
    return 100.0 * bound_s / (sum(times) / 1e9)
