"""alloc_step_us: device microseconds one Adam step of the allocator
(problem (27)) takes: the program's ``allocate`` spans over the window
(device time between CUDA events on its stream; the solve's set-up,
its final iterate and the round's pricing included) over the steps the
program counted (``alloc.steps``). Nothing is read unless every solve
ran the configuration's ``alloc_steps`` steps."""
from hflbench import spans


def read(run):
    traces = spans.window_traces(run)
    steps = spans.solver_steps(run, traces)
    if not steps:
        return None
    return 1e3 * spans.span_ms(traces, "allocate") / steps
