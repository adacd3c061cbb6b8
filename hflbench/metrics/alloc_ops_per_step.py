"""alloc_ops_per_step: device operations one Adam step of the allocator
(problem (27)) launches. The program's ``allocate`` span launches a
marker kernel (``spin_kernel``, from ``torch.cuda._sleep``) at its start
and at its end on its stream, so in the device trace the operations
between a pair of markers are the ones the span issued, however late
the device ran them. Their sum over the window's rounds is steps x k
plus the few operations around the loop (the solve's set-up and final
iterate, the pricing), fewer than a solve's steps; the metric is k, the
whole part of the sum over the window's ``alloc.steps``. Nothing is
read without a trace, unless the markers pair up with the window's
``allocate`` spans, or unless every solve ran the configuration's
``alloc_steps`` steps."""
from hflbench import spans

MARKER = "spin_kernel"


def read(run):
    traces = spans.window_traces(run)
    steps = spans.solver_steps(run, traces)
    if not steps or not run.events:
        return None
    at = [i for i, (name, _, _) in enumerate(run.events) if MARKER in name]
    n_spans = sum(s["name"] == "allocate" for t in traces for s in t["spans"])
    if not n_spans or len(at) != 2 * n_spans:
        return None
    ops = sum(hi - lo - 1 for lo, hi in zip(at[0::2], at[1::2]))
    return ops // steps
