"""sweep_aggregate_ms: device milliseconds a round of a fused sweep
dispatch spends in the edge and cloud aggregations (2)/(3), every hop
of every lane: the program's ``aggregate`` spans (device time between
CUDA events on its stream; no host synchronise inside the dispatch)
summed over the window's dispatches, over the rounds they ran."""
from hflbench import spans


def read(run):
    return spans.sweep_phase_ms(run, "aggregate")
