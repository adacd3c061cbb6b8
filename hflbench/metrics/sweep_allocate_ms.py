"""sweep_allocate_ms: device milliseconds a round of a fused sweep
dispatch spends in the allocator (problem (27)) over every lane's
edges: the program's ``allocate`` spans (device time between CUDA
events on its stream; no host synchronise inside the dispatch) summed
over the window's dispatches, over the rounds they ran."""
from hflbench import spans


def read(run):
    return spans.sweep_phase_ms(run, "allocate")
