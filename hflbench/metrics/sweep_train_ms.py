"""sweep_train_ms: device milliseconds a round of a fused sweep
dispatch spends in Algorithm 1's local training, every hop of every
lane: the program's ``train`` spans (device time between CUDA events on
its stream; no host synchronise inside the dispatch) summed over the
window's dispatches, over the rounds they ran."""
from hflbench import spans


def read(run):
    return spans.sweep_phase_ms(run, "train")
