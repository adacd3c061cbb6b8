"""eval_ms: wall milliseconds a round in the program's ``eval`` phase
(its round records' ``seconds["eval"]``, host clock, each phase ending
in a device synchronise), the mean over the window's rounds."""
from hflbench.metrics import phase_ms


def read(run):
    return phase_ms(run, "eval")
