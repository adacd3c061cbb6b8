"""schedule_ms: wall milliseconds a round in the program's ``schedule`` phase
(its round records' ``seconds["schedule"]``, host clock, each phase ending
in a device synchronise), the mean over the window's rounds."""
from hflbench.metrics import phase_ms


def read(run):
    return phase_ms(run, "schedule")
