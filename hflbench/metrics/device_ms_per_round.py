"""device_ms_per_round: the device time a round of the window takes: the
union of the device operations' intervals in the window's trace (every
operation of the window's rounds, each round ending in the program's own
synchronise) over the rounds completed, in ms. The cell's runs record
the trace in the untraced mode too, for this metric."""


def read(run):
    if run.trace is None or run.work <= 0:
        return None
    return 1e3 * run.trace["busy_s"] / run.work
