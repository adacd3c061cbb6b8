"""rounds_per_s: the global rounds the window completed (a sweep counts
lane-rounds: S lanes finishing a round count S) over the wall time of
those rounds, host clock; each unit of work ends in the program's own
synchronise."""


def read(run):
    return run.work / sum(run.walls)
