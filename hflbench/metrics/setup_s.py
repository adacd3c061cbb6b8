"""setup_s: from the start of the run to the start of the window:
imports, the kernels' build where missing, the world, the program's
set-up and one warm-up unit of work, host clock."""


def read(run):
    return run.setup_s
