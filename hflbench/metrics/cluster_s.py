"""cluster_s: the program's one-off Algorithm-2 clustering in set-up
(``HFLFramework.setup_seconds["cluster"]``: host clock, ending in a
device synchronise); K2 computes its distances."""


def read(run):
    return getattr(run.driver, "setup_seconds", {}).get("cluster")
