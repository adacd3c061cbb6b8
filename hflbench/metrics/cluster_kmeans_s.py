"""cluster_kmeans_s: the K-means restarts of the program's one-off
Algorithm-2 clustering in set-up, where K2 computes the distances
(``HFLFramework.setup_seconds["kmeans"]``: the ``cluster.kmeans``
span's device time between CUDA events). The rest of ``cluster_s`` is
mostly the auxiliary model's training (``setup_seconds["aux_train"]``)."""


def read(run):
    return getattr(run.driver, "setup_seconds", {}).get("kmeans")
