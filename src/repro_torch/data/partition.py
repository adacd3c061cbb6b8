"""Non-IID federated partitioning (majority-class skew, paper §IV-A).

A numpy copy of ``repro.data.partition``: same draw order, same arrays.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import numpy as np


@dataclasses.dataclass
class FederatedData:
    """Per-device datasets + ground-truth majority classes (for ARI)."""
    X: List[np.ndarray]
    y: List[np.ndarray]
    majority_class: np.ndarray        # (N,) int — clustering ground truth
    X_test: np.ndarray
    y_test: np.ndarray
    n_classes: int

    @property
    def n_devices(self) -> int:
        return len(self.X)

    @property
    def sizes(self) -> np.ndarray:
        return np.array([len(y) for y in self.y])


def partition_noniid(X: np.ndarray, y: np.ndarray, X_test, y_test,
                     n_devices: int, size_range: Tuple[int, int],
                     majority_frac: float = 0.8, n_classes: int = 10,
                     seed: int = 0,
                     majority_assignment: Optional[np.ndarray] = None
                     ) -> FederatedData:
    """Each device n holds D_n ~ U[size_range] samples, `majority_frac` of
    which come from a single majority class (round-robin over classes so
    every class has ~N/K majority devices), the rest drawn uniformly."""
    rng = np.random.default_rng(seed)
    by_class = [np.flatnonzero(y == c) for c in range(n_classes)]
    if majority_assignment is None:
        majority_assignment = np.arange(n_devices) % n_classes
        rng.shuffle(majority_assignment)
    Xs, ys = [], []
    for n in range(n_devices):
        D_n = int(rng.integers(size_range[0], size_range[1] + 1))
        c = int(majority_assignment[n])
        n_major = int(round(majority_frac * D_n))
        idx_major = rng.choice(by_class[c], n_major, replace=True)
        idx_rest = rng.integers(0, len(y), D_n - n_major)
        idx = np.concatenate([idx_major, idx_rest])
        rng.shuffle(idx)
        Xs.append(X[idx])
        ys.append(y[idx])
    return FederatedData(Xs, ys, majority_assignment.astype(np.int32),
                         X_test, y_test, n_classes)
