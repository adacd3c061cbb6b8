"""K-means device clustering (Algorithm 2) + Adjusted Rand Index (eq. 28).

Port of ``repro.core.clustering``. With ``use_kernel=True`` every
distance pass (kmeans++ seeding, Lloyd steps, final labels) goes through
``kernels.kmeans_dist`` (the CUDA kernel on a card, its plain version on
the CPU); the inertia that picks the best restart stays on the plain
path, as in the reference.

The reference seeds kmeans++ from ``jax.random``, which torch cannot
reproduce. So the seeding draws come from a ``torch.Generator``, or are
injected: ``init_idx`` gives the row of ``x`` chosen for each centre
(per restart for ``kmeans_best_of``), which lets a test start both
packages from the same centres.
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.kernels.kmeans_dist.ops import pairwise_sq_dists as _kernel


def pairwise_sq_dists(x: torch.Tensor, c: torch.Tensor,
                      use_kernel: bool = False) -> torch.Tensor:
    """x: (N, D), c: (K, D) -> (N, K) squared euclidean distances."""
    if use_kernel:
        return _kernel(x, c)
    xx = torch.sum(x * x, dim=1, keepdim=True)
    cc = torch.sum(c * c, dim=1)[None, :]
    return torch.clamp_min(xx + cc - 2.0 * (x @ c.T), 0.0)


def kmeans_pp_indices(x: torch.Tensor, k: int, generator: torch.Generator,
                      use_kernel: bool = False) -> torch.Tensor:
    """kmeans++ seeding: (k,) row indices of ``x``, each drawn with
    probability proportional to the squared distance to the nearest
    centre chosen so far. Draws use ``generator`` (a CPU generator).
    Like the reference, each pass measures against all k centre slots
    and masks the ones not chosen yet. Once every row lies on a chosen
    centre (k above the number of distinct rows) the rest are row 0,
    as ``jax.random.choice`` picks from an all-zero distribution."""
    n = x.shape[0]
    idx = [int(torch.randint(0, n, (), generator=generator))]
    centers = torch.zeros((k, x.shape[1]), dtype=x.dtype, device=x.device)
    centers[0] = x[idx[0]]
    for i in range(1, k):
        d = pairwise_sq_dists(x, centers, use_kernel=use_kernel)
        mind = torch.min(d[:, :i], dim=1).values
        probs = (mind / torch.clamp_min(torch.sum(mind), 1e-12)).cpu()
        idx.append(int(torch.multinomial(probs.double(), 1,
                                         generator=generator))
                   if bool(probs.sum() > 0) else 0)
        centers[i] = x[idx[i]]
    return torch.tensor(idx, dtype=torch.int64)


def kmeans(x: torch.Tensor, k: int, iters: int = 50, use_kernel: bool = False,
           init_idx: Optional[Sequence[int]] = None,
           generator: Optional[torch.Generator] = None
           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Lloyd's algorithm from kmeans++ centres. Returns (labels (N,),
    centres (k, D)). ``init_idx`` injects the seeding; otherwise it is
    drawn from ``generator``."""
    x = x.float()
    if init_idx is None:
        init_idx = kmeans_pp_indices(x, k, generator, use_kernel)
    centers = x[torch.as_tensor(init_idx, dtype=torch.int64,
                                device=x.device)]
    for _ in range(iters):
        d = pairwise_sq_dists(x, centers, use_kernel=use_kernel)
        lab = torch.argmin(d, dim=1)
        oh = torch.nn.functional.one_hot(lab, k).float()      # (N, k)
        counts = oh.sum(0)
        sums = oh.T @ x
        centers = torch.where(counts[:, None] > 0,
                              sums / torch.clamp_min(counts, 1)[:, None],
                              centers)
    lab = torch.argmin(pairwise_sq_dists(x, centers, use_kernel=use_kernel),
                       dim=1)
    return lab, centers


def kmeans_best_of(x: torch.Tensor, k: int, restarts: int = 8,
                   iters: int = 50, use_kernel: bool = False,
                   init_idx: Optional[Sequence[Sequence[int]]] = None,
                   generator: Optional[torch.Generator] = None):
    """Multiple restarts, keep the lowest inertia. ``init_idx`` (restarts,
    k) injects each restart's seeding."""
    best = (None, None, np.inf)
    for r in range(restarts):
        lab, cen = kmeans(x, k, iters, use_kernel,
                          None if init_idx is None else init_idx[r],
                          generator)
        d = pairwise_sq_dists(x.float(), cen, use_kernel=False)
        inertia = float(torch.sum(torch.min(d, dim=1).values))
        if inertia < best[2]:
            best = (lab, cen, inertia)
    return best[0], best[1]


def adjusted_rand_index(pred: np.ndarray, truth: np.ndarray) -> float:
    """Pair-counting ARI (eq. 28 uses the unadjusted Rand pair counts; we
    report the standard adjusted form as in [42]/sklearn)."""
    pred = np.asarray(pred)
    truth = np.asarray(truth)
    n = len(pred)
    pu, pi = np.unique(pred, return_inverse=True)
    tu, ti = np.unique(truth, return_inverse=True)
    cont = np.zeros((len(pu), len(tu)), dtype=np.int64)
    np.add.at(cont, (pi, ti), 1)

    def c2(v):
        return v * (v - 1) // 2
    sum_ij = c2(cont).sum()
    a = c2(cont.sum(axis=1)).sum()
    b = c2(cont.sum(axis=0)).sum()
    total = c2(n)
    # promote before multiplying: a*b in int64 overflows once pair counts
    # pass ~3e9, i.e. N ~ 1e5
    exp = float(a) * float(b) / float(total) if total else 0.0
    mx = (a + b) / 2.0
    if mx == exp:
        return 1.0
    return float((sum_ij - exp) / (mx - exp))
