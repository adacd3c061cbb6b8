"""Algorithm 2 — K-means-based device clustering.

Port of ``repro.core.scheduling.device_clustering``. Every device trains
the auxiliary model (the global model w0 for VKC; the mini model ξ on
1x10x10 crops for IKC) for L local iterations from a common init,
uploads the weights, and the cloud K-means-clusters the weight vectors
into K clusters.

``clustering_cost`` prices Algorithm 2 with the paper's cost model:
every device computes L iterations and uploads ``aux_bits`` once over
its nearest edge, sharing that edge's bandwidth uniformly.
"""
from __future__ import annotations

from typing import Callable, Optional, Sequence, Tuple

import numpy as np
import torch
from torch.func import vmap

from repro_torch import trace
from repro_torch.core import cost_model as cm
from repro_torch.core.clustering import kmeans_best_of
from repro_torch.core.local_train import cohort_local_sgd
from repro_torch.utils import Params, tree_flatten_to_vector


def auxiliary_weight_vectors(apply_fn: Callable, init_params: Params, X, y,
                             mask, L: int, lr: float) -> torch.Tensor:
    """Train the auxiliary model on every device; return (N, P) weights."""
    N = X.shape[0]
    params_per_dev = {k: p[None].expand((N,) + p.shape)
                      for k, p in init_params.items()}
    trained = cohort_local_sgd(apply_fn, params_per_dev, X, y, mask, L, lr)
    return vmap(tree_flatten_to_vector)(trained)


def run_device_clustering(apply_fn: Callable, init_params: Params, X, y,
                          mask, K: int, L: int, lr: float,
                          use_kernel: bool = False,
                          init_idx: Optional[Sequence] = None,
                          generator: Optional[torch.Generator] = None
                          ) -> Tuple[np.ndarray, torch.Tensor]:
    """Algorithm 2. Returns (labels (N,), weight vectors (N, P)).
    ``init_idx`` (8, K) injects each restart's kmeans++ picks; otherwise
    they come from ``generator``. The auxiliary training and the K-means
    are the spans ``cluster.aux_train`` and ``cluster.kmeans`` of the
    current tracer."""
    with trace.span("cluster.aux_train"):
        vecs = auxiliary_weight_vectors(apply_fn, init_params, X, y, mask,
                                        L, lr)
    # standardise features (weights have heterogeneous scales across
    # layers); the population std, as jnp.std computes it
    mu = torch.mean(vecs, dim=0, keepdim=True)
    sd = torch.std(vecs, dim=0, keepdim=True, correction=0) + 1e-8
    with trace.span("cluster.kmeans"):
        labels, _ = kmeans_best_of((vecs - mu) / sd, K, restarts=8,
                                   use_kernel=use_kernel, init_idx=init_idx,
                                   generator=generator)
    return labels.cpu().numpy(), vecs


def clustering_cost(sp: cm.SystemParams, pop: cm.Population,
                    aux_bits: float,
                    compute_scale: float = 1.0) -> Tuple[float, float]:
    """(time delay, energy) of Algorithm 2 under the cost model.

    All N devices compute L iterations over their D_n samples at f_max
    and upload ``aux_bits`` once via the nearest edge, sharing its
    bandwidth uniformly among the devices that pick it. ``compute_scale``
    scales the per-sample CPU cycles to the auxiliary model's size.
    """
    M = pop.g.shape[1]
    nearest = torch.argmax(pop.g, dim=1)                      # (N,)
    counts = torch.bincount(nearest, minlength=M)
    b = pop.B_m[nearest] / torch.clamp_min(counts[nearest], 1)
    g_near = torch.amax(pop.g, dim=1)                         # g[n, nearest]
    u_aux = pop.u * float(np.float32(compute_scale))
    aux = float(np.float32(aux_bits))
    t_c = cm.t_cmp(sp, u_aux, pop.D, pop.f_max)               # L iterations
    e_c = cm.e_cmp(sp, u_aux, pop.D, pop.f_max)
    t_x = cm.t_com(sp, b, g_near, pop.p, model_bits=aux)
    e_x = cm.e_com(sp, b, g_near, pop.p, model_bits=aux)
    return float(torch.max(t_c + t_x)), float(torch.sum(e_c + e_x))
