"""HFL training orchestration — Algorithm 1 (one global iteration) and the
hierarchical aggregation equations (2)-(3), plus test evaluation.

Port of ``repro.core.hfl``. At global iteration i the scheduled cohort is
partitioned over M edge servers. Each of Q edge iterations runs L local
full-batch GD steps per device from that device's *edge* model, then
data-size-weighted edge aggregation (2). After Q edge iterations the
cloud aggregates the edge models weighted by their cohort data sizes (3).

Aggregation has two backends selected by ``agg_kernel``: a masked matmul
against the assignment one-hot, leaf by leaf (the parity oracle), or the
``kernels/hier_agg`` masked aggregation, which builds the normalised
(M, H) weight panel from the one-hot and the device sizes itself and
takes every leaf of a hop in one call (one CUDA launch on a card, its
plain version on the CPU). Both share the
empty-edge keep (edges with no devices keep their model) and give empty
edges zero cloud weight. With an uplink codec both uplinks ship encoded
deltas, and ``agg_kernel`` selects between the masked decode-aggregate
kernel and a dense decode followed by the matmul.

The reference jits the core under a second name, ``hfl_global_iteration``
(its sequential engine's entry); PyTorch runs eagerly, so both engines
here call ``hfl_global_iteration_core``.
"""
from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.core import compression as comp
from repro_torch.core.local_train import cohort_local_sgd
from repro_torch.data.partition import FederatedData
from repro_torch.kernels.hier_agg.ops import (
    masked_aggregate_leaves, masked_decode_aggregate_leaves)
from repro_torch.utils import Params, Stopwatch, phase, resolve_device


def pad_device_data(fed: FederatedData, device="cuda"):
    """-> X (N, Dmax, ...) in the source dtype, y (N, Dmax) int64,
    mask (N, Dmax) f32, all on ``device``."""
    dev = resolve_device(device)
    N = fed.n_devices
    Dmax = int(max(len(y) for y in fed.y))
    sample_shape = fed.X[0].shape[1:]
    X = np.zeros((N, Dmax, *sample_shape), fed.X[0].dtype)
    y = np.zeros((N, Dmax), np.int64)
    mask = np.zeros((N, Dmax), np.float32)
    for n in range(N):
        d = len(fed.y[n])
        X[n, :d] = fed.X[n][:d]
        y[n, :d] = fed.y[n][:d]
        mask[n, :d] = 1.0
    return (torch.from_numpy(X).to(dev), torch.from_numpy(y).to(dev),
            torch.from_numpy(mask).to(dev))


def hfl_global_iteration_core(apply_fn: Callable, global_params: Params, X,
                              y, mask, sizes, assign, *, M: int, L: int,
                              Q: int, lr: float, agg_kernel: bool = False,
                              codec: Optional[comp.CompressionConfig] = None,
                              dev_resid: Optional[Params] = None,
                              edge_resid: Optional[Params] = None,
                              noise: Optional[comp.NoiseSource] = None,
                              stopwatch: Optional[Stopwatch] = None):
    """Algorithm 1 on the scheduled cohort; returns new global params.

    X/y/mask: (H, Dmax, ...); sizes: (H,) D_n; assign: (H,) int64 edge
    ids. ``agg_kernel=True`` routes eqs. (2)-(3) through
    ``kernels.hier_agg`` (the one-hot and sizes go in raw). A
    ``stopwatch`` splits the time into "train" and "aggregate".

    With an active ``codec`` both uplinks are compressed: devices encode
    their post-SGD delta against the edge model they pulled and edges
    add the aggregated decoded deltas (``edge' = edge + Σ w·decode(q)``,
    eq. (2) exactly for a lossless codec; an empty edge gets zero weight
    mass and keeps its model). After Q edge iterations each edge encodes
    its delta against the global model for the cloud hop (3).
    ``dev_resid`` ((H, ...), gathered for the cohort) and ``edge_resid``
    ((M, ...)) are the error-feedback residuals; ``noise`` gives the
    int8 rounding uniforms per (hop, leaf). Encoding counts as
    "aggregate" time. Returns ``(new_params, new_dev_resid,
    new_edge_resid)`` in this mode; without a codec (``None`` or
    ``"none"``) the uncompressed path and its single return value.
    """
    compress = codec is not None and codec.active
    H = sizes.shape[0]
    onehot = F.one_hot(assign, M).float()                      # (H, M)
    w_dev = sizes.float()                                      # D_n
    edge_tot = onehot.T @ w_dev                                # (M,) D_{N_m}
    has_dev = edge_tot > 0

    # Each aggregation takes the (rows, P_i) leaves of one hop, in the
    # params' order, and returns their (M, P_i) or (P_i,) results.
    if agg_kernel:
        mask_edge = onehot.T.contiguous()

        def edge_aggregate(flats):
            return masked_aggregate_leaves(mask_edge, w_dev, flats)

        # eq. (3) = the same kernel with an all-ones (1, M) mask over the
        # per-edge cohort sizes D_{N_m} (empty edges weigh 0 already)
        ones = torch.ones((1, M), dtype=torch.float32, device=w_dev.device)

        def cloud_aggregate(flats):
            return [o[0] for o in masked_aggregate_leaves(ones, edge_tot,
                                                          flats)]

        # compressed path: the scales fold into the kernel's panel and
        # the wire-format q is read undecoded
        def edge_dec_aggregate(scs, qs):
            return masked_decode_aggregate_leaves(mask_edge, w_dev, scs, qs)

        def cloud_dec_aggregate(scs, qs):
            return [o[0] for o in masked_decode_aggregate_leaves(
                ones, edge_tot, scs, qs)]
    else:
        w_edge = (onehot.T * w_dev[None, :]) \
            / torch.clamp_min(edge_tot, 1.0)[:, None]          # (M, H)
        w_cloud = torch.where(has_dev, edge_tot, 0.0)
        w_cloud = w_cloud / torch.clamp_min(torch.sum(w_cloud), 1.0)

        def edge_aggregate(flats):
            return [w_edge @ flat for flat in flats]

        def cloud_aggregate(flats):
            return [w_cloud @ flat for flat in flats]

        # dense decode, then the matmul: the oracle of the kernel path
        def edge_dec_aggregate(scs, qs):
            return [w_edge @ comp.decode_rows(codec, q, sc)
                    for sc, q in zip(scs, qs)]

        def cloud_dec_aggregate(scs, qs):
            return [w_cloud @ comp.decode_rows(codec, q, sc)
                    for sc, q in zip(scs, qs)]

    def encode(hop, name, d, r):
        u = (noise(hop, name, tuple(d.shape)) if codec.codec == "int8"
             else None)
        return comp.encode_leaf(codec, d, r, u)

    if compress:
        dev_resid = dict(dev_resid)          # the caller's dict stays as is

    # edge models start from the global model
    edge_params = {k: g[None].expand((M,) + g.shape)
                   for k, g in global_params.items()}
    for hop in range(Q):
        with phase(stopwatch, "train"):
            # each device pulls its edge's model
            pulled = {k: e[assign] for k, e in edge_params.items()}
            dev_params = cohort_local_sgd(apply_fn, pulled, X, y, mask, L,
                                          lr)
        with phase(stopwatch, "aggregate"):
            names = list(dev_params)
            if compress:
                # (2) in delta space, on the decoded uplinks: every leaf
                # is encoded, then one aggregation takes them all
                qs, scs = [], []
                for k in names:
                    d = (dev_params[k] - pulled[k]).reshape(H, -1).float()
                    q, sc, nr = encode(hop, k, d, dev_resid[k].reshape(H, -1))
                    dev_resid[k] = nr.reshape(dev_resid[k].shape)
                    qs.append(q)
                    scs.append(sc)
                aggs = edge_dec_aggregate(scs, qs)
                new_edge = {}
                for k, agg in zip(names, aggs):
                    old = edge_params[k]
                    new = old.reshape(M, -1) + agg
                    new_edge[k] = new.reshape(old.shape).to(old.dtype)
            else:
                # (2): weighted average per edge; empty edges keep their
                # model
                aggs = edge_aggregate([dev_params[k].reshape(H, -1)
                                       for k in names])
                new_edge = {}
                for k, agg in zip(names, aggs):
                    old = edge_params[k]
                    keep = has_dev.reshape((M,) + (1,) * (old.dim() - 1))
                    new_edge[k] = torch.where(keep, agg.reshape(old.shape),
                                              old).to(old.dtype)
            edge_params = new_edge

    # (3): cloud aggregation, weights D_{N_m} (empty edges weigh 0)
    with phase(stopwatch, "aggregate"):
        names = list(edge_params)
        if not compress:
            aggs = cloud_aggregate([edge_params[k].reshape(M, -1)
                                    for k in names])
            return {k: agg.reshape(edge_params[k].shape[1:])
                    .to(edge_params[k].dtype) for k, agg in zip(names, aggs)}
        qs, scs, new_edge_resid = [], [], {}
        for k in names:
            g = global_params[k]
            d = (edge_params[k].reshape(M, -1) - g.reshape(1, -1)).float()
            q, sc, nr = encode(Q, k, d, edge_resid[k].reshape(M, -1))
            new_edge_resid[k] = nr.reshape(edge_resid[k].shape)
            qs.append(q)
            scs.append(sc)
        aggs = cloud_dec_aggregate(scs, qs)
        new_global = {}
        for k, agg in zip(names, aggs):
            g = global_params[k]
            new_global[k] = (g.reshape(-1) + agg).reshape(g.shape).to(g.dtype)
        return new_global, dev_resid, new_edge_resid


@torch.no_grad()
def _count_correct(apply_fn: Callable, params: Params, X, y, valid) -> int:
    """Correct predictions among rows where ``valid > 0`` (exact int)."""
    hit = (torch.argmax(apply_fn(params, X), dim=-1) == y) & (valid > 0)
    return int(hit.sum())


def evaluate_in_batches(apply_fn: Callable, params: Params, X_test, y_test,
                        batch: int = 512) -> float:
    """Test accuracy in batches of ``batch`` samples on the params'
    device. The ragged tail is padded to the batch shape with a validity
    mask and correct answers are counted as integers, so the result is
    the exact sample-weighted accuracy."""
    X_test = np.asarray(X_test)
    y_test = np.asarray(y_test)
    n = len(y_test)
    if n == 0:
        return 0.0
    dev = next(iter(params.values())).device
    batch = min(batch, n)
    correct = 0
    for i in range(0, n, batch):
        Xc, yc = X_test[i:i + batch], y_test[i:i + batch]
        k = len(yc)
        valid = np.zeros(batch, np.float32)
        valid[:k] = 1.0
        if k < batch:       # pad the ragged tail to the chunk shape
            Xc = np.concatenate(
                [Xc, np.zeros((batch - k, *Xc.shape[1:]), Xc.dtype)])
            yc = np.concatenate([yc, np.zeros(batch - k, yc.dtype)])
        correct += _count_correct(
            apply_fn, params, torch.from_numpy(Xc).to(dev),
            torch.from_numpy(yc.astype(np.int64)).to(dev),
            torch.from_numpy(valid).to(dev))
    return correct / n
