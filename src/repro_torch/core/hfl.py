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

The body is lane-batched (``hfl_global_iteration_lanes``): S independent
worlds train as one cohort of S·H devices and each hop aggregates every
lane and leaf in one call, which is the reference's
``vmap(hfl_global_iteration_core)`` in its sweep. The reference jits the
single-world core under a second name, ``hfl_global_iteration`` (its
sequential engine's entry); PyTorch runs eagerly, so both engines here
call ``hfl_global_iteration_core``, the S=1 lane.
"""
from __future__ import annotations

from typing import Callable, Optional, Sequence

import numpy as np
import torch

from repro_torch import trace
from repro_torch.core import compression as comp
from repro_torch.core.local_train import cohort_local_sgd
from repro_torch.data.partition import FederatedData
from repro_torch.kernels.hier_agg.ops import (
    masked_aggregate_leaves_batched, masked_decode_aggregate_leaves_batched)
from repro_torch.utils import Params, resolve_device


def pad_device_data(fed: FederatedData, Dmax: Optional[int] = None,
                    device="cuda"):
    """-> X (N, Dmax, ...) in the source dtype, y (N, Dmax) int64,
    mask (N, Dmax) f32, all on ``device``. ``Dmax`` defaults to the
    largest device dataset; a smaller one truncates (the sweep pads every
    world to one ``Dmax``)."""
    dev = resolve_device(device)
    N = fed.n_devices
    Dmax = Dmax or int(max(len(y) for y in fed.y))
    sample_shape = fed.X[0].shape[1:]
    X = np.zeros((N, Dmax, *sample_shape), fed.X[0].dtype)
    y = np.zeros((N, Dmax), np.int64)
    mask = np.zeros((N, Dmax), np.float32)
    for n in range(N):
        d = min(len(fed.y[n]), Dmax)
        X[n, :d] = fed.X[n][:d]
        y[n, :d] = fed.y[n][:d]
        mask[n, :d] = 1.0
    return (torch.from_numpy(X).to(dev), torch.from_numpy(y).to(dev),
            torch.from_numpy(mask).to(dev))


def hfl_global_iteration_lanes(apply_fn: Callable, global_params: Params, X,
                               y, mask, sizes, assign, *, M: int, L: int,
                               Q: int, lr: float, agg_kernel: bool = False,
                               codec: Optional[comp.CompressionConfig] = None,
                               dev_resid: Optional[Params] = None,
                               edge_resid: Optional[Params] = None,
                               noise: Optional[
                                   Sequence[comp.NoiseSource]] = None):
    """Algorithm 1 for S independent lanes at once (the sweep's lane
    batch; :func:`hfl_global_iteration_core` is its S=1 case).

    global_params: leaves (S, ...); X/y/mask: (S, H, Dmax, ...); sizes:
    (S, H) D_n; assign: (S, H) int64 edge ids. Training folds the lanes
    into the device axis: each of the S·H devices pulls its own lane's
    edge model and one vmapped ``cohort_local_sgd`` runs over all of
    them. Each edge hop (2) and the cloud hop (3) is one grouped call
    over every lane and leaf: with ``agg_kernel`` the ``hier_agg``
    masked aggregation (one launch a hop on a card), otherwise a
    per-lane ``torch.bmm`` against the normalised panel (the oracle).
    Each hop's training is a ``train`` span (attribute ``hop``) and each
    aggregation an ``aggregate`` span of the current tracer
    (``repro_torch.trace``).

    With an active ``codec`` both uplinks are compressed: devices encode
    their post-SGD delta against the edge model they pulled and edges
    add the aggregated decoded deltas (``edge' = edge + Σ w·decode(q)``,
    eq. (2) exactly for a lossless codec; an empty edge gets zero weight
    mass and keeps its model). After Q edge iterations each edge encodes
    its delta against the global model for the cloud hop (3).
    ``dev_resid`` ((S, H, ...), gathered for the cohort) and
    ``edge_resid`` ((S, M, ...)) are the error-feedback residuals;
    ``noise`` holds one int8 noise source per lane, each giving the
    rounding uniforms of its lane's rows per (hop, leaf). Encoding counts
    as ``aggregate`` time. Returns ``(new_params, new_dev_resid,
    new_edge_resid)`` in this mode; without a codec (``None`` or
    ``"none"``) the uncompressed path and its single return value.
    """
    compress = codec is not None and codec.active
    S, H = sizes.shape
    dev = assign.device
    onehot = (assign[:, None, :]
              == torch.arange(M, device=dev)[None, :, None]).float()
    w_dev = sizes.float()                                      # (S, H) D_n
    edge_tot = (onehot * w_dev[:, None, :]).sum(2)             # (S, M)
    has_dev = edge_tot > 0
    lanes = torch.arange(S, device=dev)[:, None]

    # Each aggregation takes the (S, rows, P_i) leaves of one hop, in the
    # params' order, and returns their (S, M, P_i) or (S, P_i) results.
    if agg_kernel:
        # eq. (3) = the same kernel with an all-ones (1, M) mask over the
        # per-edge cohort sizes D_{N_m} (empty edges weigh 0 already)
        ones = torch.ones((S, 1, M), dtype=torch.float32, device=dev)

        def edge_aggregate(flats):
            return masked_aggregate_leaves_batched(onehot, w_dev, flats)

        def cloud_aggregate(flats):
            return [o[:, 0] for o in masked_aggregate_leaves_batched(
                ones, edge_tot, flats)]

        # compressed path: the scales fold into the kernel's panel and
        # the wire-format q is read undecoded
        def edge_dec_aggregate(scs, qs):
            return masked_decode_aggregate_leaves_batched(onehot, w_dev, scs,
                                                          qs)

        def cloud_dec_aggregate(scs, qs):
            return [o[:, 0] for o in masked_decode_aggregate_leaves_batched(
                ones, edge_tot, scs, qs)]
    else:
        w_edge = (onehot * w_dev[:, None, :]) \
            / torch.clamp_min(edge_tot, 1.0)[..., None]        # (S, M, H)
        w_cloud = torch.where(has_dev, edge_tot, 0.0)
        w_cloud = (w_cloud / torch.clamp_min(
            torch.sum(w_cloud, dim=1, keepdim=True), 1.0))[:, None, :]

        def edge_aggregate(flats):
            return [torch.bmm(w_edge, flat) for flat in flats]

        def cloud_aggregate(flats):
            return [torch.bmm(w_cloud, flat)[:, 0] for flat in flats]

        # dense decode, then the matmul: the oracle of the kernel path
        def decoded(sc, q):
            return comp.decode_rows(
                codec, q.reshape(-1, q.shape[-1]), sc.reshape(-1)
            ).reshape(q.shape)

        def edge_dec_aggregate(scs, qs):
            return [torch.bmm(w_edge, decoded(sc, q))
                    for sc, q in zip(scs, qs)]

        def cloud_dec_aggregate(scs, qs):
            return [torch.bmm(w_cloud, decoded(sc, q))[:, 0]
                    for sc, q in zip(scs, qs)]

    def encode(hop, name, d, r):
        """Encode (S, rows, p) deltas with residuals r: each lane's rows
        with its own noise. Returns q (S, rows, p), scales (S, rows) and
        the new residuals (S, rows, p)."""
        rows = d.shape[1]
        u = None
        if codec.codec == "int8":
            if noise is None or len(noise) != S:
                raise ValueError("the int8 codec needs one noise source a "
                                 "lane")
            u = torch.cat([src(hop, name, (rows, d.shape[2]))
                           for src in noise])
        q, sc, nr = comp.encode_leaf(codec, d.reshape(S * rows, -1),
                                     r.reshape(S * rows, -1), u)
        return (q.reshape(d.shape), sc.reshape(S, rows),
                nr.reshape(d.shape))

    if compress:
        dev_resid = dict(dev_resid)          # the caller's dict stays as is

    # edge models start from the global model
    edge_params = {k: g[:, None].expand((S, M) + g.shape[1:])
                   for k, g in global_params.items()}
    for hop in range(Q):
        with trace.span("train", hop=hop):
            # each device pulls its lane's edge model
            pulled = {k: e[lanes, assign] for k, e in edge_params.items()}
            dev_params = cohort_local_sgd(
                apply_fn, {k: v.reshape((S * H,) + v.shape[2:])
                           for k, v in pulled.items()},
                X.reshape((S * H,) + X.shape[2:]),
                y.reshape((S * H,) + y.shape[2:]),
                mask.reshape((S * H,) + mask.shape[2:]), L, lr)
        with trace.span("aggregate", hop=hop):
            names = list(dev_params)
            if compress:
                # (2) in delta space, on the decoded uplinks: every leaf
                # is encoded, then one aggregation takes them all
                qs, scs = [], []
                for k in names:
                    d = (dev_params[k].reshape(S, H, -1)
                         - pulled[k].reshape(S, H, -1)).float()
                    q, sc, nr = encode(hop, k, d,
                                       dev_resid[k].reshape(S, H, -1))
                    dev_resid[k] = nr.reshape(dev_resid[k].shape)
                    qs.append(q)
                    scs.append(sc)
                aggs = edge_dec_aggregate(scs, qs)
                new_edge = {}
                for k, agg in zip(names, aggs):
                    old = edge_params[k]
                    new = old.reshape(S, M, -1) + agg
                    new_edge[k] = new.reshape(old.shape).to(old.dtype)
            else:
                # (2): weighted average per edge; empty edges keep their
                # model
                aggs = edge_aggregate([dev_params[k].reshape(S, H, -1)
                                       for k in names])
                new_edge = {}
                for k, agg in zip(names, aggs):
                    old = edge_params[k]
                    keep = has_dev.reshape((S, M) + (1,) * (old.dim() - 2))
                    new_edge[k] = torch.where(keep, agg.reshape(old.shape),
                                              old).to(old.dtype)
            edge_params = new_edge

    # (3): cloud aggregation, weights D_{N_m} (empty edges weigh 0)
    with trace.span("aggregate", hop=Q):
        names = list(edge_params)
        if not compress:
            aggs = cloud_aggregate([edge_params[k].reshape(S, M, -1)
                                    for k in names])
            return {k: agg.reshape(global_params[k].shape)
                    .to(edge_params[k].dtype) for k, agg in zip(names, aggs)}
        qs, scs, new_edge_resid = [], [], {}
        for k in names:
            g = global_params[k]
            d = (edge_params[k].reshape(S, M, -1)
                 - g.reshape(S, 1, -1)).float()
            q, sc, nr = encode(Q, k, d, edge_resid[k].reshape(S, M, -1))
            new_edge_resid[k] = nr.reshape(edge_resid[k].shape)
            qs.append(q)
            scs.append(sc)
        aggs = cloud_dec_aggregate(scs, qs)
        new_global = {}
        for k, agg in zip(names, aggs):
            g = global_params[k]
            new_global[k] = (g.reshape(S, -1) + agg).reshape(g.shape).to(
                g.dtype)
        return new_global, dev_resid, new_edge_resid


def hfl_global_iteration_core(apply_fn: Callable, global_params: Params, X,
                              y, mask, sizes, assign, *, M: int, L: int,
                              Q: int, lr: float, agg_kernel: bool = False,
                              codec: Optional[comp.CompressionConfig] = None,
                              dev_resid: Optional[Params] = None,
                              edge_resid: Optional[Params] = None,
                              noise: Optional[comp.NoiseSource] = None):
    """Algorithm 1 on one scheduled cohort; returns new global params:
    the S=1 lane of :func:`hfl_global_iteration_lanes`.

    X/y/mask: (H, Dmax, ...); sizes: (H,) D_n; assign: (H,) int64 edge
    ids; with a codec ``dev_resid`` (H, ...), ``edge_resid`` (M, ...) and
    ``noise`` the round's int8 noise source, and the return value
    ``(new_params, new_dev_resid, new_edge_resid)``.
    """
    def lane(tree):
        return None if tree is None else {k: v[None] for k, v in tree.items()}

    def unlane(tree):
        return {k: v[0] for k, v in tree.items()}

    out = hfl_global_iteration_lanes(
        apply_fn, lane(global_params), X[None], y[None], mask[None],
        sizes[None], assign[None], M=M, L=L, Q=Q, lr=lr,
        agg_kernel=agg_kernel, codec=codec, dev_resid=lane(dev_resid),
        edge_resid=lane(edge_resid),
        noise=None if noise is None else [noise])
    if codec is not None and codec.active:
        return tuple(unlane(t) for t in out)
    return unlane(out)


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
