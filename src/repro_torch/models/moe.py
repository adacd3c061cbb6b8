"""Mixture-of-Experts MLP with fixed-capacity slot dispatch.

Port of ``repro.models.moe``, plain PyTorch, as the reference is plain
``jnp``:

* the dispatch runs in ``gd = sharder.data_chunks`` chunks of T/gd
  consecutive tokens (the data shards of a mesh; one chunk under
  ``NOOP``), each with its own capacity, as the reference's;
* fixed capacity C = max(4, ceil(Tl·k / E)·capacity_factor) per chunk
  of Tl tokens, with token-order priority dropping (GShard/Switch): a
  chunk's (Tl·k) choices, token-major and each token's k choices in
  descending router weight, take the slots of their expert in that
  order, and those past C are dropped;
* the router runs in f32; the top-k weights are renormalised; the
  load-balance aux loss is Switch's E·Σ_e mean(probs_e)·frac(top-1 = e);
* each chunk's tokens reach its (E, C, D) slots of a (gd, E, C, D)
  buffer through the chunk's own slot table of token rows (an empty
  slot points at an extra zero row), the experts are the reference's
  per-(chunk, expert) einsums, and each choice gathers its slot back
  from its own chunk. Under a mesh the chunks are split over the batch
  axes and each rank dispatches and combines only its own.

The slot table is built out of place, so ``torch.func.vmap`` of
``grad`` takes it (local training vmaps the gradient over the cohort):
a scatter into (E+1)·C slots a chunk where dropped choices all land in
the last row, which is then sliced off. The reference's
``.at[].set(mode="drop")`` has no torch counterpart, and an out-of-range
index raises there.
``torch.topk(sorted=True)`` orders each token's k choices as
``lax.top_k`` does (descending; a tie between two router probabilities
has measure zero on real inputs).
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import dense_init
from repro_torch.parallel.sharder import NOOP, Sharder
from repro_torch.parallel.sharding import P, batch_axes, fit_spec, placements
from repro_torch.utils import Params


def moe_init(generator: torch.Generator, cfg: ModelConfig, device="cuda",
             dtype=torch.float32, stack=()) -> Params:
    """Router (D, E) in f32 and E stacked SwiGLU experts, each He-normal
    over its own fan-in; ``stack`` prepends a layer axis."""
    D, Fd, E = cfg.d_model, cfg.d_ff, cfg.moe.num_experts
    experts = (*stack, E)
    return {
        "router": dense_init(generator, D, E, device, torch.float32, stack),
        "w_gate": dense_init(generator, D, Fd, device, dtype, experts),
        "w_up": dense_init(generator, D, Fd, device, dtype, experts),
        "w_down": dense_init(generator, Fd, D, device, dtype, experts),
    }


def moe_capacity(n_tokens: int, cfg: ModelConfig) -> int:
    m = cfg.moe
    c = -(-n_tokens * m.top_k // m.num_experts)
    return max(4, int(c * m.capacity_factor))


class Routing(NamedTuple):
    probs: torch.Tensor      # (T, E) f32 router probabilities
    top_w: torch.Tensor      # (T, k) renormalised weights
    top_idx: torch.Tensor    # (T, k) experts, descending weight
    pos: torch.Tensor        # (T·k,) slot of each choice in its expert
    keep: torch.Tensor       # (T·k,) bool: the choice got a slot
    capacity: int            # C, a chunk's slots an expert


def moe_route(params: Params, xf: torch.Tensor, cfg: ModelConfig,
              gd: int = 1) -> Routing:
    """Router, top-k and capacity positions of the (T, D) tokens ``xf``
    of one forward, dispatched in ``gd`` chunks of T/gd consecutive
    tokens: each chunk fills its own capacity C = ``moe_capacity(T/gd)``
    of every expert, and ``pos`` counts within the chunk.
    ``(~keep).sum()`` counts the dropped choices."""
    E, k = cfg.moe.num_experts, cfg.moe.top_k
    T = xf.shape[0]
    C = moe_capacity(T // gd, cfg)
    probs = torch.softmax(xf.float() @ params["router"], dim=-1)
    top_w, top_idx = torch.topk(probs, k, dim=-1, sorted=True)
    top_w = top_w / top_w.sum(dim=-1, keepdim=True)
    flat_e = top_idx.reshape(gd, T // gd * k)
    experts = torch.arange(E, device=xf.device)
    oh = (flat_e[..., None] == experts).to(torch.int32)      # (gd, Tl·k, E)
    pos_all = torch.cumsum(oh, dim=1) - 1
    pos = torch.take_along_dim(pos_all, flat_e[..., None],
                               dim=2)[..., 0].reshape(T * k)
    return Routing(probs, top_w, top_idx, pos, pos < C, C)


def _expert_matmul(h, w, fn=None):
    """(gd, E, C, a) x (E, a, b) -> (gd, E, C, b): each chunk's slots of
    expert e times expert e's weight (the reference's ``gecd,edf->gecf``
    einsum), then ``fn``. DTensors run it on each rank's local block
    through ``local_map``: the buffer's (chunk, expert) block and the
    weight's expert block, whole along its other dimensions (gathered,
    as FSDP gathers a weight at use); the weight's gradient comes back
    partial over the mesh dimensions that split the chunks (whole where
    the buffer is replicated) and is reduced to its placements.
    (DTensor's own propagation of the einsum fails in the backward, at a
    view of a strided local block.)"""
    def local(h, w):
        out = torch.einsum("gecd,edf->gecf", h, w)
        return out if fn is None else fn(out)

    if not isinstance(h, DTensor):
        return local(h, w)
    from torch.distributed.tensor.experimental import local_map

    mesh = h.device_mesh
    w_pl = [Shard(0) if p.is_shard(1) else Replicate() for p in h.placements]
    w_grad = [Shard(0) if p.is_shard(1) else Partial() if p.is_shard(0)
              else Replicate() for p in h.placements]
    if any(p.is_shard() and not p.is_shard(0) and not p.is_shard(1)
           for p in h.placements):
        raise ValueError(f"expert buffer split along {h.placements}: only "
                         "chunks (dim 0) and experts (dim 1) may be split")
    w = w.redistribute(mesh, w_pl)
    return local_map(local, out_placements=list(h.placements),
                     in_placements=(h.placements, w_pl),
                     in_grad_placements=(h.placements, w_grad),
                     device_mesh=mesh)(h, w)


def _per_chunk(fn, *xs):
    """``fn(*xs)`` on tensors whose dim 0 is the dispatch chunks. Under a
    mesh each rank runs it through ``local_map`` on its own chunks: every
    input is split along dim 0 over the batch axes, as the chunks are,
    and whole along the rest (an expert dim split over ``model`` is
    gathered over ``model`` alone), so no token or slot crosses a data
    shard; the output and the gradients are split the same way. (DTensor's
    own propagation of these gathers fails in the backward on torch
    2.11.)"""
    if not isinstance(xs[0], DTensor):
        return fn(*xs)
    from torch.distributed.tensor.experimental import local_map

    mesh = xs[0].device_mesh
    split = list(placements(mesh, fit_spec(mesh, xs[0].shape[:1],
                                           P(batch_axes(mesh)))))
    return local_map(fn, out_placements=split,
                     in_placements=(split,) * len(xs),
                     device_mesh=mesh, redistribute_inputs=True)(*xs)


def _take_rows(table, idx):
    """table (g, R, D), idx (g, n) -> (g, n, D): row idx[j] of each
    chunk's own table."""
    return torch.take_along_dim(table, idx[..., None], dim=1)


def moe_apply(params: Params, x: torch.Tensor, cfg: ModelConfig, *,
              sharder: Sharder = NOOP) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (B, S, D) -> (out (B, S, D), aux loss).

    The dispatch is chunked by ``sharder.data_chunks`` (gd, the data
    shards of a mesh; 1 under ``NOOP``), as the reference's: each chunk
    of Tl = T/gd consecutive tokens fills its own capacity from its own
    tokens, and the (gd, E, C, D) expert buffer is placed by
    ``moe_buffer`` (chunks over the batch axes, experts over ``model``).
    If gd does not divide T the dispatch runs as one chunk."""
    E, k = cfg.moe.num_experts, cfg.moe.top_k
    B, S, D = x.shape
    T = B * S
    gd = sharder.data_chunks
    if T % gd != 0 or T // gd < 1:
        gd = 1
    Tl = T // gd
    xf = x.reshape(T, D)
    r = moe_route(params, xf, cfg, gd)
    C = r.capacity

    # ---- load-balance auxiliary loss (Switch eqs. 4-6)
    experts = torch.arange(E, device=x.device)
    me = r.probs.mean(dim=0)
    ce = (r.top_idx[:, :1] == experts).float().mean(dim=0)
    aux = E * torch.sum(me * ce)

    flat_e = r.top_idx.reshape(gd, Tl * k)
    keep = r.keep.reshape(gd, Tl * k)
    pos = r.pos.reshape(gd, Tl * k)

    def dispatch(flat_e, pos, keep, x_ext):
        # slot (e, c) of a chunk holds its token's row in the chunk; empty
        # slots point at row Tl, a zero row; dropped choices land past the
        # table, in a last row sliced off
        g = flat_e.shape[0]
        tok = (torch.arange(Tl * k, device=flat_e.device) // k).expand(g, -1)
        slot = torch.where(keep, flat_e * C + pos, E * C)
        table = torch.full((g, (E + 1) * C), Tl, dtype=torch.int64,
                           device=flat_e.device).scatter(1, slot, tok)
        return _take_rows(x_ext, table[:, :E * C])

    xg = xf.reshape(gd, Tl, D)
    x_ext = torch.cat([xg, xg.new_zeros((gd, 1, D))], dim=1)
    buf = _per_chunk(dispatch, flat_e, pos, keep, x_ext)
    buf = sharder.act(buf.reshape(gd, E, C, D), "moe_buffer")

    # ---- expert compute: the reference's per-(chunk, expert) einsums (E
    # over `model`, gd over the batch axes under a mesh)
    dt = buf.dtype

    def w(name):
        return params[name].to(dt)

    g = sharder.act(_expert_matmul(buf, w("w_gate"), F.silu), "moe_hidden")
    u = sharder.act(_expert_matmul(buf, w("w_up")), "moe_hidden")
    y = sharder.act(_expert_matmul(g * u, w("w_down")), "moe_buffer")

    # ---- combine: each choice gathers its slot in its chunk, dropped ones
    # count 0
    def combine(y, flat_e, pos, keep, top_w):
        safe_pos = torch.where(keep, pos, C - 1)
        out = _take_rows(y.reshape(y.shape[0], E * C, D), flat_e * C + safe_pos)
        out = out * keep[..., None].to(dt) * top_w[..., None].to(dt)
        return out.reshape(-1, Tl, k, D).sum(dim=2)

    out = _per_chunk(combine, y, flat_e, pos, keep,
                     r.top_w.reshape(gd, Tl * k))
    return out.reshape(B, S, D), aux
