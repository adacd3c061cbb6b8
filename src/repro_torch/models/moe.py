"""Mixture-of-Experts MLP with fixed-capacity slot dispatch.

Port of ``repro.models.moe`` on one card (the reference's dispatch
chunks over data shards; on one card it has one chunk, ``gd = 1``).
Plain PyTorch, as the reference is plain ``jnp``:

* fixed capacity C = max(4, ceil(T·k / E)·capacity_factor) per forward
  of T tokens, with token-order priority dropping (GShard/Switch): the
  (T·k) choices, token-major and each token's k choices in descending
  router weight, take the slots of their expert in that order, and those
  past C are dropped;
* the router runs in f32; the top-k weights are renormalised; the
  load-balance aux loss is Switch's E·Σ_e mean(probs_e)·frac(top-1 = e);
* tokens reach an (E, C, D) buffer through a slot table of token
  indices (an empty slot points at an extra zero row), the experts are
  three batched matmuls, and each choice gathers its slot back.

The slot table is built out of place, so ``torch.func.vmap`` of
``grad`` takes it (local training vmaps the gradient over the cohort):
a scatter into an (E+1)·C table where dropped choices all land in row E,
which is then sliced off. The reference's ``.at[].set(mode="drop")`` has
no torch counterpart, and an out-of-range index raises there.
``torch.topk(sorted=True)`` orders each token's k choices as
``lax.top_k`` does (descending; a tie between two router probabilities
has measure zero on real inputs).
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import dense_init
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
    capacity: int            # C


def moe_route(params: Params, xf: torch.Tensor, cfg: ModelConfig
              ) -> Routing:
    """Router, top-k and capacity positions of the (T, D) tokens ``xf``
    of one forward. ``(~keep).sum()`` counts the dropped choices."""
    E, k = cfg.moe.num_experts, cfg.moe.top_k
    T = xf.shape[0]
    C = moe_capacity(T, cfg)
    probs = torch.softmax(xf.float() @ params["router"], dim=-1)
    top_w, top_idx = torch.topk(probs, k, dim=-1, sorted=True)
    top_w = top_w / top_w.sum(dim=-1, keepdim=True)
    flat_e = top_idx.reshape(T * k)
    experts = torch.arange(E, device=xf.device)
    oh = (flat_e[:, None] == experts).to(torch.int32)          # (T·k, E)
    pos_all = torch.cumsum(oh, dim=0) - 1
    pos = torch.take_along_dim(pos_all, flat_e[:, None], dim=1)[:, 0]
    return Routing(probs, top_w, top_idx, pos, pos < C, C)


def moe_apply(params: Params, x: torch.Tensor, cfg: ModelConfig
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (B, S, D) -> (out (B, S, D), aux loss)."""
    E, k = cfg.moe.num_experts, cfg.moe.top_k
    B, S, D = x.shape
    T = B * S
    xf = x.reshape(T, D)
    r = moe_route(params, xf, cfg)
    C = r.capacity

    # ---- load-balance auxiliary loss (Switch eqs. 4-6)
    experts = torch.arange(E, device=x.device)
    me = r.probs.mean(dim=0)
    ce = (r.top_idx[:, :1] == experts).float().mean(dim=0)
    aux = E * torch.sum(me * ce)

    # ---- slot table: slot (e, c) holds its token's index; empty slots
    # point at row T, a zero row; dropped choices land in row E
    flat_e = r.top_idx.reshape(T * k)
    tok = torch.arange(T * k, device=x.device) // k
    slot = torch.where(r.keep, flat_e * C + r.pos, E * C)
    table = torch.full(((E + 1) * C,), T, dtype=torch.int64,
                       device=x.device).scatter(0, slot, tok)
    x_ext = torch.cat([xf, xf.new_zeros((1, D))])
    buf = x_ext[table[:E * C]].reshape(E, C, D)

    # ---- expert compute: three batched matmuls over the experts
    dt = buf.dtype
    g = F.silu(torch.bmm(buf, params["w_gate"].to(dt)))
    u = torch.bmm(buf, params["w_up"].to(dt))
    y = torch.bmm(g * u, params["w_down"].to(dt)).reshape(E * C, D)

    # ---- combine: each choice gathers its slot, dropped ones count 0
    safe_pos = torch.where(r.keep, r.pos, C - 1)
    out_per = y[flat_e * C + safe_pos] * r.keep[:, None].to(dt)
    w_flat = r.top_w.reshape(T * k, 1).to(dt)
    out = (out_per * w_flat).reshape(T, k, D).sum(dim=1)
    return out.reshape(B, S, D), aux
