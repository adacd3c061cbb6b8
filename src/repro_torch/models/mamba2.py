"""Mamba-2 block (SSD, state-space duality, arXiv:2405.21060).

Port of ``repro.models.mamba2``, plain PyTorch (the reference's SSD is
plain ``jnp`` too; no kernel of the reference backs it):

* ``ssd_chunked``: the blocked SSD of the train/prefill path. The
  intra-chunk quadratic term and the per-chunk terminal states are
  einsums over all chunks at once; a Python loop over the chunks takes
  the place of the reference's ``lax.scan`` for the inter-chunk
  recurrence.
* ``ssd_recurrent_step``: the O(1)-state one-token decode update.
* ``ssd_reference``: the per-timestep recurrence (the oracle).

The intra-chunk decay ``L[i, j] = exp(cum[i] - cum[j])`` for ``i >= j``
is computed as ``exp(where(causal, diff, -inf))``; the reference writes
``where(causal, exp(diff), 0)``. The forward values are the same, but
the upper triangle holds exp of positive sums (tens at chunk 256 and
full width), and under ``grad`` the reference's form multiplies a zero
cotangent by that exponential, which gives NaN once it overflows; here
the masked entries are exp(-inf) = 0 with a zero gradient.

Layout conventions (as the reference):
  x        (B, S, H, P)      P = head_dim
  dt       (B, S, H)
  A_log    (H,)              A = -exp(A_log) (scalar per head, SSD)
  B_, C_   (B, S, G, N)      N = d_state, G groups broadcast to heads
  state    (B, H, P, N)
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import (_normal, causal_conv1d, dense_init,
                                       rmsnorm, rmsnorm_init, split_heads)
from repro_torch.parallel.sharder import NOOP, Sharder
from repro_torch.utils import Params, resolve_device


# --------------------------------------------------------------- params

def mamba2_init(generator: torch.Generator, cfg: ModelConfig, device="cuda",
                dtype=torch.float32, stack=()) -> Params:
    """Per-segment z/x/B/C/dt projections (the reference's layout: the
    depthwise conv distributes over the [x | B | C] concatenation, so the
    math is that of one fused in_proj). ``stack`` prepends a layer
    axis."""
    s = cfg.ssm
    D = cfg.d_model
    di = s.d_inner(D)
    nh = s.n_heads(D)
    gn = s.n_groups * s.d_state
    dev = resolve_device(device)

    def dense(a, b):
        return dense_init(generator, a, b, dev, dtype, stack)

    def conv(c):
        return _normal(generator, (*stack, c, s.conv_width), 0.1, dev, dtype)

    def full(v):
        return torch.full((*stack, nh), v, dtype=torch.float32, device=dev)

    return {
        "wz": dense(D, di), "wx": dense(D, di), "wb": dense(D, gn),
        "wc": dense(D, gn), "wdt": dense(D, nh),
        "conv_x": conv(di), "conv_b": conv(gn), "conv_c": conv(gn),
        "A_log": full(0.0),                  # A = -1 at init
        "D_skip": full(1.0),
        "dt_bias": full(-1.0),               # softplus(-1) ~ 0.31
        "gate_norm": rmsnorm_init(di, dev, stack),
        "out_proj": dense(di, D),
    }


def _project(params: Params, hidden: torch.Tensor):
    """hidden @ {wz, wx, wb, wc, wdt} -> (z, x, B_, C_, dt)."""
    return tuple(hidden @ params[k].to(hidden.dtype)
                 for k in ("wz", "wx", "wb", "wc", "wdt"))


# ----------------------------------------------------------- SSD math

def _heads(t: torch.Tensor, H: int, axis: int) -> torch.Tensor:
    """Broadcast the G groups of B_/C_ to the H heads (jnp.repeat)."""
    return t.repeat_interleave(H // t.shape[axis], dim=axis)


def ssd_reference(x, dt, A, B_, C_) -> torch.Tensor:
    """Per-timestep recurrence (the oracle), in f32. Shapes as the module
    docstring; returns (B, S, H, P)."""
    Bsz, S, H, P = x.shape
    N = B_.shape[-1]
    f32 = torch.float32
    Bh, Ch = _heads(B_, H, 2).to(f32), _heads(C_, H, 2).to(f32)
    dA = torch.exp(dt * A).to(f32)
    x, dt = x.to(f32), dt.to(f32)
    state = torch.zeros((Bsz, H, P, N), dtype=f32, device=x.device)
    ys = []
    for t in range(S):
        state = (dA[:, t, :, None, None] * state
                 + (dt[:, t, :, None, None] * x[:, t, ..., None])
                 * Bh[:, t, :, None, :])
        ys.append(torch.einsum("bhpn,bhn->bhp", state, Ch[:, t]))
    return torch.stack(ys, dim=1)


def ssd_chunked(x, dt, A, B_, C_, chunk: int,
                sharder: Sharder = NOOP) -> torch.Tensor:
    """Blocked SSD. Returns (B, S, H, P) in f32; S must be a multiple of
    ``chunk``. Under a mesh every chunked intermediate is placed by its
    ``ssm_chunk_*`` rule (heads over ``model``), as in the reference."""
    Bsz, S, H, P = x.shape
    N = B_.shape[3]
    if S % chunk:
        raise ValueError(f"sequence length {S} is not a multiple of the "
                         f"SSD chunk {chunk}")
    nc, cs = S // chunk, chunk
    f32 = torch.float32
    xr = sharder.act(x.reshape(Bsz, nc, cs, H, P).to(f32), "ssm_chunk_x")
    dtr = dt.reshape(Bsz, nc, cs, H).to(f32)
    Br = _heads(B_, H, 2).reshape(Bsz, nc, cs, H, N).to(f32)
    Cr = _heads(C_, H, 2).reshape(Bsz, nc, cs, H, N).to(f32)
    Br = sharder.act(Br, "ssm_chunk_bc")
    Cr = sharder.act(Cr, "ssm_chunk_bc")

    cum = torch.cumsum(dtr * A, dim=2)              # inclusive log-decay
    cum = sharder.act(cum, "ssm_chunk_cum")
    xdt = xr * dtr[..., None]

    # ---- intra-chunk (quadratic within a chunk): i attends to j <= i
    diff = cum[:, :, :, None, :] - cum[:, :, None, :, :]    # (B,nc,i,j,H)
    li = torch.arange(cs, device=x.device)
    causal = (li[:, None] >= li[None, :])[None, None, :, :, None]
    L = sharder.act(torch.exp(torch.where(causal, diff, float("-inf"))),
                    "ssm_chunk_ij")
    del diff
    scores = torch.einsum("bcihn,bcjhn->bcijh", Cr, Br) * L
    scores = sharder.act(scores, "ssm_chunk_ij")
    del L
    y_intra = torch.einsum("bcijh,bcjhp->bcihp", scores, xdt)
    del scores

    # ---- per-chunk terminal states: sum_j exp(cum[last]-cum[j]) B_j (x dt)_j
    decay_to_end = torch.exp(cum[:, :, -1:, :] - cum)       # (B,nc,cs,H)
    states = torch.einsum("bcjh,bcjhn,bcjhp->bchpn", decay_to_end, Br, xdt)

    # ---- inter-chunk recurrence: the state before each chunk
    chunk_decay = torch.exp(cum[:, :, -1, :])               # (B,nc,H)
    carry = torch.zeros((Bsz, H, P, N), dtype=f32, device=x.device)
    prev = []
    for c in range(nc):
        prev.append(carry)
        carry = chunk_decay[:, c, :, None, None] * carry + states[:, c]
    prev_states = torch.stack(prev, dim=1)                  # (B,nc,H,P,N)

    # ---- inter-chunk contribution: y[i] += exp(cum[i]) C_i . state_prev
    y_inter = torch.einsum("bcih,bcihn,bchpn->bcihp", torch.exp(cum), Cr,
                           prev_states)
    return (y_intra + y_inter).reshape(Bsz, S, H, P)


def _head_block(x, hdim: int):
    """For DTensor x split over batch rows (dim 0) and heads (dim hdim):
    (x's placements keeping those two splits, the first head of this
    rank's block, the placements of the rows' split alone)."""
    mesh = x.device_mesh
    pl = tuple(p if p.is_shard(0) or p.is_shard(hdim) else Replicate()
               for p in x.placements)
    coord, h0, n = mesh.get_coordinate(), 0, x.shape[hdim]
    for i, p in enumerate(pl):
        if p.is_shard(hdim):
            n //= mesh.size(i)
            h0 += coord[i] * n
    rows = tuple(Shard(0) if p.is_shard(0) else Replicate() for p in pl)
    return pl, h0, rows


def _ssd_local(x, dt, A, B_, C_, chunk: int):
    """``ssd_chunked`` of DTensor inputs on each rank's local (batch rows,
    heads) block, through ``local_map``: the SSD is independent per batch
    row and head, and that block is the layout every ``ssm_chunk_*``
    rule names (batch over the batch axes, heads over ``model``). x's
    placements (``ssm_heads``) set the blocks: dt takes x's, A and the
    B_/C_ groups are taken whole (rows split as x's) and each rank picks
    the heads' entries and groups of its block. Their gradients come back
    partial over the mesh dimensions that split the block. (DTensor's own
    propagation of the SSD's einsums fails in the backward, at a view of
    a strided local block.)"""
    from torch.distributed.tensor.experimental import local_map

    mesh = x.device_mesh
    x_pl, h0, rows = _head_block(x, 2)
    H, G = x.shape[2], B_.shape[2]
    whole = [Replicate()] * mesh.ndim
    split = [Partial() if p.is_shard() else Replicate() for p in x_pl]
    bc_grad = [Shard(0) if p.is_shard(0) else Partial() if p.is_shard()
               else Replicate() for p in x_pl]

    def local(xl, dtl, Al, Bl, Cl):
        heads = torch.arange(h0, h0 + xl.shape[2], device=xl.device)
        grp = heads // (H // G)
        return ssd_chunked(xl, dtl, Al[heads], Bl[:, :, grp], Cl[:, :, grp],
                           chunk)

    return local_map(local, out_placements=list(x_pl),
                     in_placements=(x_pl, x_pl, whole, rows, rows),
                     in_grad_placements=(x_pl, x_pl, split, bc_grad,
                                         bc_grad),
                     device_mesh=mesh, redistribute_inputs=True)(
        x, dt, A, B_, C_)


def _ssd_step_local(state, x, dt, A, B_, C_):
    """``ssd_recurrent_step`` of DTensor inputs on each rank's (batch
    rows, heads) block of the state (``cache_specs``: heads over
    ``model``), through ``local_map``, as :func:`_ssd_local` (a decode
    step: no gradient)."""
    from torch.distributed.tensor.experimental import local_map

    mesh = state.device_mesh
    st_pl, h0, rows = _head_block(state, 1)
    H, G = state.shape[1], B_.shape[1]

    def local(sl, xl, dtl, Al, Bl, Cl):
        heads = torch.arange(h0, h0 + sl.shape[1], device=sl.device)
        grp = heads // (H // G)
        return ssd_recurrent_step(sl, xl, dtl, Al[heads], Bl[:, grp],
                                  Cl[:, grp])

    return local_map(local, out_placements=(list(st_pl), list(st_pl)),
                     in_placements=(st_pl, st_pl, st_pl,
                                    [Replicate()] * mesh.ndim, rows, rows),
                     device_mesh=mesh, redistribute_inputs=True)(
        state, x, dt, A, B_, C_)


def ssd_recurrent_step(state, x, dt, A, B_, C_):
    """One-token update. x (B, H, P), dt (B, H), B_/C_ (B, G, N), state
    (B, H, P, N) -> (new state, y (B, H, P))."""
    H = x.shape[1]
    # the groups widen to the state's f32, as jnp promotes them
    Bh = _heads(B_, H, 1).to(state.dtype)
    Ch = _heads(C_, H, 1).to(state.dtype)
    dA = torch.exp(dt * A)
    state = (dA[..., None, None] * state
             + (dt[..., None, None] * x[..., None]) * Bh[:, :, None, :])
    return state, torch.einsum("bhpn,bhn->bhp", state, Ch)


# ------------------------------------------------------------ full block

def init_ssm_cache(cfg: ModelConfig, batch: int, dtype, device="cuda",
                   stack=()) -> Params:
    """The SSD state (f32) and one rolling conv state over the [x|B|C]
    stream (``dtype``); ``stack`` prepends a layer axis."""
    s = cfg.ssm
    di = s.d_inner(cfg.d_model)
    conv_dim = di + 2 * s.n_groups * s.d_state
    return {
        "ssm": torch.zeros((*stack, batch, s.n_heads(cfg.d_model),
                            s.head_dim, s.d_state), dtype=torch.float32,
                           device=device),
        "conv": torch.zeros((*stack, batch, s.conv_width - 1, conv_dim),
                            dtype=dtype, device=device),
    }


def _gate_out(params: Params, y: torch.Tensor, z: torch.Tensor
              ) -> torch.Tensor:
    y = rmsnorm(params["gate_norm"], y * F.silu(z))
    return y @ params["out_proj"].to(y.dtype)


def mamba2_forward(params: Params, hidden: torch.Tensor, cfg: ModelConfig,
                   *, sharder: Sharder = NOOP) -> torch.Tensor:
    """Full-sequence forward. hidden: (B, S, D)."""
    s = cfg.ssm
    B, S, D = hidden.shape
    di, nh = s.d_inner(D), s.n_heads(D)
    z, x, B_, C_, dt = _project(params, hidden)
    x, _ = causal_conv1d(F.silu(x), params["conv_x"].to(x.dtype))
    B_, _ = causal_conv1d(F.silu(B_), params["conv_b"].to(x.dtype))
    C_, _ = causal_conv1d(F.silu(C_), params["conv_c"].to(x.dtype))
    x = sharder.act(split_heads(x, nh, s.head_dim), "ssm_heads")
    B_ = split_heads(B_, s.n_groups, s.d_state)
    C_ = split_heads(C_, s.n_groups, s.d_state)
    dt = F.softplus(dt.float() + params["dt_bias"])
    A = -torch.exp(params["A_log"])
    if isinstance(x, DTensor):
        y = _ssd_local(x, dt, A, B_, C_, min(s.chunk, S))
    else:
        y = ssd_chunked(x, dt, A, B_, C_, min(s.chunk, S), sharder)
    y = y + params["D_skip"][None, None, :, None] * x.float()
    out = _gate_out(params, y.reshape(B, S, di).to(hidden.dtype), z)
    return sharder.act(out, "act_resid")


def mamba2_decode(params: Params, hidden: torch.Tensor, cache: Params,
                  cfg: ModelConfig, *, sharder: Sharder = NOOP
                  ) -> Tuple[torch.Tensor, Dict]:
    """One-token decode. hidden: (B, 1, D); returns (out, new cache)."""
    s = cfg.ssm
    B, _, D = hidden.shape
    di, nh = s.d_inner(D), s.n_heads(D)
    gn = s.n_groups * s.d_state
    z, x, B_, C_, dt = _project(params, hidden)
    st_x, st_b, st_c = torch.split(cache["conv"], [di, gn, gn], dim=-1)
    x, st_x = causal_conv1d(F.silu(x), params["conv_x"].to(x.dtype), st_x)
    B_, st_b = causal_conv1d(F.silu(B_), params["conv_b"].to(x.dtype), st_b)
    C_, st_c = causal_conv1d(F.silu(C_), params["conv_c"].to(x.dtype), st_c)
    conv_state = torch.cat([st_x, st_b, st_c], dim=-1)
    x = split_heads(x[:, 0], nh, s.head_dim)
    B_ = split_heads(B_[:, 0], s.n_groups, s.d_state)
    C_ = split_heads(C_[:, 0], s.n_groups, s.d_state)
    dt1 = F.softplus(dt[:, 0].float() + params["dt_bias"])
    A = -torch.exp(params["A_log"])
    step = (_ssd_step_local if isinstance(cache["ssm"], DTensor)
            else ssd_recurrent_step)
    state, y = step(cache["ssm"], x.float(), dt1, A, B_, C_)
    y = y + params["D_skip"][None, :, None] * x.float()
    out = _gate_out(params, y.reshape(B, 1, di).to(hidden.dtype), z)
    return sharder.act(out, "act_resid"), {"ssm": state, "conv": conv_state}
