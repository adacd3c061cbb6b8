"""Core layer primitives (functional: params are plain dicts of tensors).

Port of ``repro.models.layers``: He/Kaiming and embedding inits,
RMSNorm, split-half RoPE, the SwiGLU MLP and the depthwise causal
convolution of the Mamba-2 block.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
from torch.distributed.tensor import DTensor, Replicate

from repro_torch.utils import Params, resolve_device


def he_normal(generator: torch.Generator, shape, fan_in=None,
              device="cuda", dtype=torch.float32) -> torch.Tensor:
    """He/Kaiming init [41]. Drawn on the CPU from ``generator`` and then
    moved to ``device`` (``"cpu"`` only when asked), so a seed gives the
    same weights on every device."""
    if fan_in is None:
        fan_in = shape[0] if len(shape) >= 2 else shape[-1]
    std = math.sqrt(2.0 / fan_in)
    w = torch.randn(shape, generator=generator, dtype=torch.float32) * std
    return w.to(device=resolve_device(device), dtype=dtype)


def _normal(generator: torch.Generator, shape, std: float, device,
            dtype) -> torch.Tensor:
    """N(0, std²) drawn where ``generator`` lives (on the card for a CUDA
    generator, so full-width weights never pass through host memory),
    then moved to ``device``. On the ``meta`` device nothing is drawn
    (no generator lives there): the result has the shape and dtype
    alone."""
    device = resolve_device(device)
    if device.type == "meta":
        return torch.empty(shape, dtype=dtype, device=device)
    w = torch.randn(shape, generator=generator, device=generator.device,
                    dtype=torch.float32).mul_(std)
    return w.to(device=device, dtype=dtype)


def dense_init(generator: torch.Generator, d_in: int, d_out: int,
               device="cuda", dtype=torch.float32, stack=()) -> torch.Tensor:
    """He-normal (d_in, d_out) weight; ``stack`` prepends a layer axis."""
    return _normal(generator, (*stack, d_in, d_out), math.sqrt(2.0 / d_in),
                   device, dtype)


def embed_init(generator: torch.Generator, vocab: int, d_model: int,
               device="cuda", dtype=torch.float32) -> torch.Tensor:
    return _normal(generator, (vocab, d_model), 0.02, device, dtype)


def split_heads(t: torch.Tensor, n: int, d: int) -> torch.Tensor:
    """(..., n·d) -> (..., n, d). A DTensor whose last dimension is split
    over a mesh dimension that does not divide n is first made whole
    along that mesh dimension: DTensor cannot unflatten an uneven split
    (its propagation may split a projection's output however it likes,
    e.g. 3 KV heads over 2 ranks)."""
    if isinstance(t, DTensor):
        pls = [Replicate() if p.is_shard(t.ndim - 1)
               and n % t.device_mesh.size(i) else p
               for i, p in enumerate(t.placements)]
        if pls != list(t.placements):
            t = t.redistribute(t.device_mesh, pls)
    return t.reshape(*t.shape[:-1], n, d)


def rows_local(fn, rows, table, whole: bool):
    """``fn(rows, table)`` on each rank's local block through
    ``local_map``, for what DTensor's propagation mishandles (a lookup in
    a table split over its vocabulary, index backwards on batch-split
    rows; torch 2.11 and 2.13 differ in which): ``rows`` keeps its split
    of the batch (dim 0) and the output is split as ``rows``. ``table``
    is taken whole on every rank
    (``whole``: gathered, as FSDP gathers a weight at use; its gradient
    comes back partial over the mesh dimensions that split the rows) or
    split as ``rows`` (a per-row table: logits)."""
    from torch.distributed.tensor import Partial, Shard
    from torch.distributed.tensor.experimental import local_map

    mesh = rows.device_mesh
    split = [Shard(0) if p.is_shard(0) else Replicate()
             for p in rows.placements]
    tab = [Replicate()] * mesh.ndim if whole else split
    grad = [Partial() if p.is_shard() else p for p in split] if whole \
        else split
    return local_map(fn, out_placements=split, in_placements=(split, tab),
                     in_grad_placements=(split, grad), device_mesh=mesh,
                     redistribute_inputs=True)(rows, table)


# ---------------------------------------------------------------- RMSNorm

def rmsnorm_init(d: int, device="cuda", stack=()) -> Params:
    return {"scale": torch.ones((*stack, d), dtype=torch.float32,
                                device=resolve_device(device))}


def rmsnorm(params: Params, x: torch.Tensor, eps: float = 1e-5
            ) -> torch.Tensor:
    """RMS norm computed in f32, cast back to x's dtype."""
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * params["scale"]).to(x.dtype)


# ------------------------------------------------------------------ RoPE

def rope_freqs(head_dim: int, theta: float, positions: torch.Tensor):
    """positions (...,) -> cos, sin of shape (..., head_dim // 2), in f32
    (positions are cast to f32 first, as the reference does)."""
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32,
                        device=positions.device) / head_dim
    inv = 1.0 / torch.pow(theta, exps)
    ang = positions.float()[..., None] * inv
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor
               ) -> torch.Tensor:
    """Split-half (not interleaved) rotation in f32. x: (B, S, H, hd);
    cos/sin: (B, S, hd//2) or (S, hd//2)."""
    xf = x.float()
    x1, x2 = xf.chunk(2, dim=-1)
    if cos.dim() == 2:               # (S, hd//2) -> broadcast over batch
        cos, sin = cos[None, :, None, :], sin[None, :, None, :]
    else:                            # (B, S, hd//2)
        cos, sin = cos[:, :, None, :], sin[:, :, None, :]
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------- SwiGLU

def mlp_init(generator: torch.Generator, d_model: int, d_ff: int,
             device="cuda", dtype=torch.float32, stack=()) -> Params:
    return {
        "w_gate": dense_init(generator, d_model, d_ff, device, dtype, stack),
        "w_up": dense_init(generator, d_model, d_ff, device, dtype, stack),
        "w_down": dense_init(generator, d_ff, d_model, device, dtype, stack),
    }


def mlp_apply(params: Params, x: torch.Tensor) -> torch.Tensor:
    g = torch.nn.functional.silu(x @ params["w_gate"])
    u = x @ params["w_up"]
    return (g * u) @ params["w_down"]


# ---------------------------------------------------- depthwise causal conv

def causal_conv1d(x: torch.Tensor, w: torch.Tensor,
                  state: Optional[torch.Tensor] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Depthwise causal conv. x: (B, S, C), w: (C, W).

    ``state`` (B, W-1, C), the last W-1 inputs of the stream so far,
    runs it in streaming mode (decode); without it the sequence starts
    from zeros. Returns (y (B, S, C), new_state (B, W-1, C)).
    """
    B, S, C = x.shape
    W = w.shape[1]
    pad = (torch.zeros((B, W - 1, C), dtype=x.dtype, device=x.device)
           if state is None else state.to(x.dtype))
    xp = torch.cat([pad, x], dim=1)             # (B, S+W-1, C)
    # y[t] = sum_j w[:, j] * xp[t+j], in the reference's order of j
    ys = xp[:, 0:S] * w[:, 0]
    for j in range(1, W):
        ys = ys + xp[:, j:j + S] * w[:, j]
    return ys, xp[:, S:]
