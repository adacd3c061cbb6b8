"""Grouped-query attention with RoPE, full/sliding-window masks, KV cache.

Port of ``repro.models.attention``, with the reference's ``sharder``
hooks at the same points (``NOOP`` by default; a ``MeshSharder`` moves
the DTensors of a mesh-sharded step, ``repro_torch.launch.steps``):

* train/prefill forward, causal or banded-causal (sliding window);
* one-token decode against a full or rolling (sliding-window) KV cache;
* GQA with any ``n_kv_heads`` dividing ``n_heads``.

``impl`` names the attention of the full-sequence forward: ``"plain"``
(the reference's ``"xla"``: materialised scores, the default) or
``"kernel"`` (the reference's ``"pallas"``: the flash-attention
dispatcher of ``repro_torch.kernels.flash_attention.ops``, which
launches the CUDA kernel on CUDA tensors and takes its plain version on
CPU tensors). The kernel is forward only, so ``"kernel"`` raises under
grad mode on inputs that require grad, on every device. Decode always
runs the plain ``_sdpa`` on the cache, as in the reference.

Under a mesh (DTensor q/k/v) the attention itself, plain or kernel,
runs on each rank's local block through ``local_map``
(:func:`_per_rank`): attention is independent per (batch row, q head),
``act_heads`` splits q heads over ``model`` in contiguous blocks, and
each rank takes the K/V heads its block reads. That block is the layout
``attn_scores_heads`` names; under ``tp_strategy="feature"`` (no head
split) each rank computes its rows' scores whole, where the reference
splits them over the kv sequence (``attn_scores_seq``): the same values.
The kernel sees only local tensors, which DTensor's propagation cannot
see through, and DTensor's own propagation of the score einsums fails
on torch 2.11 at real splits.
"""
from __future__ import annotations

import math
from typing import Tuple

import torch
from torch.distributed.tensor import DTensor

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.flash_attention import ops as fa
from repro_torch.models.layers import (apply_rope, dense_init, rope_freqs,
                                       split_heads)
from repro_torch.parallel.sharder import NOOP, Sharder
from repro_torch.utils import Params

NEG_INF = -1e30
IMPLS = ("plain", "kernel")
CHUNK_Q_THRESHOLD = 8192   # chunk queries above this sequence length
CHUNK_Q = 2048


def attn_init(generator: torch.Generator, cfg: ModelConfig, device="cuda",
              dtype=torch.float32, stack=()) -> Params:
    D, hd = cfg.d_model, cfg.hd
    return {
        "wq": dense_init(generator, D, cfg.n_heads * hd, device, dtype, stack),
        "wk": dense_init(generator, D, cfg.n_kv_heads * hd, device, dtype,
                         stack),
        "wv": dense_init(generator, D, cfg.n_kv_heads * hd, device, dtype,
                         stack),
        "wo": dense_init(generator, cfg.n_heads * hd, D, device, dtype, stack),
    }


def _causal_mask(S: int, window: int, device=None) -> torch.Tensor:
    """(S, S) additive f32 mask; window > 0 adds the sliding-window band."""
    q = torch.arange(S, device=device)[:, None]
    k = torch.arange(S, device=device)[None, :]
    ok = k <= q
    if window > 0:
        ok &= k > q - window
    return torch.where(ok, 0.0, NEG_INF).float()


def _sdpa(q, k, v, mask, place_scores=None) -> torch.Tensor:
    """q (B, S, Hq, hd), k/v (B, T, Hkv, hd), additive mask broadcasting to
    (B, Hkv, G, S, T) -> (B, S, Hq*hd). Scores are computed in the inputs'
    dtype and softmaxed in f32; the probabilities are cast back to v's
    dtype, as in the reference. ``place_scores`` (the chunked path's
    sharder hook) takes the scaled scores before the mask."""
    B, S, Hq, hd = q.shape
    T, Hkv = k.shape[1], k.shape[2]
    G = Hq // Hkv
    qg = q.reshape(B, S, Hkv, G, hd)
    scores = torch.einsum("bskgd,btkd->bkgst", qg, k).float()
    scores = scores.div_(math.sqrt(hd))
    if place_scores is not None:
        scores = place_scores(scores)
    scores = scores.add_(mask)
    probs = scores.softmax(dim=-1).to(v.dtype)
    del scores
    out = torch.einsum("bkgst,btkd->bskgd", probs, v)
    return out.reshape(B, S, Hq * hd)


def _chunked_sdpa(q, k, v, window: int, sharder: Sharder = NOOP,
                  score_kind: str = "attn_scores_seq") -> torch.Tensor:
    """Query-chunked causal attention: bounds the materialised scores to
    (B, H, CHUNK_Q, S) per chunk (the reference's ``lax.scan`` over
    chunks, as a loop), the scores of each chunk placed by
    ``score_kind``."""
    B, S, Hq, hd = q.shape
    bq = min(CHUNK_Q, S)
    if S % bq:
        raise ValueError(f"sequence length {S} is not a multiple of the "
                         f"query chunk {bq}")
    cols = torch.arange(S, device=q.device)[None, :]
    outs = []
    for i in range(S // bq):
        rows = i * bq + torch.arange(bq, device=q.device)[:, None]
        ok = cols <= rows
        if window > 0:
            ok &= cols > rows - window
        mask = torch.where(ok, 0.0, NEG_INF).float()
        outs.append(_sdpa(q[:, i * bq:(i + 1) * bq], k, v, mask,
                          lambda t: sharder.act(t, score_kind)))
    return torch.cat(outs, dim=1)


def _repeat_kv(cfg: ModelConfig, k, v, sharder: Sharder = NOOP):
    """K/V repeated to every q head (the reference's ``jnp.repeat``
    before the score einsum), then placed as q's heads are."""
    G = cfg.n_heads // cfg.n_kv_heads
    if G == 1:
        return k, v
    k, v = k.repeat_interleave(G, dim=2), v.repeat_interleave(G, dim=2)
    return sharder.act(k, "act_heads"), sharder.act(v, "act_heads")


def _per_rank(q, k, v, cfg: ModelConfig, core):
    """``core(q, k, v) -> (B, S, Hq·hd)`` on each rank's local block of
    DTensor q/k/v, through ``local_map``; the output takes q's placements.
    Exact: attention is independent per batch row and q head. q keeps its
    split of batch rows (dim 0) and heads (dim 2), in contiguous blocks
    (``act_heads``); K/V that ``act_heads`` placed as q (repeated to
    every q head) are used as they are, others are taken whole along
    heads and sequence (``act_kv_heads``; a decode cache split over its
    slots is gathered) and each rank picks the kv heads its q-head block
    reads (q head h reads kv head h // G), their gradients coming back
    partial over the mesh dimensions that split q's heads."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    mesh = q.device_mesh
    q_pl = tuple(p if p.is_shard(0) or p.is_shard(2) else Replicate()
                 for p in q.placements)
    rows = tuple(Shard(0) if p.is_shard(0) else Replicate() for p in q_pl)
    aligned = (k.shape[2] == q.shape[2]
               and tuple(k.placements) == tuple(v.placements) == q_pl)
    kv_pl = q_pl if aligned else rows
    kv_grad = kv_pl if aligned else tuple(
        Partial() if p.is_shard(2) else r for p, r in zip(q_pl, rows))
    G = q.shape[2] // k.shape[2]
    coord, h0, n = mesh.get_coordinate(), 0, q.shape[2]
    for i, p in enumerate(q_pl):
        if p.is_shard(2):
            n //= mesh.size(i)
            h0 += coord[i] * n

    def local(ql, kl, vl):
        if not aligned:
            kv = torch.arange(h0, h0 + ql.shape[2]) // G
            first, n_kv = int(kv[0]), int(kv[-1]) - int(kv[0]) + 1
            if ql.shape[2] % n_kv or not torch.equal(
                    kv - first,
                    torch.arange(ql.shape[2]) // (ql.shape[2] // n_kv)):
                # the block cuts a group unevenly: one kv head a q head
                kl, vl = kl[:, :, kv], vl[:, :, kv]
            else:
                kl = kl[:, :, first:first + n_kv]
                vl = vl[:, :, first:first + n_kv]
        return core(ql, kl, vl).reshape(ql.shape[0], ql.shape[1], -1)

    return local_map(local, out_placements=list(q_pl),
                     in_placements=(q_pl, kv_pl, kv_pl),
                     in_grad_placements=(q_pl, kv_grad, kv_grad),
                     device_mesh=mesh, redistribute_inputs=True)(q, k, v)


def attn_forward(params: Params, x: torch.Tensor, cfg: ModelConfig, *,
                 pos_offset: int = 0, sharder: Sharder = NOOP,
                 impl: str = "plain") -> torch.Tensor:
    """Full-sequence causal attention (train / prefill). x: (B, S, D)."""
    if impl not in IMPLS:
        raise ValueError(f"impl must be one of {IMPLS}, got {impl!r}")
    B, S, D = x.shape
    hd = cfg.hd
    wq, wk, wv = (params[n].to(x.dtype) for n in ("wq", "wk", "wv"))
    q = split_heads(x @ wq, cfg.n_heads, hd)
    k = split_heads(x @ wk, cfg.n_kv_heads, hd)
    v = split_heads(x @ wv, cfg.n_kv_heads, hd)
    del wq, wk, wv
    q = sharder.act(q, "act_heads")
    k = sharder.act(k, "act_kv_heads")
    v = sharder.act(v, "act_kv_heads")
    pos = torch.arange(S, device=x.device) + pos_offset
    cos, sin = rope_freqs(hd, cfg.rope_theta, pos)
    q = apply_rope(q, cos, sin)
    k = apply_rope(k, cos, sin)
    meshed = isinstance(q, DTensor)
    if impl == "kernel":
        # on the CPU too, where the dispatcher's plain version would
        # differentiate: the kernel it stands for has no backward
        fa.check_no_grad(q, k, v)

        def core(q, k, v):
            return fa.flash_attention(q, k, v, causal=True,
                                      window=cfg.sliding_window)
    elif S > CHUNK_Q_THRESHOLD:
        # long prefill: bound score memory by query chunking
        if cfg.tp_strategy == "heads":
            k, v = _repeat_kv(cfg, k, v, sharder)
        kind = ("attn_scores_heads" if cfg.tp_strategy == "heads"
                else "attn_scores_seq")

        def core(q, k, v):
            return _chunked_sdpa(q, k, v, cfg.sliding_window,
                                 NOOP if meshed else sharder, kind)
    else:
        # the reference repeats K/V to all q heads (for its head sharding)
        k, v = _repeat_kv(cfg, k, v, sharder)

        def core(q, k, v):
            return _sdpa(q, k, v, _causal_mask(S, cfg.sliding_window,
                                               q.device))
    out = (_per_rank(q, k, v, cfg, core) if meshed
           else core(q, k, v).reshape(B, S, -1))
    out = out @ params["wo"].to(out.dtype)
    return sharder.act(out, "act_resid")


def init_kv_cache(cfg: ModelConfig, batch: int, max_len: int, dtype,
                  device="cuda", stack=()) -> Params:
    """Rolling cache if cfg.sliding_window > 0 (slots = window), else
    max_len slots."""
    slots = cfg.sliding_window if cfg.sliding_window > 0 else max_len
    slots = min(slots, max_len)
    shape = (*stack, batch, slots, cfg.n_kv_heads, cfg.hd)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def attn_decode(params: Params, x: torch.Tensor, cache: Params, pos: int,
                cfg: ModelConfig, *, sharder: Sharder = NOOP
                ) -> Tuple[torch.Tensor, Params]:
    """One-token decode. x: (B, 1, D); pos: the current position (int).

    RoPE is applied at write time, so the cache holds rotated keys. The
    cache is updated in place (the reference returns a new one; nothing
    in the port keeps the old one) and returned."""
    B, S1, D = x.shape
    if S1 != 1:
        raise ValueError(f"decode takes one token per sequence, got {S1}")
    hd = cfg.hd
    slots = cache["k"].shape[1]
    wq, wk, wv = (params[n].to(x.dtype) for n in ("wq", "wk", "wv"))
    q = split_heads(x @ wq, cfg.n_heads, hd)
    k = split_heads(x @ wk, cfg.n_kv_heads, hd)
    v = split_heads(x @ wv, cfg.n_kv_heads, hd)
    del wq, wk, wv
    # the position is made on the device: a host tensor would be copied,
    # and the stream synchronised, once a layer
    cos, sin = rope_freqs(hd, cfg.rope_theta,
                          torch.arange(pos, pos + 1, device=x.device))
    q = apply_rope(q, cos[None], sin[None])
    k = apply_rope(k, cos[None], sin[None])
    slot = pos % slots
    if isinstance(cache["k"], DTensor):
        # a DTensor cache split over its slots takes no indexed write:
        # the slot is selected out of place and copied back
        hit = (torch.arange(slots, device=x.device) == slot)[None, :, None,
                                                            None]
        for name, t in (("k", k), ("v", v)):
            c = cache[name]
            c.copy_(torch.where(hit, t.to(c.dtype), c))
    else:
        cache["k"][:, slot] = k[:, 0].to(cache["k"].dtype)
        cache["v"][:, slot] = v[:, 0].to(cache["v"].dtype)
    # slot s holds the largest position p <= pos with p % slots == s; it
    # is valid iff p > pos - slots and p >= 0
    s_idx = torch.arange(slots, device=x.device)
    newest = pos - torch.remainder(pos - s_idx, slots)
    valid = newest >= max(0, pos - slots + 1)
    mask = torch.where(valid, 0.0, NEG_INF).float()[None, :]   # (1, slots)
    if isinstance(q, DTensor):
        out = _per_rank(q, cache["k"], cache["v"], cfg,
                        lambda q, k, v: _sdpa(q, k, v, mask))
    else:
        out = _sdpa(q, cache["k"], cache["v"], mask)
    out = out @ params["wo"].to(out.dtype)
    return sharder.act(out, "act_resid"), cache
