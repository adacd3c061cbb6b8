"""Grouped-query attention with RoPE, full/sliding-window masks, KV cache.

Port of ``repro.models.attention`` on one device (the reference's
``sharder`` hooks are its no-op ``NOOP`` there, so they are dropped):

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
"""
from __future__ import annotations

import math
from typing import Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.flash_attention import ops as fa
from repro_torch.models.layers import apply_rope, dense_init, rope_freqs
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


def _sdpa(q, k, v, mask) -> torch.Tensor:
    """q (B, S, Hq, hd), k/v (B, T, Hkv, hd), additive mask broadcasting to
    (B, Hkv, G, S, T) -> (B, S, Hq*hd). Scores are computed in the inputs'
    dtype and softmaxed in f32; the probabilities are cast back to v's
    dtype, as in the reference."""
    B, S, Hq, hd = q.shape
    T, Hkv = k.shape[1], k.shape[2]
    G = Hq // Hkv
    qg = q.reshape(B, S, Hkv, G, hd)
    scores = torch.einsum("bskgd,btkd->bkgst", qg, k).float()
    scores = scores.div_(math.sqrt(hd)).add_(mask)
    probs = scores.softmax(dim=-1).to(v.dtype)
    del scores
    out = torch.einsum("bkgst,btkd->bskgd", probs, v)
    return out.reshape(B, S, Hq * hd)


def _chunked_sdpa(q, k, v, window: int) -> torch.Tensor:
    """Query-chunked causal attention: bounds the materialised scores to
    (B, H, CHUNK_Q, S) per chunk (the reference's ``lax.scan`` over
    chunks, as a loop)."""
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
        outs.append(_sdpa(q[:, i * bq:(i + 1) * bq], k, v, mask))
    return torch.cat(outs, dim=1)


def _repeat_kv(cfg: ModelConfig, k, v):
    G = cfg.n_heads // cfg.n_kv_heads
    if G == 1:
        return k, v
    return k.repeat_interleave(G, dim=2), v.repeat_interleave(G, dim=2)


def attn_forward(params: Params, x: torch.Tensor, cfg: ModelConfig, *,
                 pos_offset: int = 0, impl: str = "plain") -> torch.Tensor:
    """Full-sequence causal attention (train / prefill). x: (B, S, D)."""
    if impl not in IMPLS:
        raise ValueError(f"impl must be one of {IMPLS}, got {impl!r}")
    B, S, D = x.shape
    hd = cfg.hd
    wq, wk, wv = (params[n].to(x.dtype) for n in ("wq", "wk", "wv"))
    q = (x @ wq).reshape(B, S, cfg.n_heads, hd)
    k = (x @ wk).reshape(B, S, cfg.n_kv_heads, hd)
    v = (x @ wv).reshape(B, S, cfg.n_kv_heads, hd)
    del wq, wk, wv
    pos = torch.arange(S, device=x.device) + pos_offset
    cos, sin = rope_freqs(hd, cfg.rope_theta, pos)
    q = apply_rope(q, cos, sin)
    k = apply_rope(k, cos, sin)
    if impl == "kernel":
        # on the CPU too, where the dispatcher's plain version would
        # differentiate: the kernel it stands for has no backward
        fa.check_no_grad(q, k, v)
        out = fa.flash_attention(q, k, v, causal=True,
                                 window=cfg.sliding_window).reshape(B, S, -1)
    elif S > CHUNK_Q_THRESHOLD:
        # long prefill: bound score memory by query chunking
        if cfg.tp_strategy == "heads":
            k, v = _repeat_kv(cfg, k, v)
        out = _chunked_sdpa(q, k, v, cfg.sliding_window)
    else:
        # the reference repeats K/V to all q heads (for its head sharding)
        k, v = _repeat_kv(cfg, k, v)
        out = _sdpa(q, k, v, _causal_mask(S, cfg.sliding_window, x.device))
    return out @ params["wo"].to(out.dtype)


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
                cfg: ModelConfig) -> Tuple[torch.Tensor, Params]:
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
    q = (x @ wq).reshape(B, 1, cfg.n_heads, hd)
    k = (x @ wk).reshape(B, 1, cfg.n_kv_heads, hd)
    v = (x @ wv).reshape(B, 1, cfg.n_kv_heads, hd)
    del wq, wk, wv
    # the position is made on the device: a host tensor would be copied,
    # and the stream synchronised, once a layer
    cos, sin = rope_freqs(hd, cfg.rope_theta,
                          torch.arange(pos, pos + 1, device=x.device))
    q = apply_rope(q, cos[None], sin[None])
    k = apply_rope(k, cos[None], sin[None])
    slot = pos % slots
    cache["k"][:, slot] = k[:, 0].to(cache["k"].dtype)
    cache["v"][:, slot] = v[:, 0].to(cache["v"].dtype)
    # slot s holds the largest position p <= pos with p % slots == s; it
    # is valid iff p > pos - slots and p >= 0
    s_idx = torch.arange(slots, device=x.device)
    newest = pos - torch.remainder(pos - s_idx, slots)
    valid = newest >= max(0, pos - slots + 1)
    mask = torch.where(valid, 0.0, NEG_INF).float()[None, :]   # (1, slots)
    out = _sdpa(q, cache["k"], cache["v"], mask)
    return out @ params["wo"].to(out.dtype), cache
