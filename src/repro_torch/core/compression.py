"""Communication compression for uplink model updates: codecs with error
feedback, charged end to end in the cost model.

Port of ``repro.core.compression``. Codecs act on parameter deltas
against the model the sender pulled (device->edge: the edge model at
dispatch; edge->cloud: the global model):

* ``none``       identity; engines keep their uncompressed code path.
* ``bf16_delta`` the delta cast to bfloat16 (16 bits/param).
* ``int8``       stochastic rounding to int8 with one f32 scale
                 ``max|x|/127`` per message and leaf; unbiased.
* ``topk``       magnitude top-k per leaf (k = max(1, round(topk_frac·n))),
                 sent as (index, value) pairs.

Each sender keeps an error-feedback residual: it encodes ``x = delta +
residual`` and keeps ``x - decode(encode(x))`` for its next message.
:func:`message_bits` is the compressed per-message size the cost model
charges. Encoding is row-wise: leaves carry a leading message axis (H
devices or M edges) and every row is one message.

Randomness: the reference draws the int8 rounding uniforms from
``jax.random``, which torch cannot replay, so here they are an input
``u``. :func:`round_noise` is the default source, stateless per (seed,
lane, round, hop, leaf) and drawn on the tensors' device; a caller (a
parity test) may pass the reference's draws instead.
"""
from __future__ import annotations

import dataclasses
import math
import zlib
from typing import Callable, Optional, Tuple

import numpy as np
import torch

from repro_torch.utils import Params

CODECS = ("none", "bf16_delta", "int8", "topk")

# (hop, leaf name, shape) -> U[0, 1) f32 tensor of that shape. Hops are
# the Q edge iterations 0..Q-1 and then the cloud hop Q.
NoiseSource = Callable[[int, str, Tuple[int, ...]], torch.Tensor]


@dataclasses.dataclass(frozen=True)
class CompressionConfig:
    """Uplink update-codec knobs. ``seed`` feeds the stochastic-rounding
    stream (derived per (lane, round), never carried)."""
    codec: str = "none"             # none | bf16_delta | int8 | topk
    topk_frac: float = 0.05         # fraction of entries kept per leaf
    error_feedback: bool = True
    seed: int = 0

    def __post_init__(self):
        if self.codec not in CODECS:
            raise ValueError(f"unknown codec {self.codec!r}; "
                             f"valid: {CODECS}")
        if not 0.0 < self.topk_frac <= 1.0:
            raise ValueError(f"topk_frac must be in (0, 1], "
                             f"got {self.topk_frac}")

    @property
    def active(self) -> bool:
        return self.codec != "none"


def _topk_k(cfg: CompressionConfig, n: int) -> int:
    return min(n, max(1, int(round(cfg.topk_frac * n))))


def message_bits(cfg: CompressionConfig, params: Params) -> float:
    """Bits per uplink message for one model shaped like ``params``.

    ``none`` counts raw parameter bytes; ``int8`` adds one f32 scale per
    leaf; ``topk`` charges (value + index) per kept entry, indices at
    ceil(log2(n)) bits. Leaves are summed in sorted key order, as the
    reference flattens a dict.
    """
    leaves = [params[k] for k in sorted(params)]
    if cfg.codec == "none":
        return float(sum(leaf.numel() * leaf.element_size() * 8
                         for leaf in leaves))
    if cfg.codec == "bf16_delta":
        return float(sum(leaf.numel() * 16 for leaf in leaves))
    if cfg.codec == "int8":
        return float(sum(leaf.numel() * 8 + 32 for leaf in leaves))
    bits = 0.0
    for leaf in leaves:
        n = leaf.numel()
        bits += _topk_k(cfg, n) * (32 + max(1, math.ceil(math.log2(n))))
    return float(bits)


def init_state(cfg: CompressionConfig, params: Params,
               n_rows: int) -> Optional[Params]:
    """Zero error-feedback residuals: one f32 row per sender, shaped like
    ``params`` with a leading ``(n_rows,)`` axis, on the params' device.
    None for the identity codec."""
    if not cfg.active:
        return None
    return {k: torch.zeros((n_rows,) + tuple(p.shape), dtype=torch.float32,
                           device=p.device) for k, p in params.items()}


# ------------------------------------------------------- row-wise codecs

def encode_rows(cfg: CompressionConfig, x: torch.Tensor,
                u: Optional[torch.Tensor] = None):
    """Encode (R, p) f32 rows: R messages of one p-element tensor.

    Returns ``(q, scale)``, the wire form: q is (R, p) int8 (``int8``),
    bf16 (``bf16_delta``) or dense-masked f32 (``topk``, the simulated
    form of the (index, value) pairs); scale is (R,) f32 (ones where the
    codec has none). ``int8`` needs ``u``, (R, p) uniforms in [0, 1).
    """
    R = x.shape[0]
    ones = torch.ones((R,), dtype=torch.float32, device=x.device)
    if cfg.codec == "bf16_delta":
        return x.to(torch.bfloat16), ones
    if cfg.codec == "int8":
        if u is None or u.shape != x.shape:
            raise ValueError("the int8 codec needs uniforms u shaped like x")
        absmax = torch.amax(torch.abs(x), dim=1)
        scale = torch.clamp_min(absmax / 127.0, 1e-30)
        q = torch.clamp(torch.floor(x / scale[:, None] + u), -127, 127)
        return q.to(torch.int8), scale
    if cfg.codec == "topk":
        k = _topk_k(cfg, x.shape[1])
        idx = torch.topk(torch.abs(x), k, dim=1).indices          # (R, k)
        keep = torch.zeros_like(x).scatter_(1, idx, 1.0)
        return x * keep, ones
    raise ValueError(f"encode_rows on codec {cfg.codec!r}")


def decode_rows(cfg: CompressionConfig, q: torch.Tensor,
                scale: torch.Tensor) -> torch.Tensor:
    """Decode the wire form back to (R, p) f32 rows."""
    return q.float() * scale[:, None]


def encode_leaf(cfg: CompressionConfig, delta: torch.Tensor,
                resid: torch.Tensor, u: Optional[torch.Tensor] = None):
    """Error-feedback encode of one leaf: (R, p) delta + residual.

    Returns ``(q, scale, new_resid)``: the wire form and the residual
    ``x - decode(q, scale)`` (passed through when ``error_feedback`` is
    off). ``u`` as in :func:`encode_rows`.
    """
    x = delta + resid if cfg.error_feedback else delta
    q, scale = encode_rows(cfg, x, u)
    if cfg.error_feedback:
        resid = x - decode_rows(cfg, q, scale)
    return q, scale, resid


def encode_decode(cfg: CompressionConfig, delta: Params, resid: Params,
                  noise: Optional[Callable[[str, Tuple[int, ...]],
                                           torch.Tensor]] = None):
    """Compress-then-decompress a dict of updates with error feedback.

    ``delta``/``resid``: leaves with a leading message axis (R, ...).
    ``noise(leaf name, (R, p))`` gives the int8 uniforms. Returns
    ``(decoded, new_resid)``; the identity codec passes both through.
    """
    if not cfg.active:
        return delta, resid
    dec, new_r = {}, {}
    for k, d in delta.items():
        R = d.shape[0]
        x = d.reshape(R, -1).float()
        u = noise(k, tuple(x.shape)) if cfg.codec == "int8" else None
        q, s, nr = encode_leaf(cfg, x, resid[k].reshape(R, -1), u)
        dec[k] = decode_rows(cfg, q, s).reshape(d.shape)
        new_r[k] = nr.reshape(resid[k].shape)
    return dec, new_r


def round_noise(cfg: CompressionConfig, lane_seed: int, round_idx: int,
                device) -> NoiseSource:
    """The default int8 noise source of one round: deterministic and
    stateless per (cfg.seed, lane, round, hop, leaf), so two engines (or
    two copies of one) draw identical noise without carrying a
    generator. Each draw seeds a ``torch.Generator`` on ``device`` from
    a ``numpy`` ``SeedSequence`` (the leaf name enters as its CRC-32)
    and draws there; nothing is drawn on the host."""
    device = torch.device(device)

    def draw(hop: int, name: str, shape: Tuple[int, ...]) -> torch.Tensor:
        ss = np.random.SeedSequence([cfg.seed, lane_seed, round_idx, hop,
                                     zlib.crc32(name.encode())])
        gen = torch.Generator(device=device)
        gen.manual_seed(int(ss.generate_state(1, np.uint64)[0] >> 1))
        return torch.rand(shape, generator=gen, device=device)
    return draw
