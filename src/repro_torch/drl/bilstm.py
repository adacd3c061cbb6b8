"""Bidirectional LSTM trunk for the D3QN agent (paper Fig. 2); port of
``repro.drl.bilstm``.

The agent's state at slot t (eq. 25) is (forward input χ_{n_1..n_t},
backward input χ_{n_t..n_H}). The device feature sequence is fixed for
the episode, so one forward and one backward pass give the encodings of
all H states at once: enc(s_t) = [h_fwd[t] ; h_bwd[t]].

The LSTM is written out, not ``torch.nn.LSTM``, because the agent's
weights have the reference's layout and recurrence: ``wx`` (in, 4h),
``wh`` (h, 4h) and one bias ``b`` (4h,), gates in the order i, f, g, o,
and a forget gate of ``sigmoid(f + 1.0)``. Every function takes any
leading batch axes (episodes) in front of the sequence axis.
"""
from __future__ import annotations

import torch

from repro_torch.models.layers import dense_init


def lstm_init(generator: torch.Generator, in_dim: int, hidden: int,
              device="cuda"):
    return {
        "wx": dense_init(generator, in_dim, 4 * hidden, device),
        "wh": dense_init(generator, hidden, 4 * hidden, device) * 0.3,
        "b": torch.zeros(4 * hidden, device=device),
    }


def lstm_scan(params, xs: torch.Tensor) -> torch.Tensor:
    """xs: (..., T, in_dim) -> hidden states (..., T, hidden).

    The input projection is hoisted out of the recurrence: one
    (T, in) @ (in, 4h) product up front, so each step pays only the
    recurrent h @ wh product.
    """
    hidden = params["wh"].shape[0]
    zx = xs @ params["wx"] + params["b"]              # (..., T, 4h)
    h = xs.new_zeros(xs.shape[:-2] + (hidden,))
    c = h
    hs = []
    for t in range(xs.shape[-2]):
        z = zx[..., t, :] + h @ params["wh"]
        i, f, g, o = z.split(hidden, dim=-1)
        c = torch.sigmoid(f + 1.0) * c + torch.sigmoid(i) * torch.tanh(g)
        h = torch.sigmoid(o) * torch.tanh(c)
        hs.append(h)
    return torch.stack(hs, dim=-2)


def bilstm_init(generator: torch.Generator, in_dim: int, hidden: int,
                device="cuda"):
    return {"fwd": lstm_init(generator, in_dim, hidden, device),
            "bwd": lstm_init(generator, in_dim, hidden, device)}


def bilstm_encode(params, feats: torch.Tensor) -> torch.Tensor:
    """feats: (..., H, F) -> per-slot state encodings (..., H, 2*hidden)."""
    h_f = lstm_scan(params["fwd"], feats)                  # after χ_t
    h_b = lstm_scan(params["bwd"], feats.flip(-2)).flip(-2)  # χ_H..χ_t
    return torch.cat([h_f, h_b], dim=-1)
