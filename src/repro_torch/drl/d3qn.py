"""Dueling Double Deep Q-Network (D3QN) over the BiLSTM trunk; port of
``repro.drl.d3qn``.

Q(s, a; θ) = V(s; φ, ρ) + A(s, a; φ, ζ) − mean_a' A(s, a'; φ, ζ)   (eq. 20)

Parameters are a nested dict with the reference's keys and layouts, so
trained reference params cross over with ``convert.params_from_numpy``.
"""
from __future__ import annotations

import torch

from repro_torch.drl.bilstm import bilstm_encode, bilstm_init
from repro_torch.models.layers import dense_init


def d3qn_init(generator: torch.Generator, feat_dim: int, n_actions: int,
              hidden: int = 256, device="cuda"):
    enc = 2 * hidden
    return {
        "bilstm": bilstm_init(generator, feat_dim, hidden, device),
        "trunk": {"w": dense_init(generator, enc, hidden, device),
                  "b": torch.zeros(hidden, device=device)},
        "v_head": {"w": dense_init(generator, hidden, 1, device),
                   "b": torch.zeros(1, device=device)},
        "a_head": {"w": dense_init(generator, hidden, n_actions, device),
                   "b": torch.zeros(n_actions, device=device)},
    }


def q_values_all_t(params, feats: torch.Tensor) -> torch.Tensor:
    """feats: (..., H, F) episode features -> Q (..., H, n_actions) for
    every slot; a leading axis batches episodes (the reference's
    ``q_values_batch``)."""
    enc = bilstm_encode(params["bilstm"], feats)             # (..., H, 2h)
    z = torch.relu(enc @ params["trunk"]["w"] + params["trunk"]["b"])
    v = z @ params["v_head"]["w"] + params["v_head"]["b"]    # (..., H, 1)
    a = z @ params["a_head"]["w"] + params["a_head"]["b"]    # (..., H, M)
    return v + a - a.mean(dim=-1, keepdim=True)
