"""Functional optimizers over trees of tensors (port of
``repro.optim.optimizers``).

Each optimizer is an ``Optimizer(init, update)`` pair;
``update(grads, state, params) -> (new_params, new_state)`` returns new
tensors and changes none in place. The step counter is a host ``int``, so
a loop of updates queues device work without waiting for it; the bias
corrections ``1 - b**step`` are computed in f32 as the reference computes
them, and Adam divides by ``sqrt(v / bc2) + eps`` as the reference does
(``torch.optim.Adam`` arranges its update differently).

* ``sgd``       — (momentum) SGD.
* ``adam``      — AdamW; the D3QN agent's optimizer.
* ``adafactor`` — factored second moment (Shazeer & Stern).
"""
from __future__ import annotations

from typing import Any, Callable, NamedTuple

import numpy as np
import torch

from repro_torch.utils import tree_leaves, tree_map

Tree = Any


class Optimizer(NamedTuple):
    init: Callable[[Tree], Tree]
    update: Callable[..., tuple]


def _f32(x) -> float:
    return float(np.float32(x))


def clip_by_global_norm(grads: Tree, max_norm: float) -> Tree:
    """Scale ``grads`` so their global L2 norm is at most ``max_norm``;
    squares summed leaf by leaf in the reference's (sorted-key) order."""
    total = None
    for g in tree_leaves(grads):
        s = torch.sum(torch.square(g.float()))
        total = s if total is None else total + s
    scale = torch.clamp_max(max_norm / (torch.sqrt(total) + 1e-9), 1.0)
    return tree_map(lambda g: g * scale, grads)


def _lr_fn(lr):
    return lr if callable(lr) else (lambda _: lr)


# -------------------------------------------------------------------- SGD

def sgd(lr, momentum: float = 0.0) -> Optimizer:
    lr_fn = _lr_fn(lr)

    def init(params):
        st = {"step": 0}
        if momentum > 0:
            st["mu"] = tree_map(torch.zeros_like, params)
        return st

    def update(grads, state, params):
        step = state["step"]
        lr_t = _f32(lr_fn(step))
        if momentum > 0:
            mu = tree_map(lambda m, g: momentum * m + g, state["mu"], grads)
            new = tree_map(lambda p, m: p - lr_t * m, params, mu)
            return new, {"step": step + 1, "mu": mu}
        return (tree_map(lambda p, g: p - lr_t * g, params, grads),
                {"step": step + 1})

    return Optimizer(init, update)


# ------------------------------------------------------------------- Adam

def adam(lr, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
         weight_decay: float = 0.0) -> Optimizer:
    lr_fn = _lr_fn(lr)

    def init(params):
        zeros = lambda p: torch.zeros_like(p, dtype=torch.float32)  # noqa: E731
        return {"step": 0, "m": tree_map(zeros, params),
                "v": tree_map(zeros, params)}

    def update(grads, state, params):
        step = state["step"] + 1
        lr_t = _f32(lr_fn(step))
        m = tree_map(lambda m_, g: b1 * m_ + (1 - b1) * g.float(),
                     state["m"], grads)
        v = tree_map(lambda v_, g: b2 * v_ + (1 - b2) * torch.square(
            g.float()), state["v"], grads)
        t = np.float32(step)
        bc1 = _f32(np.float32(1) - np.float32(b1) ** t)
        bc2 = _f32(np.float32(1) - np.float32(b2) ** t)

        def upd(p, m_, v_):
            u = (m_ / bc1) / (torch.sqrt(v_ / bc2) + eps)
            if weight_decay:
                u = u + weight_decay * p.float()
            return (p.float() - lr_t * u).to(p.dtype)

        return tree_map(upd, params, m, v), {"step": step, "m": m, "v": v}

    return Optimizer(init, update)


# -------------------------------------------------------------- Adafactor

def adafactor(lr, decay: float = 0.8, eps: float = 1e-30,
              clip_threshold: float = 1.0) -> Optimizer:
    """Factored 2nd moment for matrices; full for vectors/scalars."""
    lr_fn = _lr_fn(lr)

    def init(params):
        def leaf(p):
            if p.dim() >= 2:
                return {"vr": p.new_zeros(p.shape[:-1], dtype=torch.float32),
                        "vc": p.new_zeros(p.shape[:-2] + p.shape[-1:],
                                          dtype=torch.float32)}
            return {"v": torch.zeros_like(p, dtype=torch.float32)}
        return {"step": 0, "mom": tree_map(leaf, params)}

    def update(grads, state, params):
        step = state["step"] + 1
        beta = _f32(np.float32(1) - np.float32(step) ** np.float32(-decay))
        lr_t = _f32(lr_fn(step))

        def leaf(g, st, p):
            g32 = g.float()
            g2 = torch.square(g32) + eps
            if g.dim() >= 2:
                vr = beta * st["vr"] + (1 - beta) * g2.mean(-1)
                vc = beta * st["vc"] + (1 - beta) * g2.mean(-2)
                rfac = torch.rsqrt(vr / vr.mean(-1, keepdim=True) + eps)
                cfac = torch.rsqrt(vc + eps)
                u = g32 * rfac[..., None] * cfac.unsqueeze(-2)
                nst = {"vr": vr, "vc": vc}
            else:
                v = beta * st["v"] + (1 - beta) * g2
                u = g32 * torch.rsqrt(v + eps)
                nst = {"v": v}
            rms = torch.sqrt(torch.mean(torch.square(u)) + 1e-12)
            u = u / torch.clamp_min(rms / clip_threshold, 1.0)
            return (p.float() - lr_t * u).to(p.dtype), nst

        # tree_map stops at the grads' leaves, so each leaf's moment dict
        # ({"vr", "vc"} or {"v"}) reaches ``leaf`` whole
        out = tree_map(leaf, grads, state["mom"], params)
        new_params = tree_map(lambda _, o: o[0], params, out)
        new_mom = tree_map(lambda _, o: o[1], params, out)
        return new_params, {"step": step, "mom": new_mom}

    return Optimizer(init, update)
