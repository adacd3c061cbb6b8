"""Learning-rate schedules (port of ``repro.optim.schedules``): functions
of the integer step, computed in f32 as the reference computes them."""
from __future__ import annotations

import numpy as np

_f = np.float32


def constant(lr: float):
    return lambda step: _f(lr)


def cosine(lr: float, total_steps: int, final_frac: float = 0.1):
    def fn(step):
        t = np.clip(_f(step) / _f(total_steps), _f(0), _f(1))
        c = _f(0.5) * (_f(1) + np.cos(_f(np.pi) * t))
        return _f(lr) * (_f(final_frac) + _f(1 - final_frac) * c)
    return fn


def warmup_cosine(lr: float, warmup: int, total_steps: int,
                  final_frac: float = 0.1):
    cos = cosine(lr, max(1, total_steps - warmup), final_frac)

    def fn(step):
        s = _f(step)
        w = np.clip(s / _f(max(1, warmup)), _f(0), _f(1))
        return _f(lr) * w if s < warmup else cos(step - warmup)
    return fn
