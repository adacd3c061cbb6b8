"""Synthetic fleet traffic: Poisson joins, diurnal load, burst mode.

Port of ``repro.core.traffic``. Feeds the async engine
(``core/async_engine.py``) availability traces shaped like a real IoT
fleet's day instead of the stationary alternating-renewal process of
``cost_model.sample_availability``: device *joins* arrive as a
non-homogeneous Poisson process with rate

    lam(t) = join_rate * (1 + diurnal_amp * sin(2*pi*t / diurnal_period))
                       * (burst_mult inside burst windows)

sampled by thinning against the rate envelope, and each join keeps the
device online for an Exp(mean_session_s) session. The thinning loop is
the reference's numpy code, draw for draw, so a seed gives the same
joins and leaves in both packages. The output is a plain
:class:`repro_torch.core.cost_model.AvailabilityTrace`.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

import numpy as np
import torch

from repro_torch.core import cost_model as cm


@dataclasses.dataclass(frozen=True)
class TrafficParams:
    """Traffic-shape knobs; defaults are a mild stationary fleet."""
    join_rate: float = 0.1          # fleet-wide joins / virtual second
    mean_session_s: float = 300.0   # online duration after a join
    diurnal_amp: float = 0.0        # 0..1 sinusoidal rate modulation
    diurnal_period_s: float = 3600.0
    burst_mult: float = 1.0         # rate multiplier inside bursts
    burst_every_s: float = math.inf  # burst window cadence
    burst_len_s: float = 0.0        # burst window length
    p_online0: float = 1.0          # fraction online at t=0


class TrafficGenerator:
    """Builds availability traces from a :class:`TrafficParams` shape."""

    def __init__(self, params: TrafficParams, n_devices: int,
                 seed: int = 0):
        self.params, self.n, self.seed = params, n_devices, seed

    def rate(self, t: float) -> float:
        """Instantaneous fleet join rate lam(t) [joins/s]."""
        tp = self.params
        lam = tp.join_rate * (1.0 + tp.diurnal_amp
                              * math.sin(2.0 * math.pi * t
                                         / tp.diurnal_period_s))
        if (math.isfinite(tp.burst_every_s) and tp.burst_len_s > 0
                and t % tp.burst_every_s < tp.burst_len_s):
            lam *= tp.burst_mult
        return max(lam, 0.0)

    def make_trace(self, horizon_s: float,
                   ap: Optional[cm.AvailabilityParams] = None,
                   slow=None) -> cm.AvailabilityTrace:
        """Simulate joins and leaves over ``[0, horizon_s]``.

        Joins are thinned against the constant envelope
        ``join_rate * (1+diurnal_amp) * burst_mult``; each join flips a
        uniformly chosen offline device online for an Exp-length
        session. ``ap`` (optional) supplies straggler latency scales,
        drawn by ``cost_model.sample_straggler_scales`` on a
        ``torch.Generator`` seeded with the generator's seed, or taken
        from ``slow`` ((n,) bool, e.g. the reference's draw).
        """
        tp, n = self.params, self.n
        rng = np.random.default_rng(self.seed)
        online = rng.uniform(size=n) < tp.p_online0
        # devices online at t=0 leave after one session length
        toggles = [[] for _ in range(n)]
        leave_t = np.full(n, np.inf)
        leave_t[online] = rng.exponential(tp.mean_session_s,
                                          int(online.sum()))
        init_up = online.copy()

        env = tp.join_rate * (1.0 + max(tp.diurnal_amp, 0.0)) \
            * max(tp.burst_mult, 1.0)
        t = 0.0
        while True:
            # next candidate join (homogeneous envelope), next leave
            t_join = (t + rng.exponential(1.0 / env)
                      if env > 0 else math.inf)
            t_leave = leave_t.min()
            t = min(t_join, t_leave)
            if t > horizon_s:
                break
            if t_leave <= t_join:
                d = int(leave_t.argmin())
                online[d] = False
                leave_t[d] = np.inf
                toggles[d].append(t)
                continue
            if rng.uniform() * env > self.rate(t):
                continue             # thinned: envelope candidate rejected
            off = np.flatnonzero(~online)
            if len(off) == 0:
                continue             # whole fleet already online
            d = int(rng.choice(off))
            online[d] = True
            leave_t[d] = t + rng.exponential(tp.mean_session_s)
            toggles[d].append(t)

        width = max(1, max(len(row) for row in toggles))
        tog = np.full((n, width), np.inf)
        for d, row in enumerate(toggles):
            tog[d, :len(row)] = row
        scale = np.ones(n)
        if ap is not None and ap.straggler_frac > 0:
            scale = cm.sample_straggler_scales(
                torch.Generator().manual_seed(self.seed), ap, n,
                slow).astype(np.float64)
        return cm.AvailabilityTrace(init_up=init_up, toggles=tog,
                                    latency_scale=scale)
