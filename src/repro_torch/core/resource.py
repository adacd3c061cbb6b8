"""Resource allocation within an edge server — problem (27).

minimise   E_m + λ T_m
           = Q Σ_n [ α/2 L f_n² u_n D_n + p_n z/η_n(b_n) ]  + E_cloud
           + λ ( Q max_n [ L u_n D_n / f_n + z/η_n(b_n) ] + T_cloud )
s.t.       Σ b_n <= B_m,   0 <= f_n <= f_max.

Port of ``repro.core.resource``: the same reparameterisation (bandwidth
via a masked softmax scaled by B_m, frequency via a box sigmoid), the
same temperature-annealed log-sum-exp smoothing of the max, the same
Adam, and the hard-max objective of the final iterate. The solver works
on a leading edge axis directly — the M per-edge problems are
independent, so the gradient of their summed objectives from
``torch.autograd`` is every edge's own gradient at once.

``allocate_batch_warm`` starts the solver from caller-provided iterates
(HFEL's incumbent per-edge solutions, where a trial edge differs by one
moved device) and returns the final ones; ``flatten_trials`` /
``unflatten_trials`` map HFEL's trial-major ``(K, E, ...)`` candidate
batches onto that flat edge axis, so all K·E trial edges solve in one
call.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from repro_torch import trace
from repro_torch.core import cost_model as cm
from repro_torch.core.cost_model import SystemParams


class AllocResult(NamedTuple):
    b: torch.Tensor        # (..., n_slots) bandwidth [Hz]
    f: torch.Tensor        # (..., n_slots) CPU frequency [Hz]
    T_edge: torch.Tensor   # (...,): Q max_n (T_cmp + T_com)
    E_edge: torch.Tensor   # (...,): Q sum_n (E_cmp + E_com)
    obj: torch.Tensor      # E_edge + lam * T_edge   (cloud terms excluded)


def _edge_terms(sp: SystemParams, u, D, p, g, b, f, mask):
    t = cm.t_cmp(sp, u, D, f) + cm.t_com(sp, b, g, p)
    e = cm.e_cmp(sp, u, D, f) + cm.e_com(sp, b, g, p)
    return torch.where(mask, t, 0.0), torch.where(mask, e, 0.0)


def _allocate_core(sp: SystemParams, u, D, p, g, B_m, mask,
                   steps: int, theta0=None):
    """Solve (27) for a batch of edges.

    u, D, p, g, mask: (E, n_slots), mask bool (which slots hold real
    devices); B_m: (E,). ``theta0``: optional (tb, tf) reparameterised
    warm start, (E, n_slots) each; None is the cold start (zeros, ones).
    Adam's moments start at zero and the temperature runs its schedule
    over ``steps`` either way. Returns (AllocResult, (tb, tf)) with the
    final iterates, ready to seed the next warm solve. Counts the solve
    (``alloc.solves``) and the Adam steps it ran (``alloc.steps``) on
    the current tracer.
    """
    trace.count("alloc.solves", 1)
    any_dev = torch.any(mask, dim=-1)
    neg = -1e9

    def unpack(tb, tf):
        logits = torch.where(mask, tb, neg)
        b = B_m[..., None] * torch.softmax(logits, dim=-1)
        # a scalar floor, not a device tensor made from a host value: that
        # copy would synchronise the host with the device on every solve
        f = torch.clamp_min(sp.f_max * torch.sigmoid(tf), 1e6)
        return b, f

    def smooth_obj(tb, tf, tau):
        b, f = unpack(tb, tf)
        t, e = _edge_terms(sp, u, D, p, g, b, f, mask)
        # finite floor, NOT -inf: the gradient of logsumexp with -inf
        # entries is NaN, which would poison every masked allocation
        tmask = torch.where(mask, t / tau[..., None], -1e30)
        tmax = tau * torch.logsumexp(tmask, dim=-1)
        return sp.Q * torch.sum(e, dim=-1) + sp.lam * sp.Q * tmax

    def hard_T(tb, tf):
        b, f = unpack(tb, tf)
        t, _ = _edge_terms(sp, u, D, p, g, b, f, mask)
        return torch.amax(t, dim=-1) + 1e-12

    if theta0 is None:
        theta = [torch.zeros_like(u), torch.full_like(u, 1.0)]  # f ~0.73 f_max
    else:
        theta = [t.to(u.dtype) for t in theta0]

    # Adam, with the scalar schedule computed in f32 as the reference does
    lr, b1, b2, eps = 0.08, 0.9, 0.999, 1e-8
    f32 = np.float32
    m = [torch.zeros_like(t) for t in theta]
    v = [torch.zeros_like(t) for t in theta]
    ran = 0
    for i in range(steps):
        with torch.no_grad():
            # anneal the softmax temperature from loose to tight
            frac = f32(0.2) * (f32(1.0) - f32(i) / f32(steps)) + f32(0.01)
            tau = torch.clamp_min(hard_T(*theta) * float(frac), 1e-6)
        leaves = [t.detach().requires_grad_(True) for t in theta]
        grads = torch.autograd.grad(smooth_obj(*leaves, tau).sum(), leaves)
        t_ = f32(i + 1)
        c1 = float(f32(1.0) - f32(b1) ** t_)
        c2 = float(f32(1.0) - f32(b2) ** t_)
        with torch.no_grad():
            for j, gr in enumerate(grads):
                m[j] = b1 * m[j] + (1 - b1) * gr
                v[j] = b2 * v[j] + (1 - b2) * gr * gr
                theta[j] = theta[j] - lr * (m[j] / c1) / (
                    torch.sqrt(v[j] / c2) + eps)
        ran += 1
    trace.count("alloc.steps", ran)

    with torch.no_grad():
        b, f = unpack(*theta)
        t, e = _edge_terms(sp, u, D, p, g, b, f, mask)
        T_edge = sp.Q * torch.amax(t, dim=-1)
        E_edge = sp.Q * torch.sum(e, dim=-1)
        obj = torch.where(any_dev, E_edge + sp.lam * T_edge, 0.0)
        res = AllocResult(b, f, torch.where(any_dev, T_edge, 0.0),
                          torch.where(any_dev, E_edge, 0.0), obj)
    return res, (theta[0], theta[1])


def allocate(sp: SystemParams, u, D, p, g, B_m, mask,
             steps: int = 300) -> AllocResult:
    """Single-edge solve of (27): inputs (n_slots,) and a scalar B_m."""
    res = _allocate_core(
        sp, u[None], D[None], p[None], g[None],
        torch.as_tensor(B_m, dtype=u.dtype, device=u.device).reshape(1),
        mask[None], steps)[0]
    return AllocResult(*(a[0] for a in res))


def allocate_batch(sp: SystemParams, u, D, p, g, B_m, mask,
                   steps: int = 300) -> AllocResult:
    """Solve (27) for a batch of edges in one call.

    u, D, p, g, mask: (M, n_slots); B_m: (M,). The result's fields carry
    the leading edge axis: b, f (M, n_slots); T_edge, E_edge, obj (M,).
    """
    return _allocate_core(sp, u, D, p, g, B_m, mask, steps)[0]


def allocate_batch_warm(sp: SystemParams, u, D, p, g, B_m, mask, tb0, tf0,
                        steps: int = 60):
    """``allocate_batch`` warm-started from (tb0, tf0), (M, n_slots)
    reparameterised (bandwidth-logit, frequency) iterates of a nearby
    problem; neutral iterates (zeros, ones) make it the cold solve.
    Returns (AllocResult, (tb, tf)) with the final iterates."""
    return _allocate_core(sp, u, D, p, g, B_m, mask, steps, (tb0, tf0))


def flatten_trials(u, D, p, g, B_m, mask, *extras):
    """Trial-major allocation inputs -> ``allocate_batch``'s flat layout.

    u, D, p, g, mask (K, E, n_slots) and B_m (K, E), for K candidate
    moves of E affected edges each, become (K*E, ...) so all K·E edge
    problems solve in one call; row ``k*E + e`` is trial k's e-th edge.
    ``extras`` (e.g. warm-start iterates) are flattened the same way and
    appended. Works on tensors and numpy arrays alike.
    """
    K, E = mask.shape[:2]

    def flat(a):
        return a.reshape((K * E,) + tuple(a.shape[2:]))

    return (flat(u), flat(D), flat(p), flat(g), flat(B_m), flat(mask),
            *(flat(x) for x in extras))


def unflatten_trials(res: AllocResult, n_trials: int, n_edges: int
                     ) -> AllocResult:
    """Inverse of ``flatten_trials`` on every result field: flat
    ``(n_trials*n_edges, ...)`` -> ``(n_trials, n_edges, ...)``."""
    return AllocResult(*(a.reshape((n_trials, n_edges) + tuple(a.shape[1:]))
                         for a in res))


def gather_edge_inputs(pop, sched, assign):
    """The (M, H) per-edge allocation inputs of a scheduled cohort.

    sched: (H,) int64 device indices; assign: (H,) int64 edge id per
    scheduled device. Returns (u, D, p, g, B_m, mask) for
    ``allocate_batch``: device features broadcast over the edge axis,
    gains transposed to (M, H), mask[m, h] = (assign[h] == m).
    """
    M = pop.n_edges
    H = sched.shape[0]
    mask = assign[None, :] == torch.arange(M, device=assign.device)[:, None]
    return (pop.u[sched].expand(M, H), pop.D[sched].expand(M, H),
            pop.p[sched].expand(M, H), pop.g[sched].T, pop.B_m, mask)


def allocate_all_edges(sp: SystemParams, pop, sched, assign,
                       steps: int = 300) -> AllocResult:
    """Solve (27) for every edge of a population in one batched call."""
    return allocate_batch(sp, *gather_edge_inputs(pop, sched, assign),
                          steps=steps)


def select_device_allocation(res: AllocResult, assign):
    """Per-device (H,) b and f: device h reads row assign[h] of the
    (M, H) allocation."""
    h_idx = torch.arange(assign.shape[0], device=assign.device)
    return res.b[assign, h_idx], res.f[assign, h_idx]


def allocate_uniform(sp: SystemParams, u, D, p, g, B_m, mask) -> AllocResult:
    """Baseline: equal bandwidth split, f = f_max (one edge, (n_slots,)
    inputs and a scalar B_m)."""
    n_act = torch.clamp_min(mask.sum(), 1)
    b = torch.where(mask, B_m / n_act, 1.0)
    f = torch.full_like(u, sp.f_max)
    t, e = _edge_terms(sp, u, D, p, g, b, f, mask)
    T_edge = sp.Q * torch.amax(t)
    E_edge = sp.Q * torch.sum(e)
    return AllocResult(b, f, T_edge, E_edge, E_edge + sp.lam * T_edge)


def edge_objective_with_cloud(sp: SystemParams, res: AllocResult,
                              g_cloud_m) -> torch.Tensor:
    """E_m + λ T_m including the constant cloud-uplink terms (13),(14)."""
    T_cl, E_cl = cm.cloud_cost(sp, g_cloud_m)
    return (res.E_edge + E_cl) + sp.lam * (res.T_edge + T_cl)
