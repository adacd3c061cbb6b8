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
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

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
                   steps: int) -> AllocResult:
    """Solve (27) for a batch of edges from the cold start.

    u, D, p, g, mask: (E, n_slots), mask bool (which slots hold real
    devices); B_m: (E,).
    """
    any_dev = torch.any(mask, dim=-1)
    neg = -1e9
    floor_f = torch.tensor(1e6, dtype=u.dtype, device=u.device)

    def unpack(tb, tf):
        logits = torch.where(mask, tb, neg)
        b = B_m[..., None] * torch.softmax(logits, dim=-1)
        f = torch.maximum(sp.f_max * torch.sigmoid(tf), floor_f)
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

    theta = [torch.zeros_like(u), torch.full_like(u, 1.0)]  # f ~0.73 f_max

    # Adam, with the scalar schedule computed in f32 as the reference does
    lr, b1, b2, eps = 0.08, 0.9, 0.999, 1e-8
    f32 = np.float32
    m = [torch.zeros_like(t) for t in theta]
    v = [torch.zeros_like(t) for t in theta]
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

    with torch.no_grad():
        b, f = unpack(*theta)
        t, e = _edge_terms(sp, u, D, p, g, b, f, mask)
        T_edge = sp.Q * torch.amax(t, dim=-1)
        E_edge = sp.Q * torch.sum(e, dim=-1)
        obj = torch.where(any_dev, E_edge + sp.lam * T_edge, 0.0)
        return AllocResult(b, f, torch.where(any_dev, T_edge, 0.0),
                           torch.where(any_dev, E_edge, 0.0), obj)


def allocate(sp: SystemParams, u, D, p, g, B_m, mask,
             steps: int = 300) -> AllocResult:
    """Single-edge solve of (27): inputs (n_slots,) and a scalar B_m."""
    res = _allocate_core(
        sp, u[None], D[None], p[None], g[None],
        torch.as_tensor(B_m, dtype=u.dtype, device=u.device).reshape(1),
        mask[None], steps)
    return AllocResult(*(a[0] for a in res))


def allocate_batch(sp: SystemParams, u, D, p, g, B_m, mask,
                   steps: int = 300) -> AllocResult:
    """Solve (27) for a batch of edges in one call.

    u, D, p, g, mask: (M, n_slots); B_m: (M,). The result's fields carry
    the leading edge axis: b, f (M, n_slots); T_edge, E_edge, obj (M,).
    """
    return _allocate_core(sp, u, D, p, g, B_m, mask, steps)


def select_device_allocation(res: AllocResult, assign):
    """Per-device (H,) b and f: device h reads row assign[h] of the
    (M, H) allocation."""
    h_idx = torch.arange(assign.shape[0], device=assign.device)
    return res.b[assign, h_idx], res.f[assign, h_idx]
