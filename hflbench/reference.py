"""The plain reference of a simulated HFL round (arXiv:2402.02506,
Algorithms 1, 2 and 4, problem (27), eqs. (1)-(14)), in plain PyTorch
and numpy. It imports nothing of the program and takes nothing the
program made: it gets the world (``world.py``) and the seeds, and works
out again the clustering, the cohorts, the assignment, the allocation,
the round's costs, the trained parameters and the test accuracy.

Where it differs from the program on purpose:
- The CNN runs as ``F.conv2d`` and ``F.max_pool2d`` in NCHW (the
  program: im2col GEMMs over NHWC), device by device over its real
  samples only (the program: one batch over every device, padded).
- Aggregations sum in float64; K-means and the allocation solve run in
  float64 on each edge's own devices.
- It computes in the configuration's ``precision``; its
  ``control_precision`` (``"tf32"`` for the float32 configurations:
  every conv and matmul input rounded to TF32's 10-bit mantissa, and on
  a card the TF32 paths switched on) is the lower-precision control.

The draws the program makes from its own seeded ``torch.Generator``
(the IKC mini model, the crop offsets, the kmeans++ picks) are made
here from a generator seeded alike, in the same order.
"""
from __future__ import annotations

import contextlib
import math
from typing import Dict, List

import numpy as np
import torch
import torch.nn.functional as F

from hflbench.ref_ikc import IKCScheduler
from hflbench.world import World

Params = Dict[str, torch.Tensor]


# ------------------------------------------------------------ precision

def _tf32(x: torch.Tensor) -> torch.Tensor:
    """f32 rounded to nearest on TF32's 10-bit mantissa."""
    i = x.contiguous().view(torch.int32)
    return ((i + 0x1000) & ~0x1FFF).view(torch.float32)


_ROUND = {"f32": None, "tf32": _tf32,
          "bf16": lambda x: x.bfloat16().float(),
          "f16": lambda x: x.half().float()}


class Precision:
    """The reference's arithmetic, by the names a configuration's
    ``precision`` and ``control_precision`` give: ``"f32"`` (float32,
    TF32 off), or float32 storage whose conv and matmul operands are
    rounded to ``"tf32"``, ``"bf16"`` or ``"f16"``."""

    def __init__(self, name: str = "f32"):
        if name not in _ROUND:
            raise ValueError(f"unknown precision {name!r}")
        self.name = name

    def operand(self, x: torch.Tensor) -> torch.Tensor:
        """``x`` as a conv or matmul reads it (rounded in the forward;
        the gradient passes straight through)."""
        if _ROUND[self.name] is None:
            return x
        d = x.detach()
        return x + (_ROUND[self.name](d) - d)

    @contextlib.contextmanager
    def active(self):
        on = self.name == "tf32"
        old = (torch.backends.cuda.matmul.allow_tf32,
               torch.backends.cudnn.allow_tf32)
        torch.backends.cuda.matmul.allow_tf32 = on
        torch.backends.cudnn.allow_tf32 = on
        try:
            yield
        finally:
            (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32) = old


# ---------------------------------------------------------------- model

def _conv(x, w_hwio, prec: Precision):
    """VALID conv of NCHW ``x`` with an HWIO weight."""
    return F.conv2d(prec.operand(x), prec.operand(w_hwio.permute(3, 2, 0, 1)))


def _mm(x, w, prec: Precision):
    return prec.operand(x) @ prec.operand(w)


def cnn_apply(params: Params, x_nhwc: torch.Tensor,
              prec: Precision) -> torch.Tensor:
    """The paper's CNN: two 5x5 convs with ReLU and 2x2 max-pool, then
    two linear layers; features flattened in (h, w, c) order."""
    x = x_nhwc.permute(0, 3, 1, 2)
    x = F.max_pool2d(F.relu(_conv(x, params["conv1"], prec)), 2)
    x = F.max_pool2d(F.relu(_conv(x, params["conv2"], prec)), 2)
    x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)
    return _mm(F.relu(_mm(x, params["fc1"], prec)), params["fc2"], prec)


def mini_apply(params: Params, x_nhwc: torch.Tensor,
               prec: Precision) -> torch.Tensor:
    """The IKC mini model ξ: a 2x2 conv, ReLU, 2x2 max-pool, linear."""
    x = x_nhwc.permute(0, 3, 1, 2)
    x = F.max_pool2d(F.relu(_conv(x, params["conv"], prec)), 2)
    x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)
    return _mm(x, params["fc"], prec)


def local_gd(apply, params: Params, X, y, steps: int, lr: float,
             prec: Precision) -> Params:
    """eq. (1): ``steps`` full-batch gradient steps on one device's mean
    cross-entropy."""
    names = list(params)
    for _ in range(steps):
        leaves = [params[k].detach().requires_grad_(True) for k in names]
        loss = F.cross_entropy(apply(dict(zip(names, leaves)), X, prec), y)
        grads = torch.autograd.grad(loss, leaves)
        params = {k: p.detach() - lr * g
                  for k, p, g in zip(names, leaves, grads)}
    return params


# ------------------------------------------------- clustering (Alg. 2)

def _he(gen, shape, fan_in):
    return torch.randn(shape, generator=gen,
                       dtype=torch.float32) * math.sqrt(2.0 / fan_in)


def _sq_dists(x: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    return torch.cdist(x, c).square()


def _kmeans_pp(x: torch.Tensor, k: int, gen) -> List[int]:
    n = x.shape[0]
    idx = [int(torch.randint(0, n, (), generator=gen))]
    for i in range(1, k):
        mind = _sq_dists(x, x[idx]).min(dim=1).values
        probs = (mind / max(float(mind.sum()), 1e-12)).cpu()
        idx.append(int(torch.multinomial(probs, 1, generator=gen))
                   if float(probs.sum()) > 0 else 0)
    return idx


def kmeans_best_of(x: torch.Tensor, k: int, gen, restarts: int = 8,
                   iters: int = 50) -> np.ndarray:
    """Lloyd's algorithm from kmeans++ centres, ``restarts`` times;
    the labels of the lowest inertia (the first on a tie)."""
    best, best_inertia = None, math.inf
    for _ in range(restarts):
        centers = x[_kmeans_pp(x, k, gen)]
        for _ in range(iters):
            lab = _sq_dists(x, centers).argmin(dim=1)
            oh = F.one_hot(lab, k).to(x.dtype)
            counts = oh.sum(0)
            centers = torch.where(counts[:, None] > 0,
                                  oh.T @ x / counts.clamp_min(1)[:, None],
                                  centers)
        d = _sq_dists(x, centers)
        lab = d.argmin(dim=1)
        inertia = float(d.min(dim=1).values.sum())
        if inertia < best_inertia:
            best, best_inertia = lab, inertia
    return best.cpu().numpy()


def cluster_labels(cfg: Dict, world: World, gen_seed: int, device,
                   prec: Precision) -> np.ndarray:
    """Algorithm 2 with the IKC mini model: each device trains ξ from a
    common init for L steps on 10x10 crops of channel 0 of its images,
    the weight vectors are standardised and K-means-clustered."""
    gen = torch.Generator().manual_seed(gen_seed)
    c = cfg["mini_crop"]
    ch = cfg["mini_channels"]
    flat = ((c - 1) // 2) ** 2 * ch
    mini = {"conv": _he(gen, (2, 2, 1, ch), 4),
            "fc": _he(gen, (flat, cfg["n_classes"]), flat)}
    N = cfg["n_devices"]
    ox = torch.randint(0, cfg["image_h"] - c + 1, (N,), generator=gen)
    oy = torch.randint(0, cfg["image_w"] - c + 1, (N,), generator=gen)
    mini = {k: v.to(device) for k, v in mini.items()}
    vecs = []
    with prec.active():
        for n in range(N):
            a, b = int(ox[n]), int(oy[n])
            X = torch.from_numpy(
                world.X[n][:, a:a + c, b:b + c, :1]).to(device)
            y = torch.from_numpy(world.y[n].astype(np.int64)).to(device)
            trained = local_gd(mini_apply, mini, X, y, cfg["L"], cfg["lr"],
                               prec)
            vecs.append(torch.cat([trained[k].reshape(-1)
                                   for k in sorted(trained)]))
    v = torch.stack(vecs).double()
    z = (v - v.mean(0)) / (v.std(0, correction=0) + 1e-8)
    return kmeans_best_of(z, cfg["K"], gen)


def ikc_scheduler(cfg: Dict, labels: np.ndarray, H: int) -> IKCScheduler:
    return IKCScheduler(labels, max(1, H // cfg["K"]))


def geo_assign(world: World, sched: np.ndarray) -> np.ndarray:
    """The nearest edge of each scheduled device (float64 distances)."""
    d = np.linalg.norm(world.dev_pos[sched][:, None] - world.edge_pos[None],
                       axis=-1)
    return np.argmin(d, axis=1)


# --------------------------------------- costs (4)-(14), problem (27)

class CostModel:
    """eqs. (4)-(14) in float64 for one configuration."""

    def __init__(self, cfg: Dict):
        self.L, self.Q, self.lam = cfg["L"], cfg["Q"], cfg["lam"]
        self.alpha, self.f_max = cfg["alpha"], cfg["f_max"]
        self.n0 = 10 ** (cfg["noise_dbm_hz"] / 10.0) / 1000.0
        self.z = float(cfg["parameters"] * 32)
        self.cloud_bw = cfg["cloud_bw"]
        self.p_edge = 10 ** (cfg["p_edge_dbm"] / 10.0) / 1000.0

    def terms(self, u, D, p, g, b, f):
        """Per device: (time, energy) of one edge iteration."""
        b = b.clamp_min(1.0)
        rate = b * torch.log2(1.0 + (g * p / self.n0) / b)
        t_com = self.z / rate
        t = self.L * u * D / f + t_com
        e = self.alpha / 2.0 * self.L * f * f * u * D + p * t_com
        return t, e

    def cloud(self, g_cloud):
        rate = self.cloud_bw * torch.log2(
            1.0 + g_cloud * self.p_edge / (self.n0 * self.cloud_bw))
        T = self.z / rate
        return T, self.p_edge * T

    def edge_objective(self, u, D, p, g, b, f, mask):
        """E_m + λ T_m without the cloud terms: (27)'s objective of each
        edge, over the devices in ``mask``."""
        t, e = self.terms(u, D, p, g, b, f)
        return (self.Q * torch.where(mask, e, 0.0).sum(-1) + self.lam
                * self.Q * torch.where(mask, t, 0.0).amax(-1))

    def round_cost(self, world: World, sched, assign, b, f, device):
        """(13)/(14): T_i = max_m T_m, E_i = Σ_m E_m, every edge's cloud
        upload included; b, f (H,) float64."""
        u, D, p, g = self.cohort(world, sched, assign, device)
        t, e = self.terms(u, D, p, g, b, f)
        T_cl, E_cl = self.cloud(torch.from_numpy(world.g_cloud).to(device))
        a = torch.from_numpy(np.asarray(assign)).to(device)
        T_m, E_m = T_cl.clone(), E_cl.clone()
        for m in range(len(world.g_cloud)):
            sel = a == m
            if bool(sel.any()):
                T_m[m] += self.Q * t[sel].max()
                E_m[m] += self.Q * e[sel].sum()
        return float(T_m.max()), float(E_m.sum())

    @staticmethod
    def cohort(world: World, sched, assign, device):
        def t(x):
            return torch.from_numpy(np.asarray(x, np.float64)).to(device)
        return (t(world.u[sched]), t(world.D[sched]), t(world.p[sched]),
                t(world.g[sched, assign]))


def allocate(cm: CostModel, u, D, p, g, B_m, mask, steps: int,
             stop: int = None):
    """Problem (27) on a batch of edges, each on its own devices: u, D,
    p, g, mask (E, n), B_m (E,). Bandwidth b = B_m·softmax(θ_b) over an
    edge's devices, frequency f = max(f_max·sigmoid(θ_f), 1e6), Adam (lr
    0.08) on the objective whose max is smoothed by a log-sum-exp at a
    temperature annealed over ``steps`` from 0.21 to 0.01 of the edge's
    current hard max. In the inputs' dtype (float64 as a rule); the
    edges' problems are independent, so summing their objectives gives
    each its own gradient. ``stop`` < ``steps`` ends the solve early,
    mid-anneal (a planted fault of the correctness check). Returns b, f
    (E, n); slots outside ``mask`` read b = 0."""
    u, D, p, g = (torch.where(mask, x, torch.ones_like(x))
                  for x in (u, D, p, g))
    theta = [torch.zeros_like(u), torch.ones_like(u)]
    m = [torch.zeros_like(u), torch.zeros_like(u)]
    v = [torch.zeros_like(u), torch.zeros_like(u)]
    lr, b1, b2, eps = 0.08, 0.9, 0.999, 1e-8
    low = torch.finfo(u.dtype).min

    def unpack(tb, tf):
        b = B_m[:, None] * torch.softmax(torch.where(mask, tb, low), -1)
        return b, (cm.f_max * torch.sigmoid(tf)).clamp_min(1e6)

    for i in range(steps if stop is None else stop):
        with torch.no_grad():
            t, _ = cm.terms(u, D, p, g, *unpack(*theta))
            t_max = torch.where(mask, t, 0.0).amax(-1, keepdim=True)
            frac = 0.2 * (1.0 - i / steps) + 0.01
            tau = (t_max * frac).clamp_min(1e-6)
        leaves = [x.detach().requires_grad_(True) for x in theta]
        t, e = cm.terms(u, D, p, g, *unpack(*leaves))
        lse = tau[:, 0] * torch.logsumexp(torch.where(mask, t / tau, low), -1)
        obj = (cm.Q * torch.where(mask, e, 0.0).sum()
               + cm.lam * cm.Q * lse.sum())
        grads = torch.autograd.grad(obj, leaves)
        c1, c2 = 1 - b1 ** (i + 1), 1 - b2 ** (i + 1)
        with torch.no_grad():
            for j, gr in enumerate(grads):
                m[j] = b1 * m[j] + (1 - b1) * gr
                v[j] = b2 * v[j] + (1 - b2) * gr * gr
                theta[j] = theta[j] - lr * (m[j] / c1) / (
                    torch.sqrt(v[j] / c2) + eps)
    with torch.no_grad():
        b, f = unpack(*theta)
        return torch.where(mask, b, 0.0), f


# ------------------------------------------------------ Algorithm 1

def device_data(world: World, n: int, device, sample_frac: float = 1.0):
    """Device ``n``'s images and labels (its leading ``sample_frac``)."""
    d = max(1, int(len(world.y[n]) * sample_frac))
    return (torch.from_numpy(world.X[n][:d]).to(device),
            torch.from_numpy(world.y[n][:d].astype(np.int64)).to(device))


def hfl_round(cfg: Dict, world: World, params: Params, sched, assign,
              device, prec: Precision, sample_frac: float = 1.0) -> Params:
    """One global iteration of Algorithm 1 on the cohort ``sched``
    assigned to edges ``assign``: Q edge iterations of L local steps a
    device from its edge's model, each closed by the D_n-weighted edge
    average (2) (an edge with no device keeps its model), then the cloud
    average (3) of the edge models weighted by their devices' D_n.
    ``sample_frac`` < 1 trains each device on that leading share of its
    samples (a planted fault of the correctness check)."""
    M, names = cfg["n_edges"], list(params)
    g = {k: v.to(device) for k, v in params.items()}
    edges = [dict(g) for _ in range(M)]
    data = [device_data(world, n, device, sample_frac) for n in sched]
    w = np.asarray(world.D[sched], np.float64)
    with prec.active():
        for _ in range(cfg["Q"]):
            trained = [local_gd(cnn_apply, edges[a], X, y, cfg["L"],
                                cfg["lr"], prec)
                       for a, (X, y) in zip(assign, data)]
            for m in range(M):
                mine = [h for h, a in enumerate(assign) if a == m]
                if mine:
                    tot = sum(w[h] for h in mine)
                    edges[m] = {k: (sum(w[h] * trained[h][k].double()
                                        for h in mine) / tot).float()
                                for k in names}
    tot = {m: sum(w[h] for h, a in enumerate(assign) if a == m)
           for m in range(M)}
    all_w = sum(tot.values())
    return {k: (sum(tot[m] * edges[m][k].double() for m in range(M)
                    if tot[m] > 0) / all_w).float() for k in names}


def correct_and_ties(cfg: Dict, world: World, params: Params, device,
                     prec: Precision, tie_rel: float = 1e-4,
                     batch: int = 1000):
    """(correct predictions on the test set, predictions whose two best
    logits lie within ``tie_rel`` of the best's scale: answers that
    rounding may flip)."""
    p = {k: v.to(device) for k, v in params.items()}
    correct = ties = 0
    with torch.no_grad(), prec.active():
        for i in range(0, len(world.y_test), batch):
            X = torch.from_numpy(world.X_test[i:i + batch]).to(device)
            y = torch.from_numpy(world.y_test[i:i + batch].astype(np.int64))
            logits = cnn_apply(p, X, prec).double().cpu()
            top = logits.topk(2, dim=-1).values
            correct += int((logits.argmax(-1) == y).sum())
            ties += int(((top[:, 0] - top[:, 1])
                         <= tie_rel * (1.0 + top[:, 0].abs())).sum())
    return correct, ties
