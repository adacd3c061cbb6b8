"""Algorithm 6 — the full proposed HFL framework (port of
``repro.core.framework``: fused and sequential engines, uplink codecs).

Per global iteration i:
  1. schedule H devices (IKC / VKC / FedAvg),
  2. assign them to edges (D3QN / HFEL / geographic),
  3. per-edge convex resource allocation (bandwidth + CPU frequency),
  4. HFL training (Algorithm 1) on the scheduled cohort,
  5. evaluate; stop when the target accuracy is reached.

Steps 3+4 plus the cost bookkeeping (13)/(14) are ``round_step_core``
(``engine="fused"``: one batched allocation over all edges), the one-lane
case of ``round_step_lanes``, the round body of the multi-lane sweep
(``core/sweep.py``). The
``engine="sequential"`` oracle solves the M allocations one by one and
runs Algorithm 1 with the plain aggregation. ``FrameworkConfig(
agg_kernel=True)`` routes the Algorithm-1 edge/cloud aggregation through
``kernels/hier_agg``; ``use_kernel=True`` routes the Algorithm-2 K-means
distances through ``kernels/kmeans_dist``. ``FrameworkConfig.compression``
compresses both uplinks (``core.compression``; fused engine only): the
round is priced with the codec's message bits and the error-feedback
residuals of every device and edge persist across rounds.

The framework runs on ``FrameworkConfig.device`` (``"cuda"`` unless the
caller passes ``"cpu"``; a missing card raises). Where the reference
draws from ``jax.random`` (weight init, crop offsets, kmeans++ seeding),
the port draws from a ``torch.Generator`` seeded with ``cfg.seed``, and
a caller can inject the outcome instead: ``init_params`` (the model's
initial weights), ``labels`` (the Algorithm-2 clustering) and
``codec_noise`` (round index -> int8 rounding-noise source; the default
is ``compression.round_noise``, stateless per round). ``assigner="drl"``
needs the trained agent's parameters (``drl_params``: the port's
tensors or the reference's arrays); ``assigner="hfel"`` searches with
the framework's own rng, so its proposals advance the Generator the
next round's scheduler draws from, as in the reference.

Every round runs under a ``repro_torch.trace.Tracer`` (no synchronise
for timing): its record carries ``seconds``, the time of its phases
(schedule and assign on the host clock; allocate, train, aggregate and
eval as device time between CUDA events, summed over the phase's spans)
and ``trace``, the round's spans and counters. ``setup_seconds`` times
the one-off clustering the same way: ``cluster``, and inside it
``aux_train`` (the auxiliary model's training) and ``kmeans``.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Callable, Dict, List, Mapping, Optional, Sequence

import numpy as np
import torch

from repro_torch import trace
from repro_torch.configs.registry import get_hfl_spec
from repro_torch.convert import flatten_params, params_from_numpy
from repro_torch.core import compression as comp
from repro_torch.core import cost_model as cm
from repro_torch.core import resource as ra
from repro_torch.core.assignment import (DRLAssigner, GeoAssigner,
                                         HFELAssigner)
from repro_torch.core.clustering import adjusted_rand_index
from repro_torch.core.hfl import (hfl_global_iteration_core,
                                  hfl_global_iteration_lanes, pad_device_data)
from repro_torch.core.scheduling import (FedAvgScheduler, IKCScheduler,
                                         VKCScheduler, clustering_cost,
                                         run_device_clustering)
from repro_torch.data.partition import FederatedData
from repro_torch.utils import resolve_device, tree_bytes

# the phases of a round record's ``seconds``; the first two run on the
# host alone and are timed on its clock
ROUND_PHASES = ("schedule", "assign", "allocate", "train", "aggregate",
                "eval")
HOST_PHASES = ("schedule", "assign")


def round_step_lanes(apply_fn, sp: cm.SystemParams, params, u, D, p, g,
                     g_cloud, B_m, X, y, mask, sizes, assign, lr, *,
                     M: int, L: int, Q: int, alloc_steps: int,
                     agg_kernel: bool = False, train_only: bool = False,
                     done=None, codec: Optional[comp.CompressionConfig] = None,
                     codec_state=None,
                     noise: Optional[Sequence[comp.NoiseSource]] = None):
    """One global iteration minus scheduling and assignment, for S
    independent lanes at once (the sweep's round body;
    :func:`round_step_core` is its S=1 case).

    Inputs are pre-gathered for each lane's scheduled cohort: u/D/p/sizes
    (S, H), g (S, H, M) gains to every edge, g_cloud/B_m (S, M),
    X/y/mask (S, H, Dmax, ...), assign (S, H) int64; params leaves
    (S, ...). Builds the per-edge masks, solves all S·M allocations (27)
    in one batch, prices each lane's round (13)/(14) and runs the
    lane-batched Algorithm 1. Returns (new_params, (T_i, E_i, T_m, E_m,
    b, f)) with T_i/E_i (S,), T_m/E_m (S, M), b/f (S, H). The allocation
    and pricing are the current tracer's ``allocate`` span, marked on
    the device.

    ``train_only`` skips the allocation and the pricing (all costs 0).
    ``done`` (S,) bool marks lanes that no longer train: their params
    (and codec residuals) pass through unchanged and their T_i/E_i are
    0. With an active ``codec``, ``sp`` must already carry the codec's
    per-message bits (``compression.message_bits``) so the allocation
    and eqs. (7)-(12) price the compressed payload; ``codec_state`` is
    ``(dev_resid, edge_resid)`` for the cohorts (S, H, ...) and the edges
    (S, M, ...), and ``noise`` one int8 noise source a lane. The return
    then becomes ``(new_params, (new_dev_resid, new_edge_resid), aux)``.
    """
    S, H = assign.shape
    dev = assign.device
    if train_only:
        zeros = torch.zeros((S,), dtype=torch.float32, device=dev)
        T_i = E_i = zeros
        T_m = E_m = zeros[:, None].expand(S, M)
        b = f = zeros[:, None].expand(S, H)
    else:
        with trace.span("allocate", mark=True):
            edge_mask = assign[:, None, :] == torch.arange(
                M, device=dev)[None, :, None]                    # (S, M, H)

            def rows(x):               # (S, H) -> (S·M, H): one row an edge
                return x[:, None, :].expand(S, M, H).reshape(S * M, H)

            res = ra.allocate_batch(
                sp, rows(u), rows(D), rows(p),
                g.transpose(1, 2).reshape(S * M, H), B_m.reshape(S * M),
                edge_mask.reshape(S * M, H), steps=alloc_steps)
            sel = assign[:, None, :]
            b = res.b.reshape(S, M, H).gather(1, sel)[:, 0]      # (S, H)
            f = res.f.reshape(S, M, H).gather(1, sel)[:, 0]
            g_sel = g.gather(2, assign[..., None])[..., 0]
            T_i, E_i, T_m, E_m = cm.round_cost_gathered(
                sp, u, D, p, g_sel, g_cloud, assign, b, f, M)
    compress = codec is not None and codec.active
    if compress:
        dev_resid, edge_resid = codec_state
        new_params, new_dev, new_edge = hfl_global_iteration_lanes(
            apply_fn, params, X, y, mask, sizes, assign, M=M, L=L, Q=Q,
            lr=lr, agg_kernel=agg_kernel, codec=codec, dev_resid=dev_resid,
            edge_resid=edge_resid, noise=noise)
    else:
        new_params = hfl_global_iteration_lanes(
            apply_fn, params, X, y, mask, sizes, assign, M=M, L=L, Q=Q,
            lr=lr, agg_kernel=agg_kernel)
    if done is not None:
        def freeze(old, new):
            return {k: torch.where(
                done.reshape((S,) + (1,) * (v.dim() - 1)), old[k], v)
                for k, v in new.items()}
        new_params = freeze(params, new_params)
        T_i = torch.where(done, 0.0, T_i)
        E_i = torch.where(done, 0.0, E_i)
        if compress:
            new_dev = freeze(dev_resid, new_dev)
            new_edge = freeze(edge_resid, new_edge)
    aux = (T_i, E_i, T_m, E_m, b, f)
    if compress:
        return new_params, (new_dev, new_edge), aux
    return new_params, aux


def round_step_core(apply_fn, sp: cm.SystemParams, params, u, D, p, g,
                    g_cloud, B_m, X, y, mask, sizes, assign, lr, *,
                    M: int, L: int, Q: int, alloc_steps: int,
                    agg_kernel: bool = False,
                    codec: Optional[comp.CompressionConfig] = None,
                    codec_state=None,
                    noise: Optional[comp.NoiseSource] = None):
    """One global iteration minus scheduling and assignment: the S=1 lane
    of :func:`round_step_lanes`.

    Inputs are pre-gathered for the scheduled cohort: u/D/p/sizes (H,),
    g (H, M) gains to every edge, X/y/mask (H, Dmax, ...), assign (H,)
    int64. Returns (new_params, (T_i, E_i, T_m, E_m, b, f)); with an
    active ``codec`` (``codec_state`` the cohort's (H, ...) and the
    edges' (M, ...) residuals, ``noise`` the round's int8 noise source)
    ``(new_params, (new_dev_resid, new_edge_resid), aux)``.
    """
    def lane(tree):
        return {k: v[None] for k, v in tree.items()}

    def unlane(tree):
        return {k: v[0] for k, v in tree.items()}

    compress = codec is not None and codec.active
    out = round_step_lanes(
        apply_fn, sp, lane(params), u[None], D[None], p[None], g[None],
        g_cloud[None], B_m[None], X[None], y[None], mask[None], sizes[None],
        assign[None], lr, M=M, L=L, Q=Q, alloc_steps=alloc_steps,
        agg_kernel=agg_kernel, codec=codec,
        codec_state=(tuple(lane(t) for t in codec_state) if compress
                     else None),
        noise=[noise] if compress else None)
    aux = tuple(a[0] for a in out[-1])
    if compress:
        return unlane(out[0]), tuple(unlane(t) for t in out[1]), aux
    return unlane(out[0]), aux


def build_scheduler(name: str, fed: FederatedData, sp: cm.SystemParams,
                    H: int, K: int = 10, lr: float = 0.01, seed: int = 0,
                    use_kernel: bool = False,
                    pop: Optional[cm.Population] = None,
                    arch: str = "hfl-cnn",
                    labels: Optional[np.ndarray] = None, device="cuda", *,
                    generator: Optional[torch.Generator] = None,
                    params: Optional[Mapping] = None,
                    data: Optional[Sequence[torch.Tensor]] = None):
    """Scheduler construction, shared by ``HFLFramework`` and the sweeps.

    IKC clusters with the arch's auxiliary mini model ξ on its
    clustering crop, VKC with the full model, FedAvg samples uniformly.
    A ``torch.Generator`` seeded with ``seed`` draws the full init, the
    mini init, the crops and the kmeans++ picks in that order, on
    ``device`` (``use_kernel`` routes the distances through K2). A caller
    that has drawn the full init already passes its ``generator``, the
    full model (``params``) and the padded ``data`` (X, y, mask) to go
    on with its own stream. ``labels`` injects the clustering's outcome
    (e.g. the reference's) instead. With ``pop`` given, returns
    (scheduler, clustering_stats) with the Table-II quantities (ari,
    delay_s, energy_j, aux_bits; empty for FedAvg); otherwise just the
    scheduler.
    """
    if name == "fedavg":
        sched = FedAvgScheduler(fed.n_devices, H)
        return (sched, {}) if pop is not None else sched
    if name not in ("ikc", "vkc"):
        raise ValueError(f"unknown scheduler {name!r}")
    spec = get_hfl_spec(arch)
    dev = resolve_device(device)
    gen = (generator if generator is not None
           else torch.Generator().manual_seed(seed))
    full = params if params is not None else spec.init_fn(gen, fed, dev)
    full_bits = tree_bytes(full) * 8
    if name == "ikc":
        mini = spec.mini_init_fn(gen, fed, dev)
        aux_bits = tree_bytes(mini) * 8
        compute_scale = aux_bits / max(1, full_bits)
    else:
        aux_bits, compute_scale = full_bits, 1.0
    if labels is None:
        X, y, mask = (data if data is not None
                      else pad_device_data(fed, device=dev))
        if name == "ikc":
            labels, _ = run_device_clustering(
                spec.mini_apply_fn, mini, spec.mini_preprocess_fn(X, gen),
                y, mask, K, sp.L, lr, use_kernel=use_kernel, generator=gen)
        else:
            labels, _ = run_device_clustering(
                spec.apply_fn, full, X, y, mask, K, sp.L, lr,
                use_kernel=use_kernel, generator=gen)
    labels = np.asarray(labels)
    if labels.shape != (fed.n_devices,):
        raise ValueError(f"labels must have shape ({fed.n_devices},), "
                         f"got {labels.shape}")
    sched = (IKCScheduler if name == "ikc" else VKCScheduler)(
        labels, max(1, H // K))
    if pop is None:
        return sched
    delay, energy = clustering_cost(sp, pop, aux_bits,
                                    compute_scale=compute_scale)
    stats = {"ari": adjusted_rand_index(labels, fed.majority_class),
             "delay_s": delay, "energy_j": energy,
             "aux_bits": float(aux_bits)}
    return sched, stats


@dataclasses.dataclass
class FrameworkConfig:
    arch: str = "hfl-cnn"           # model payload (configs.registry id)
    scheduler: str = "ikc"          # ikc | vkc | fedavg
    assigner: str = "geo"           # drl | hfel | geo
    H: int = 50
    K: int = 10
    lr: float = 0.01
    target_acc: float = 0.875
    max_iters: int = 100
    alloc_steps: int = 200
    seed: int = 0
    use_kernel: bool = False        # kmeans_dist kernel for Algorithm 2
    agg_kernel: bool = False        # hier_agg kernel for eqs. (2)-(3)
    engine: str = "fused"           # fused | sequential (per-edge oracle)
    hfel_search: str = "batched"    # batched | serial (assigner="hfel")
    hfel_candidates: int = 16       # K moves per batched HFEL round
    compression: comp.CompressionConfig = dataclasses.field(
        default_factory=comp.CompressionConfig)   # uplink update codec
    device: str = "cuda"            # "cpu" must be asked for

    def __post_init__(self):
        resolve_device(self.device)
        if self.engine not in ("fused", "sequential"):
            raise ValueError(f"unknown engine {self.engine!r}")
        if self.compression.active and self.engine == "sequential":
            raise ValueError("compression requires engine='fused' (the "
                             "sequential oracle ships raw payloads)")
        if self.assigner not in ("drl", "hfel", "geo"):
            raise ValueError(f"unknown assigner {self.assigner!r}")
        if self.hfel_search not in ("batched", "serial"):
            raise ValueError(f"unknown hfel_search {self.hfel_search!r}")
        if self.scheduler not in ("ikc", "vkc", "fedavg"):
            raise ValueError(f"unknown scheduler {self.scheduler!r}")


class HFLFramework:
    def __init__(self, sp: cm.SystemParams, pop: cm.Population,
                 fed: FederatedData, cfg: FrameworkConfig,
                 init_params: Optional[Mapping] = None,
                 labels: Optional[np.ndarray] = None,
                 codec_noise: Optional[
                     Callable[[int], comp.NoiseSource]] = None,
                 drl_params: Optional[Mapping] = None):
        self.pop, self.fed, self.cfg = pop, fed, cfg
        self.device = resolve_device(cfg.device)
        self.rng = np.random.default_rng(cfg.seed)
        self.generator = torch.Generator().manual_seed(cfg.seed)

        self.spec = get_hfl_spec(cfg.arch)
        self.model_params = (
            flatten_params(params_from_numpy(init_params, self.device))
            if init_params is not None
            else self.spec.init_fn(self.generator, fed, self.device))
        self.apply_fn = self.spec.apply_fn
        self.model_bits = tree_bytes(self.model_params) * 8
        self.sp = dataclasses.replace(sp, model_bits=float(self.model_bits))

        # uplink codec: every uplink (device->edge, edge->cloud) ships the
        # compressed message, so the round's allocator and cost model see
        # its bits; with the identity codec uplink_bits == model_bits
        self.codec = cfg.compression
        self.uplink_bits = comp.message_bits(self.codec, self.model_params)
        self.sp_round = dataclasses.replace(
            self.sp, model_bits=float(self.uplink_bits))
        self.codec_state = None
        if self.codec.active:
            self.codec_state = (
                comp.init_state(self.codec, self.model_params,
                                fed.n_devices),
                comp.init_state(self.codec, self.model_params, pop.n_edges))
        self.codec_noise = codec_noise or functools.partial(
            comp.round_noise, self.codec, cfg.seed, device=self.device)

        self.X, self.y, self.mask = pad_device_data(fed, device=self.device)
        self.clustering_stats: Dict = {}
        self.setup_seconds: Dict[str, float] = {}
        self._setup_scheduler(labels)
        self._setup_assigner(drl_params)
        self.history: List[Dict] = []

    # ------------------------------------------------------------ setup

    def _setup_scheduler(self, labels):
        cfg = self.cfg
        tracer = trace.Tracer(self.device)
        with trace.use(tracer), tracer.span("cluster"):
            self.scheduler, self.clustering_stats = build_scheduler(
                cfg.scheduler, self.fed, self.sp, cfg.H, K=cfg.K, lr=cfg.lr,
                use_kernel=cfg.use_kernel, pop=self.pop, arch=cfg.arch,
                labels=labels, device=self.device, generator=self.generator,
                params=self.model_params, data=(self.X, self.y, self.mask))
        tracer.finish()         # the labels were read back to the host
        if cfg.scheduler != "fedavg":
            self.setup_seconds = {
                "cluster": tracer.seconds("cluster"),
                "aux_train": tracer.seconds("cluster.aux_train"),
                "kmeans": tracer.seconds("cluster.kmeans")}

    def _setup_assigner(self, drl_params):
        a = self.cfg.assigner
        if a == "drl":
            if drl_params is None:
                raise ValueError("assigner='drl' needs the trained D3QN "
                                 "params (drl_params=)")
            self.assigner = DRLAssigner(
                self.sp, params_from_numpy(drl_params, self.device))
        elif a == "hfel":
            self.assigner = HFELAssigner(
                self.sp, search=self.cfg.hfel_search,
                n_candidates=self.cfg.hfel_candidates)
        else:
            self.assigner = GeoAssigner(self.sp)

    # ------------------------------------------------------------- round

    def run_round(self, i: int) -> Dict:
        sp = self.sp
        tracer = trace.Tracer(self.device, unit=i)
        with trace.use(tracer), tracer.span("round"):
            T_i, E_i, acc, H = self._round(i)
        msg_bits = cm.round_msg_bits(sp, sp.Q * H, self.pop.n_edges,
                                     msg_bits=self.uplink_bits)
        rec = {"iter": i, "acc": acc, "T_i": float(T_i), "E_i": float(E_i),
               "obj_i": float(E_i + sp.lam * T_i),
               "msg_bits": float(msg_bits),
               "uplink_bytes": float(sp.Q * H * self.uplink_bits / 8),
               "codec": self.codec.codec, "H": H}
        tracer.finish()         # after the read-backs of acc, T_i and E_i
        rec["seconds"] = {k: tracer.seconds(k, host=k in HOST_PHASES)
                          for k in ROUND_PHASES}
        rec["trace"] = tracer.record()
        self.history.append(rec)
        return rec

    def _round(self, i: int):
        """Round ``i``'s phases; returns (T_i, E_i, acc, H), the
        accuracy read back to the host."""
        sp, pop, dev = self.sp, self.pop, self.device
        with trace.span("schedule"):
            sched = np.asarray(self.scheduler.schedule(self.rng))
        with trace.span("assign"):
            assign, _ = self.assigner.assign(pop, sched, self.rng)
            assign = np.asarray(assign)
        H = len(sched)

        s = torch.from_numpy(sched.astype(np.int64)).to(dev)
        a = torch.from_numpy(assign.astype(np.int64)).to(dev)
        args = (pop.u[s], pop.D[s], pop.p[s], pop.g[s], pop.g_cloud,
                pop.B_m, self.X[s], self.y[s], self.mask[s], pop.D[s], a,
                self.cfg.lr)
        kw = dict(M=pop.n_edges, L=sp.L, Q=sp.Q,
                  alloc_steps=self.cfg.alloc_steps,
                  agg_kernel=self.cfg.agg_kernel)
        if self.cfg.engine == "sequential":
            T_i, E_i = self._sequential_alloc_cost_train(s, a)
        elif self.codec.active:
            dev_resid, edge_resid = self.codec_state
            cohort = {k: r[s] for k, r in dev_resid.items()}
            (self.model_params, (cohort, edge_resid),
             (T_i, E_i, _, _, _, _)) = round_step_core(
                self.apply_fn, self.sp_round, self.model_params, *args,
                codec=self.codec, codec_state=(cohort, edge_resid),
                noise=self.codec_noise(i), **kw)
            for k, full in dev_resid.items():      # scatter the cohort back
                full[s] = cohort[k]
            self.codec_state = (dev_resid, edge_resid)
        else:
            self.model_params, (T_i, E_i, _, _, _, _) = round_step_core(
                self.apply_fn, sp, self.model_params, *args, **kw)

        with trace.span("eval"):
            acc = self.spec.eval_fn(self.model_params,
                                    self.fed.X_test, self.fed.y_test)
        return T_i, E_i, acc, H

    def _sequential_alloc_cost_train(self, s, a):
        """The per-edge oracle of the fused engine: M separate
        allocations, ``round_cost``, then Algorithm 1 with the plain
        aggregation. s, a: (H,) int64 cohort and assignment."""
        sp, pop = self.sp, self.pop
        H = s.shape[0]
        with trace.span("allocate", mark=True):
            b = torch.zeros(H, dtype=torch.float32, device=self.device)
            f = torch.zeros_like(b)
            for m in range(pop.n_edges):
                sel = a == m
                res = ra.allocate(sp, pop.u[s], pop.D[s], pop.p[s],
                                  pop.g[s, m], pop.B_m[m], sel,
                                  steps=self.cfg.alloc_steps)
                b[sel] = res.b[sel]
                f[sel] = res.f[sel]
            T_i, E_i, _, _ = cm.round_cost(sp, pop, s, a, b, f)
        self.model_params = hfl_global_iteration_core(
            self.apply_fn, self.model_params, self.X[s], self.y[s],
            self.mask[s], pop.D[s], a, M=pop.n_edges, L=sp.L, Q=sp.Q,
            lr=self.cfg.lr)
        return T_i, E_i

    def run(self, verbose: bool = True) -> Dict:
        for i in range(1, self.cfg.max_iters + 1):
            rec = self.run_round(i)
            if verbose:
                print(f"  [{self.cfg.scheduler}/{self.cfg.assigner}] "
                      f"iter {i:3d} acc={rec['acc']:.3f} "
                      f"T_i={rec['T_i']:.1f}s E_i={rec['E_i']:.1f}J")
            if rec["acc"] >= self.cfg.target_acc:
                break
        return self.summary()

    def summary(self) -> Dict:
        T = sum(r["T_i"] for r in self.history)
        E = sum(r["E_i"] for r in self.history)
        return {
            "iters": len(self.history),
            "final_acc": self.history[-1]["acc"] if self.history else 0.0,
            "T": T, "E": E, "objective": E + self.sp.lam * T,
            "total_msg_bits": sum(r["msg_bits"] for r in self.history),
            "msg_bits_per_round": (self.history[-1]["msg_bits"]
                                   if self.history else 0.0),
            "clustering": self.clustering_stats,
            "history": self.history,
        }
