"""Algorithm 6 — the full proposed HFL framework (port of
``repro.core.framework``: fused and sequential engines, uplink codecs).

Per global iteration i:
  1. schedule H devices (IKC / VKC / FedAvg),
  2. assign them to edges (D3QN / HFEL / geographic),
  3. per-edge convex resource allocation (bandwidth + CPU frequency),
  4. HFL training (Algorithm 1) on the scheduled cohort,
  5. evaluate; stop when the target accuracy is reached.

Steps 3+4 plus the cost bookkeeping (13)/(14) are ``round_step_core``
(``engine="fused"``: one batched allocation over all edges). The
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

Every round record carries ``seconds``, the wall time of its phases
(schedule, assign, allocate, train, aggregate, eval), each ending in a
device synchronise; ``setup_seconds["cluster"]`` is the one-off
clustering.
"""
from __future__ import annotations

import dataclasses
import functools
import time
from typing import Callable, Dict, List, Mapping, Optional

import numpy as np
import torch

from repro_torch.configs.registry import get_hfl_spec
from repro_torch.convert import params_from_numpy
from repro_torch.core import compression as comp
from repro_torch.core import cost_model as cm
from repro_torch.core import resource as ra
from repro_torch.core.assignment import (DRLAssigner, GeoAssigner,
                                         HFELAssigner)
from repro_torch.core.clustering import adjusted_rand_index
from repro_torch.core.hfl import hfl_global_iteration_core, pad_device_data
from repro_torch.core.scheduling import (FedAvgScheduler, IKCScheduler,
                                         VKCScheduler, clustering_cost,
                                         run_device_clustering)
from repro_torch.data.partition import FederatedData
from repro_torch.utils import Stopwatch, phase, resolve_device, tree_bytes


def round_step_core(apply_fn, sp: cm.SystemParams, params, u, D, p, g,
                    g_cloud, B_m, X, y, mask, sizes, assign, lr, *,
                    M: int, L: int, Q: int, alloc_steps: int,
                    agg_kernel: bool = False,
                    codec: Optional[comp.CompressionConfig] = None,
                    codec_state=None,
                    noise: Optional[comp.NoiseSource] = None,
                    stopwatch: Optional[Stopwatch] = None):
    """One global iteration minus scheduling and assignment.

    Inputs are pre-gathered for the scheduled cohort: u/D/p/sizes (H,),
    g (H, M) gains to every edge, X/y/mask (H, Dmax, ...), assign (H,)
    int64. Builds the per-edge masks, solves the M allocations (27) in
    one batch, prices the round (13)/(14) and runs Algorithm 1. Returns
    (new_params, (T_i, E_i, T_m, E_m, b, f)).

    With an active ``codec``, ``sp`` must already carry the codec's
    per-message bits (``compression.message_bits``) so the allocation
    and eqs. (7)-(12) price the compressed payload; ``codec_state`` is
    ``(dev_resid, edge_resid)`` for the cohort (H, ...) and the edges
    (M, ...), and ``noise`` the round's int8 noise source. The return
    then becomes ``(new_params, (new_dev_resid, new_edge_resid), aux)``.
    """
    H = assign.shape[0]
    with phase(stopwatch, "allocate"):
        edge_mask = assign[None, :] == torch.arange(
            M, device=assign.device)[:, None]                   # (M, H)
        res = ra.allocate_batch(
            sp, u.expand(M, H), D.expand(M, H), p.expand(M, H), g.T, B_m,
            edge_mask, steps=alloc_steps)
        b, f = ra.select_device_allocation(res, assign)         # (H,) each
        g_sel = g[torch.arange(H, device=assign.device), assign]
        T_i, E_i, T_m, E_m = cm.round_cost_gathered(
            sp, u, D, p, g_sel, g_cloud, assign, b, f, M)
    if codec is not None and codec.active:
        dev_resid, edge_resid = codec_state
        new_params, dev_resid, edge_resid = hfl_global_iteration_core(
            apply_fn, params, X, y, mask, sizes, assign, M=M, L=L, Q=Q,
            lr=lr, agg_kernel=agg_kernel, codec=codec, dev_resid=dev_resid,
            edge_resid=edge_resid, noise=noise, stopwatch=stopwatch)
        return new_params, (dev_resid, edge_resid), (T_i, E_i, T_m, E_m,
                                                     b, f)
    new_params = hfl_global_iteration_core(
        apply_fn, params, X, y, mask, sizes, assign, M=M, L=L, Q=Q, lr=lr,
        agg_kernel=agg_kernel, stopwatch=stopwatch)
    return new_params, (T_i, E_i, T_m, E_m, b, f)


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
            params_from_numpy(init_params, self.device)
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
        cfg, fed, sp = self.cfg, self.fed, self.sp
        h = max(1, cfg.H // cfg.K)
        if cfg.scheduler == "fedavg":
            self.scheduler = FedAvgScheduler(fed.n_devices, cfg.H)
            return
        sw = Stopwatch(self.device)
        with sw.phase("cluster"):
            if cfg.scheduler == "ikc":
                # auxiliary mini model ξ on 1x10x10 random crops
                mini_params = self.spec.mini_init_fn(self.generator, fed,
                                                     self.device)
                compute_scale = (tree_bytes(mini_params)
                                 / max(1, tree_bytes(self.model_params)))
                aux_bits = tree_bytes(mini_params) * 8
                if labels is None:
                    crop = self.spec.mini_preprocess_fn(self.X,
                                                        self.generator)
                    labels, _ = run_device_clustering(
                        self.spec.mini_apply_fn, mini_params, crop, self.y,
                        self.mask, cfg.K, sp.L, cfg.lr,
                        use_kernel=cfg.use_kernel, generator=self.generator)
            else:  # vkc: heavyweight global model as auxiliary model
                aux_bits, compute_scale = self.model_bits, 1.0
                if labels is None:
                    labels, _ = run_device_clustering(
                        self.apply_fn, self.model_params, self.X, self.y,
                        self.mask, cfg.K, sp.L, cfg.lr,
                        use_kernel=cfg.use_kernel, generator=self.generator)
        labels = np.asarray(labels)
        if labels.shape != (fed.n_devices,):
            raise ValueError(f"labels must have shape ({fed.n_devices},), "
                             f"got {labels.shape}")
        policy = IKCScheduler if cfg.scheduler == "ikc" else VKCScheduler
        self.scheduler = policy(labels, h)
        self.setup_seconds = dict(sw.seconds)
        delay, energy = clustering_cost(sp, self.pop, aux_bits,
                                        compute_scale=compute_scale)
        self.clustering_stats = {
            "ari": adjusted_rand_index(labels, fed.majority_class),
            "delay_s": delay, "energy_j": energy,
            "aux_bits": float(aux_bits)}

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
        sp, pop, dev = self.sp, self.pop, self.device
        sw = Stopwatch(dev)
        with sw.phase("schedule"):
            sched = np.asarray(self.scheduler.schedule(self.rng))
        t0 = time.perf_counter()
        with sw.phase("assign"):
            assign, _ = self.assigner.assign(pop, sched, self.rng)
            assign = np.asarray(assign)
        assign_latency = time.perf_counter() - t0
        H = len(sched)

        s = torch.from_numpy(sched.astype(np.int64)).to(dev)
        a = torch.from_numpy(assign.astype(np.int64)).to(dev)
        args = (pop.u[s], pop.D[s], pop.p[s], pop.g[s], pop.g_cloud,
                pop.B_m, self.X[s], self.y[s], self.mask[s], pop.D[s], a,
                self.cfg.lr)
        kw = dict(M=pop.n_edges, L=sp.L, Q=sp.Q,
                  alloc_steps=self.cfg.alloc_steps,
                  agg_kernel=self.cfg.agg_kernel, stopwatch=sw)
        if self.cfg.engine == "sequential":
            T_i, E_i = self._sequential_alloc_cost_train(s, a, sw)
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

        with sw.phase("eval"):
            acc = self.spec.eval_fn(self.model_params,
                                    self.fed.X_test, self.fed.y_test)
        msg_bits = cm.round_msg_bits(sp, sp.Q * H, pop.n_edges,
                                     msg_bits=self.uplink_bits)
        rec = {"iter": i, "acc": acc, "T_i": float(T_i), "E_i": float(E_i),
               "obj_i": float(E_i + sp.lam * T_i),
               "msg_bits": float(msg_bits),
               "uplink_bytes": float(sp.Q * H * self.uplink_bits / 8),
               "codec": self.codec.codec,
               "assign_latency_s": assign_latency,
               "H": H, "seconds": dict(sw.seconds)}
        self.history.append(rec)
        return rec

    def _sequential_alloc_cost_train(self, s, a, sw: Stopwatch):
        """The per-edge oracle of the fused engine: M separate
        allocations, ``round_cost``, then Algorithm 1 with the plain
        aggregation. s, a: (H,) int64 cohort and assignment."""
        sp, pop = self.sp, self.pop
        H = s.shape[0]
        with sw.phase("allocate"):
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
            lr=self.cfg.lr, stopwatch=sw)
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
