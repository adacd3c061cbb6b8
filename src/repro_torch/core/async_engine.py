"""Event-driven asynchronous HFL engine: arrivals, dropouts, stragglers.

Port of ``repro.core.async_engine``. One HFL global iteration runs as a
discrete-event simulation on a virtual clock:

* Scheduling, assignment and the convex resource allocation (27) are
  those of the synchronous round: ``_alloc_and_price`` solves every
  edge's allocation in one ``allocate_batch`` call, as
  ``framework.round_step_core`` does, and prices each device's task with
  the per-device eq. (4)-(8) time and energy.
* Each dispatched device runs its L local GD steps (Algorithm 1's inner
  loop) and returns its update at a trace-determined virtual time,
  ``(t_cmp + t_com) * latency_scale`` (straggler inflation, optional
  log-normal jitter), driven by an
  :class:`~repro_torch.core.cost_model.AvailabilityTrace` of arrival and
  dropout flips.
* Edge servers aggregate FedBuff-style staleness-weighted buffers: an
  update trained against edge version ``v`` merges at version ``V`` with
  weight ``D_n / (1 + (V - v))**a`` (eq. (2) generalised); the data mass
  of cohort members with nothing in the buffer anchors on the current
  edge model. After Q flushes an edge uploads to the cloud, which
  aggregates with the eq.-(3) cohort-data-size weights.
* Device state (dispatched, delivered, aborted) is a fixed-shape
  ``(H, ...)`` cohort tree updated under boolean masks: every dispatch
  trains the whole cohort and keeps the result on the dispatched rows.

The event loop (heap, toggles, dispatch, flush, forced drain) is host
numpy and draws from ``self.rng`` in the reference's order (scheduler,
assigner, then one jitter draw per dispatched task), so cohorts,
assignments and event sequences are the reference's. The device work
(training, flushes, the cloud aggregation) is queued without waiting:
the host reads the device once a round, for the task prices, and masks
and staleness go up as small non-blocking copies. The edge models are
materialised at the start of a round and updated in place; the cohort
rows are replaced, never written through (they start as a broadcast
view of the global model).

With an uplink codec each dispatch ships ``encode(trained - pulled +
resid)`` and buffers the edge's reconstruction; the cloud hop ships
``encode(edge - global)``. Each device's error-feedback residual lives
in ``dev_resid`` (all N devices: a round gathers its cohort's rows and
scatters them back), each edge's in ``edge_resid``. The int8 rounding
noise of round r comes from ``codec_noise(r)`` (default
``compression.round_noise``), a source called with hop ``1 + n`` for the
round's n-th compressed dispatch and :data:`CLOUD_HOP` for the cloud
upload. ``codec="none"`` takes the uncompressed path and encodes
nothing.

Parity: with ``AvailabilityTrace.always_on``, unit latency scale, no
jitter and wait-for-all buffers the event loop is the synchronous round:
the same b and f, T_i and E_i to float-accumulation order, and params to
the order of its sums (``tests/test_torch_async_engine.py`` measures the
gap).
"""
from __future__ import annotations

import dataclasses
import functools
import heapq
from typing import Callable, Dict, List, Mapping, Optional

import numpy as np
import torch

from repro_torch.configs.registry import get_hfl_spec
from repro_torch.convert import flatten_params, params_from_numpy
from repro_torch.core import compression as comp
from repro_torch.core import cost_model as cm
from repro_torch.core import resource as ra
from repro_torch.core.hfl import pad_device_data
from repro_torch.core.local_train import cohort_local_sgd
from repro_torch.data.partition import FederatedData
from repro_torch.utils import Params, resolve_device, tree_bytes

# noise hop of a round's cloud upload; the n-th dispatch (from 0) uses
# hop 1 + n
CLOUD_HOP = 0


# ------------------------------------------------------- device helpers

def _alloc_and_price(sp: cm.SystemParams, u, D, p, g, g_cloud, B_m, assign,
                     *, M: int, alloc_steps: int):
    """Cohort allocation and per-task pricing.

    u/D/p (H,), g (H, M), assign (H,) int64. The same all-edges
    ``allocate_batch`` / ``select_device_allocation`` pattern as
    ``framework.round_step_core``, returning each device's task time and
    energy ``tc``/``ec`` (H,) so the event loop can spend them task by
    task, and each edge's cloud-hop costs ``T_cl``/``E_cl`` (M,).
    """
    H = assign.shape[0]
    edge_mask = assign[None, :] == torch.arange(M, device=assign.device)[
        :, None]                                                # (M, H)

    def rows(x):                        # (H,) -> (M, H), one row an edge
        return x[None].expand(M, H).contiguous()

    res = ra.allocate_batch(sp, rows(u), rows(D), rows(p),
                            g.T.contiguous(), B_m, edge_mask,
                            steps=alloc_steps)
    b, f = ra.select_device_allocation(res, assign)            # (H,) each
    g_sel = g[torch.arange(H, device=assign.device), assign]
    tc = cm.t_cmp(sp, u, D, f) + cm.t_com(sp, b, g_sel, p)
    ec = cm.e_cmp(sp, u, D, f) + cm.e_com(sp, b, g_sel, p)
    T_cl, E_cl = cm.cloud_cost(sp, g_cloud)                     # (M,) each
    return b, f, tc, ec, T_cl, E_cl


def _read_prices(tc, ec, T_cl, E_cl):
    """The round's one device read: tc, ec, T_cl, E_cl as host f32."""
    host = torch.cat([tc, ec, T_cl, E_cl]).cpu().numpy()
    H, M = tc.shape[0], T_cl.shape[0]
    return np.split(host, [H, 2 * H, 2 * H + M])


def _upload(x: np.ndarray, device) -> torch.Tensor:
    """A small host array on ``device`` without waiting for the device
    (a pageable source is staged before the call returns)."""
    return torch.from_numpy(x).to(device, non_blocking=True)


def _row_mask(mask: torch.Tensor, leaf: torch.Tensor) -> torch.Tensor:
    return mask.reshape((-1,) + (1,) * (leaf.dim() - 1))


def _pull(cohort_params: Params, edge_params: Params, assign, dmask):
    """Each dispatched row starts from its edge's current model."""
    pulled = {k: e[assign] for k, e in edge_params.items()}
    src = {k: torch.where(_row_mask(dmask, c), pulled[k], c)
           for k, c in cohort_params.items()}
    return pulled, src


def _train_dispatched(apply_fn, cohort_params: Params, edge_params: Params,
                      assign, dmask, X, y, mask, lr, *, L: int) -> Params:
    """Pull edge models and run L local GD steps on the dispatched rows.

    Every row runs through ``cohort_local_sgd``, but only rows where
    ``dmask`` is set start from their edge's current model and keep the
    trained result.
    """
    _, src = _pull(cohort_params, edge_params, assign, dmask)
    trained = cohort_local_sgd(apply_fn, src, X, y, mask, L, lr)
    return {k: torch.where(_row_mask(dmask, c), trained[k], c)
            for k, c in cohort_params.items()}


def _train_dispatched_compressed(apply_fn, cohort_params: Params,
                                 edge_params: Params, assign, dmask, X, y,
                                 mask, lr, resid: Params, noise, *, L: int,
                                 codec: comp.CompressionConfig):
    """``_train_dispatched`` with the uplink codec applied.

    Dispatched rows train from their edge model, then ship
    ``encode(trained - pulled + resid)``; the buffered value is the
    edge-side reconstruction ``pulled + decode(...)`` (the flush is
    linear in the decoded update, so merging the reconstruction is
    merging the wire-format update). ``resid``: (H, ...) error-feedback
    rows of the cohort, updated only on dispatched rows, like the params.
    ``noise(leaf name, shape)``: the int8 uniforms.
    """
    pulled, src = _pull(cohort_params, edge_params, assign, dmask)
    trained = cohort_local_sgd(apply_fn, src, X, y, mask, L, lr)
    delta = {k: (trained[k] - q).float() for k, q in pulled.items()}
    dec, new_resid = comp.encode_decode(codec, delta, resid, noise)
    new_cohort = {k: torch.where(_row_mask(dmask, c),
                                 (pulled[k] + dec[k]).to(c.dtype), c)
                  for k, c in cohort_params.items()}
    new_resid = {k: torch.where(_row_mask(dmask, r), new_resid[k], r)
                 for k, r in resid.items()}
    return new_cohort, new_resid


def _flush_edge(edge_params: Params, cohort_params: Params, m: int,
                flush_in: torch.Tensor, sizes, a) -> None:
    """Staleness-weighted buffer flush for edge ``m`` (eq. (2) general),
    written into ``edge_params[k][m]`` in place.

    ``flush_in`` (3, H) f32: the delivered mask, the member mask and the
    staleness. Delivered members contribute with weight
    ``D_n / (1+staleness_n)**a``; the data mass of members with nothing
    in the buffer anchors on the current edge model, so a flush with a
    partial buffer moves the edge model in proportion to the fresh data
    it received. An edge whose weight mass is zero keeps its model.
    """
    deliver, member = flush_in[0] > 0, flush_in[1] > 0
    w_dev = sizes.float()
    decay = torch.pow(1.0 + flush_in[2], a)
    w_del = torch.where(deliver, w_dev / decay, 0.0)
    w_anchor = torch.sum(torch.where(member & ~deliver, w_dev, 0.0))
    tot = torch.sum(w_del) + w_anchor
    denom = torch.clamp_min(tot, 1.0)
    wn = w_del / denom
    wa = w_anchor / denom
    for k, e in edge_params.items():
        c = cohort_params[k]
        old = e[m].reshape(-1)
        new = wn @ c.reshape(c.shape[0], -1) + wa * old
        new = torch.where(tot > 0, new, old)
        e[m] = new.reshape(e.shape[1:]).to(e.dtype)


def _cloud_weights(assign, sizes, M: int) -> torch.Tensor:
    """(M,) eq.-(3) weights: each edge's cohort data mass, normalised;
    empty edges weigh 0."""
    onehot = torch.nn.functional.one_hot(assign, M).float()
    edge_tot = onehot.T @ sizes.float()
    w = torch.where(edge_tot > 0, edge_tot, 0.0)
    return w / torch.clamp_min(torch.sum(w), 1.0)


def _cloud_agg(edge_params: Params, assign, sizes, *, M: int) -> Params:
    """Eq. (3): cloud aggregation with cohort-data-size weights."""
    w = _cloud_weights(assign, sizes, M)
    return {k: (w @ e.reshape(M, -1)).reshape(e.shape[1:]).to(e.dtype)
            for k, e in edge_params.items()}


def _cloud_agg_compressed(edge_params: Params, global_params: Params,
                          assign, sizes, resid: Params, noise, *, M: int,
                          codec: comp.CompressionConfig):
    """Compressed eq. (3): each edge ships ``encode(edge - global)``, the
    cloud aggregates the decoded deltas with ``_cloud_agg``'s weights.
    Returns ``(new_global, new_edge_resid)``."""
    w = _cloud_weights(assign, sizes, M)
    delta = {k: (e - global_params[k][None]).float()
             for k, e in edge_params.items()}
    dec, new_resid = comp.encode_decode(codec, delta, resid, noise)
    new = {k: (g.reshape(-1) + w @ dec[k].reshape(M, -1)).reshape(
        g.shape).to(g.dtype) for k, g in global_params.items()}
    return new, new_resid


# ----------------------------------------------------------- the engine

@dataclasses.dataclass
class AsyncConfig:
    """Event-loop knobs. The defaults are the sync-parity setting:
    wait-for-all buffers, no jitter (pair with ``always_on`` traces)."""
    H: int = 20                     # scheduled cohort size
    arch: str = "hfl-cnn"           # model payload (configs.registry id)
    scheduler: str = "fedavg"       # fedavg | ikc | vkc
    K: int = 10                     # clusters (ikc/vkc)
    staleness_exp: float = 0.5      # a in D_n/(1+staleness)^a
    buffer_size: Optional[int] = None   # edge flush threshold; None =
                                        # wait for every in-flight member
    lr: float = 0.01
    alloc_steps: int = 100
    seed: int = 0
    jitter_sigma: float = 0.0       # per-task log-normal latency noise
    max_events_per_round: int = 100_000   # liveness guard
    compression: comp.CompressionConfig = dataclasses.field(
        default_factory=comp.CompressionConfig)
    device: str = "cuda"            # "cpu" must be asked for

    def __post_init__(self):
        resolve_device(self.device)


class AsyncHFLEngine:
    """Virtual-clock asynchronous HFL over an availability trace.

    ``step_round()`` runs one cloud round as a discrete-event loop:
    dispatch the scheduled cohort, deliver updates at trace-determined
    times, flush staleness-weighted edge buffers Q times per edge, then
    aggregate at the cloud and advance the virtual clock by the round's
    makespan. The setup mirrors ``HFLFramework``: the ``cfg.arch`` model
    spec, ``model_bits`` patched from the model, the scheduler from
    ``framework.build_scheduler`` (its Algorithm-2 ``labels`` may be
    injected) and ``GeoAssigner`` unless one is given. Where the
    reference draws from ``jax.random`` the port draws from a
    ``torch.Generator`` seeded with ``cfg.seed``, or takes the outcome:
    ``init_params`` (the initial weights, numpy or tensors) and
    ``codec_noise`` (round index -> int8 noise source).
    """

    def __init__(self, sp: cm.SystemParams, pop: cm.Population,
                 fed: FederatedData, cfg: AsyncConfig,
                 trace: Optional[cm.AvailabilityTrace] = None,
                 scheduler=None, assigner=None,
                 init_params: Optional[Mapping] = None,
                 labels: Optional[np.ndarray] = None,
                 codec_noise: Optional[
                     Callable[[int], comp.NoiseSource]] = None):
        self.pop, self.cfg, self.fed = pop, cfg, fed
        self.device = resolve_device(cfg.device)
        self.spec = get_hfl_spec(cfg.arch)
        self.model_params = (
            flatten_params(params_from_numpy(init_params, self.device))
            if init_params is not None
            else self.spec.init_fn(torch.Generator().manual_seed(cfg.seed),
                                   fed, self.device))
        self.apply_fn = self.spec.apply_fn
        self.sp = dataclasses.replace(
            sp, model_bits=float(tree_bytes(self.model_params) * 8))
        # allocation and pricing see the codec's bits per message;
        # codec="none" gives exactly model_bits
        self.codec = cfg.compression
        self.uplink_bits = comp.message_bits(self.codec, self.model_params)
        self.sp_round = dataclasses.replace(
            self.sp, model_bits=float(self.uplink_bits))
        self.dev_resid = comp.init_state(self.codec, self.model_params,
                                         fed.n_devices)
        self.edge_resid = comp.init_state(self.codec, self.model_params,
                                          pop.n_edges)
        self.codec_noise = codec_noise or functools.partial(
            comp.round_noise, self.codec, cfg.seed, device=self.device)
        self.X, self.y, self.mask = pad_device_data(fed, device=self.device)

        if scheduler is None:
            from repro_torch.core.framework import build_scheduler
            scheduler = build_scheduler(
                cfg.scheduler, fed, self.sp, cfg.H, K=cfg.K, lr=cfg.lr,
                seed=cfg.seed, arch=cfg.arch, labels=labels,
                device=self.device)
        self.scheduler = scheduler
        if assigner is None:
            from repro_torch.core.assignment import GeoAssigner
            assigner = GeoAssigner(self.sp)
        self.assigner = assigner

        self.trace = trace or cm.AvailabilityTrace.always_on(pop.n_devices)
        if self.trace.n_devices != pop.n_devices:
            raise ValueError("availability trace / population size "
                             f"mismatch: {self.trace.n_devices} vs "
                             f"{pop.n_devices}")
        self.rng = np.random.default_rng(cfg.seed)
        self.t = 0.0                    # virtual clock [s]
        self.round = 0
        self.history: List[Dict] = []
        self.last_sched: Optional[np.ndarray] = None
        self.last_assign: Optional[np.ndarray] = None
        self.last_alloc = None          # (b, f, tc, ec) of the last round

    # ------------------------------------------------------------ round

    def step_round(self, collect_eval: bool = True) -> Dict:
        sp, pop, cfg, dev = self.sp, self.pop, self.cfg, self.device
        M, Q = pop.n_edges, sp.Q
        t0 = self.t

        sched = np.asarray(self.scheduler.schedule(self.rng))
        assign_np, _ = self.assigner.assign(pop, sched, self.rng)
        assign_np = np.asarray(assign_np)
        self.last_sched, self.last_assign = sched, assign_np
        H = len(sched)
        s_idx = torch.from_numpy(sched.astype(np.int64)).to(dev)
        assign = torch.from_numpy(assign_np.astype(np.int64)).to(dev)
        sizes = pop.D[s_idx]

        b, f, tc, ec, T_cl, E_cl = _alloc_and_price(
            self.sp_round, pop.u[s_idx], pop.D[s_idx], pop.p[s_idx],
            pop.g[s_idx], pop.g_cloud, pop.B_m, assign, M=M,
            alloc_steps=cfg.alloc_steps)
        self.last_alloc = (b, f, tc, ec)
        tc_h, ec_h, T_cl_h, E_cl_h = _read_prices(tc, ec, T_cl, E_cl)
        ec_h = ec_h.astype(np.float64)
        lat = tc_h.astype(np.float64) * self.trace.latency_scale[sched]

        codec_on = self.codec.active
        cohort_resid, noise = None, None
        if codec_on:
            cohort_resid = {k: r[s_idx] for k, r in self.dev_resid.items()}
            noise = self.codec_noise(self.round)

        Xc, yc, mc = self.X[s_idx], self.y[s_idx], self.mask[s_idx]
        # edges: materialised (flushes write rows in place); cohort: a
        # broadcast view, only ever replaced
        edge_params = {k: g[None].repeat((M,) + (1,) * g.dim())
                       for k, g in self.model_params.items()}
        cohort_params = {k: g[None].expand((H,) + tuple(g.shape))
                         for k, g in self.model_params.items()}
        a_exp = torch.full((), cfg.staleness_exp, dtype=torch.float32,
                           device=dev)

        # --- per-slot event-loop state (cohort-indexed)
        up = self.trace.up_at(t0)[sched].copy()      # (H,) availability
        delivered = np.zeros(H, bool)                # in an edge buffer
        task_id = np.full(H, -1, np.int64)           # -1 = idle/aborted
        start_ver = np.zeros(H, np.int64)            # edge ver at dispatch
        edge_ver = np.zeros(M, np.int64)
        flushes = np.zeros(M, np.int64)
        edge_finish = np.full(M, t0, np.float64)
        edge_energy = np.zeros(M, np.float64)        # aggregated-task J
        members = [np.flatnonzero(assign_np == m) for m in range(M)]
        for m in range(M):                           # empty edges: done,
            if len(members[m]) == 0:                 # cloud hop only
                flushes[m] = Q
        stats = {"n_agg": 0, "n_stale": 0, "max_stale": 0,
                 "n_aborted": 0, "wasted_j": 0.0, "n_disp": 0}

        heap: list = []
        seq = 0
        next_task = 0
        tog_rows = [self.trace.toggles[d] for d in sched]
        tog_ptr = [int(np.searchsorted(row, t0, side="right"))
                   for row in tog_rows]

        def push(t, kind, payload):
            nonlocal seq
            heapq.heappush(heap, (t, seq, kind, payload))
            seq += 1

        for s in range(H):
            i = tog_ptr[s]
            if i < len(tog_rows[s]) and np.isfinite(tog_rows[s][i]):
                push(float(tog_rows[s][i]), "toggle", s)

        def dispatch(slots, t):
            nonlocal cohort_params, cohort_resid, next_task
            slots = [s for s in slots
                     if up[s] and not delivered[s] and task_id[s] < 0
                     and flushes[assign_np[s]] < Q]
            if not slots:
                return
            dmask = np.zeros(H, bool)
            dmask[slots] = True
            dmask = _upload(dmask, dev)
            if codec_on:
                cohort_params, cohort_resid = _train_dispatched_compressed(
                    self.apply_fn, cohort_params, edge_params, assign, dmask,
                    Xc, yc, mc, cfg.lr, cohort_resid,
                    functools.partial(noise, 1 + stats["n_disp"]), L=sp.L,
                    codec=self.codec)
            else:
                cohort_params = _train_dispatched(
                    self.apply_fn, cohort_params, edge_params, assign, dmask,
                    Xc, yc, mc, cfg.lr, L=sp.L)
            stats["n_disp"] += 1
            for s in slots:
                start_ver[s] = edge_ver[assign_np[s]]
                task_id[s] = next_task
                next_task += 1
                mult = 1.0
                if cfg.jitter_sigma > 0:
                    mult = float(np.exp(
                        self.rng.normal(0.0, cfg.jitter_sigma)))
                push(t + lat[s] * mult, "done", (s, task_id[s]))

        def do_flush(m, t, redispatch=True):
            mem = members[m]
            del_mask = np.zeros(H, bool)
            del_mask[mem] = delivered[mem]
            stal = np.where(del_mask, edge_ver[m] - start_ver, 0)
            flush_in = np.zeros((3, H), np.float32)
            flush_in[0] = del_mask
            flush_in[1, mem] = 1.0
            flush_in[2] = stal
            _flush_edge(edge_params, cohort_params, m,
                        _upload(flush_in, dev), sizes, a_exp)
            d_slots = np.flatnonzero(del_mask)
            edge_energy[m] += float(ec_h[d_slots].sum())
            stats["n_agg"] += len(d_slots)
            if len(d_slots):
                s_max = int(stal[d_slots].max())
                stats["max_stale"] = max(stats["max_stale"], s_max)
                stats["n_stale"] += int((stal[d_slots] > 0).sum())
            delivered[d_slots] = False
            edge_ver[m] += 1
            flushes[m] += 1
            if flushes[m] >= Q:
                edge_finish[m] = t
            elif redispatch:
                dispatch(list(d_slots), t)

        def should_flush(m):
            if flushes[m] >= Q:
                return False
            mem = members[m]
            n_del = int(delivered[mem].sum())
            in_flight = int((task_id[mem] >= 0).sum())
            if n_del > 0 and in_flight == 0:
                return True          # buffer drained: nothing to wait on
            return (cfg.buffer_size is not None
                    and n_del >= min(cfg.buffer_size, len(mem)))

        # --- run the round
        dispatch(list(np.flatnonzero(up)), t0)
        events = 0
        while not np.all(flushes >= Q):
            if not heap or events >= cfg.max_events_per_round:
                break                # liveness guard: forced drain below
            t, _, kind, payload = heapq.heappop(heap)
            events += 1
            self.t = max(self.t, t)
            if kind == "toggle":
                s = payload
                tog_ptr[s] += 1
                i = tog_ptr[s]
                if i < len(tog_rows[s]) and np.isfinite(tog_rows[s][i]):
                    push(float(tog_rows[s][i]), "toggle", s)
                up[s] = not up[s]
                m = int(assign_np[s])
                if up[s]:
                    dispatch([s], t)         # mid-round arrival
                else:
                    if task_id[s] >= 0:      # dropout aborts in-flight
                        task_id[s] = -1
                        stats["wasted_j"] += float(ec_h[s])
                        stats["n_aborted"] += 1
                    if should_flush(m):
                        do_flush(m, t)
            else:                            # task completion
                s, tid = payload
                if tid != task_id[s]:
                    continue                 # aborted / superseded task
                task_id[s] = -1
                m = int(assign_np[s])
                if flushes[m] >= Q:          # edge already uploaded
                    stats["wasted_j"] += float(ec_h[s])
                    stats["n_aborted"] += 1
                    continue
                delivered[s] = True
                if should_flush(m):
                    do_flush(m, t)

        forced = int(np.maximum(Q - flushes, 0).sum())
        for m in range(M):                   # forced drain (liveness)
            while flushes[m] < Q:
                do_flush(m, self.t, redispatch=False)
        heap.clear()

        # --- round totals + eq.-(3) cloud aggregation
        T_m = (edge_finish - t0) + T_cl_h.astype(np.float64)
        T_round = float(T_m.max()) if M else 0.0
        E_round = float(edge_energy.sum() + E_cl_h.sum())
        if codec_on:
            self.model_params, self.edge_resid = _cloud_agg_compressed(
                edge_params, self.model_params, assign, sizes,
                self.edge_resid, functools.partial(noise, CLOUD_HOP), M=M,
                codec=self.codec)
            for k, full in self.dev_resid.items():   # scatter the cohort
                full[s_idx] = cohort_resid[k]        # rows back
        else:
            self.model_params = _cloud_agg(edge_params, assign, sizes, M=M)
        self.t = t0 + T_round
        self.round += 1

        acc = None
        if collect_eval:
            acc = self.spec.eval_fn(self.model_params, self.fed.X_test,
                                    self.fed.y_test)
        rec = {"round": self.round, "t": self.t, "acc": acc,
               "T_i": T_round, "E_i": E_round,
               "obj_i": E_round + sp.lam * T_round,
               "H": H, "n_updates": stats["n_agg"],
               "n_stale": stats["n_stale"],
               "max_staleness": stats["max_stale"],
               "n_aborted": stats["n_aborted"],
               "wasted_j": stats["wasted_j"],
               "forced_flushes": forced,
               "msg_bits": cm.round_msg_bits(self.sp, stats["n_agg"], M,
                                             msg_bits=self.uplink_bits),
               "uplink_bytes": float(
                   (stats["n_agg"] + M) * self.uplink_bits / 8),
               "codec": self.codec.codec,
               "n_dispatches": stats["n_disp"]}
        self.history.append(rec)
        return rec

    # ------------------------------------------------------ conveniences

    def run(self, n_rounds: int, target_acc: Optional[float] = None,
            eval_every: int = 1, verbose: bool = False) -> Dict:
        for r in range(1, n_rounds + 1):
            rec = self.step_round(
                collect_eval=eval_every > 0 and r % eval_every == 0)
            if verbose:
                acc = "-" if rec["acc"] is None else f"{rec['acc']:.3f}"
                print(f"  [async] round {rec['round']:3d} t={rec['t']:9.1f}s"
                      f" acc={acc} updates={rec['n_updates']}"
                      f" stale={rec['n_stale']} wasted={rec['wasted_j']:.1f}J")
            if (target_acc is not None and rec["acc"] is not None
                    and rec["acc"] >= target_acc):
                break
        return self.summary()

    def summary(self) -> Dict:
        evals = [r for r in self.history if r["acc"] is not None]
        T = sum(r["T_i"] for r in self.history)
        E = sum(r["E_i"] for r in self.history)
        return {"rounds": len(self.history), "t_virtual": self.t,
                "final_acc": evals[-1]["acc"] if evals else None,
                "T": T, "E": E, "objective": E + self.sp.lam * T,
                "n_updates": sum(r["n_updates"] for r in self.history),
                "n_stale": sum(r["n_stale"] for r in self.history),
                "n_aborted": sum(r["n_aborted"] for r in self.history),
                "wasted_j": sum(r["wasted_j"] for r in self.history),
                "history": self.history}
