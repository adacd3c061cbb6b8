"""Batched simulation sweeps over the lane-batched round engine (port of
``repro.core.sweep``).

The paper's headline experiments (Figs. 3-7, Table II) are grids of
(scheduler x assigner x scheduling ratio x seed) cells, each a full
multi-round HFL simulation. ``SweepRunner`` stacks S independent worlds
(population + federated data) along a leading lane axis and runs every
round of every lane as one lane-batched round (``round_step_lanes``):
one allocation over all S·M edges, one training pass over all S·H
devices and, with ``agg_kernel=True``, one aggregation launch a hop for
all lanes and leaves. Scheduling ratios change the cohort shape H, so
each ratio is its own run (lanes within a ratio share one).

``lane_chunk=k`` runs the lanes in sequential chunks of k (less memory
at the same per-lane result), and ``run(fused=True)`` runs the whole
R-round sweep — scheduling, assignment, rounds, eval and done-masks —
on the device with no host synchronisation between the first round and
the last (``sweep_scan``); ``fused="oracle"`` runs the same step with a
read-back after each round. ``shard=True`` lays the lanes over the ranks
of a 1-D ``("lane",)`` mesh (``launch.mesh.sweep_mesh``): each rank runs
the same engines on its contiguous block of lanes, on its own device,
with no collective inside a round (``sweep_round_sharded``,
``sweep_scan_sharded``); the per-round records are gathered over the
group, so every rank returns the unsharded result.

Semantics per lane match ``HFLFramework`` with ``engine="fused"``:
Algorithm-1 training weighted by the cost-model dataset sizes pop.D,
all-edges convex resource allocation, and round costs (13)/(14). Where
the reference draws from ``jax.random``, the port takes the outcome as
an input or draws its own: ``init_params`` (S initial weight trees;
otherwise a ``torch.Generator`` seeded with ``model_seed``),
``build_scheduler(labels=)`` (the Algorithm-2 clustering),
``codec_noise`` ((lane seed, round) -> int8 noise source; default
``compression.round_noise``), and the counter-based draws of
``TracedFedAvg`` and the fused HFEL search.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Callable, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch
import torch.distributed as dist
from torch.func import vmap

from repro_torch import trace
from repro_torch.configs.registry import get_hfl_spec
from repro_torch.convert import lanes_from_numpy, params_from_numpy
from repro_torch.core import compression as comp
from repro_torch.core import cost_model as cm
from repro_torch.core.assignment.drl import DRLAssigner, drl_assign_traced
from repro_torch.core.assignment.geo import GeoAssigner, geo_assign_traced
from repro_torch.core.assignment.hfel import HFELAssigner, hfel_search_traced
from repro_torch.core.framework import build_scheduler, round_step_lanes
from repro_torch.core.hfl import pad_device_data
from repro_torch.core.scheduling.schedulers import TracedFedAvg, _topup
from repro_torch.data.partition import FederatedData
from repro_torch.parallel.sharding import mesh_axes, pad_lanes
from repro_torch.utils import resolve_device, tree_bytes, tree_map


def _draw_cohorts(schedulers: Sequence, rngs: Sequence, N: int,
                  prev: Optional[Sequence] = None,
                  done: Optional[np.ndarray] = None,
                  width: Optional[Callable[[int], int]] = None
                  ) -> Tuple[List[np.ndarray], int]:
    """One round's cohorts of all lanes on the host, in the rng order the
    host loop and the fused precompute share: every live lane's schedule
    draw, then the top-ups. A done lane reuses its ``prev`` cohort and
    draws nothing. IKC/VKC lanes can come up short of the nominal cohort
    when a lane's clustering left clusters empty (K' < K); the short
    lanes are topped up from their unscheduled pool (Alg. 3/4 lines
    12-15) to the round's largest cohort, so every lane shares one
    (S, H) shape, through the scheduler's ``topup_to`` where it has one
    (IKC records the extra picks in its rotation state). ``width`` maps
    the largest cohort of these lanes to the round's (a sharded sweep's
    maximum over every rank's lanes). Returns (cohorts, the round's
    width H)."""
    scheds = [prev[s] if done is not None and done[s]
              else np.asarray(sched.schedule(rngs[s]))
              for s, sched in enumerate(schedulers)]
    H = max((len(c) for c in scheds), default=0)
    if width is not None:
        H = width(H)
    return [np.asarray(sched.topup_to(c, H, rng)
                       if hasattr(sched, "topup_to")
                       else _topup(list(c), N, H, rng))
            if len(c) < H else c
            for sched, rng, c in zip(schedulers, rngs, scheds)], H


def _lane_take(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Rows ``idx`` (S, H) of each lane of x (S, N, ...) -> (S, H, ...)."""
    return x[torch.arange(x.shape[0], device=x.device)[:, None], idx]


def _sweep_round_lanes(apply_fn, sp, params_b, u_b, D_b, p_b, g_b,
                       g_cloud_b, B_m_b, X_b, y_b, mask_b, sizes_b, sched_b,
                       assign_b, lr, done_b, codec_state_b, codec_noise_b, *,
                       M, L, Q, alloc_steps, train_only, agg_kernel, codec):
    """One round of a block of lanes: gather each lane's cohort (and,
    with a codec, its cohort's residual rows), run ``round_step_lanes``
    and scatter the residual rows back."""
    def take(x):
        return _lane_take(x, sched_b)

    codec_on = codec is not None and codec.active
    kw = {}
    if codec_on:
        dev_resid, edge_resid = codec_state_b
        kw = dict(codec=codec, noise=codec_noise_b, codec_state=(
            {k: take(r) for k, r in dev_resid.items()}, edge_resid))
    out = round_step_lanes(
        apply_fn, sp, params_b, take(u_b), take(D_b), take(p_b), take(g_b),
        g_cloud_b, B_m_b, take(X_b), take(y_b), take(mask_b), take(sizes_b),
        assign_b, lr, M=M, L=L, Q=Q, alloc_steps=alloc_steps,
        agg_kernel=agg_kernel, train_only=train_only, done=done_b, **kw)
    costs = out[-1][:2]
    if not codec_on:
        return out[0], costs
    cohort, new_edge = out[1]
    lanes = torch.arange(sched_b.shape[0], device=sched_b.device)[:, None]
    new_dev = {}
    for k, full in dev_resid.items():
        # done lanes come back with their old rows, so they stay frozen
        full = full.clone()
        full[lanes, sched_b] = cohort[k]
        new_dev[k] = full
    return out[0], costs, (new_dev, new_edge)


def sweep_round(apply_fn, sp: cm.SystemParams, params_b, u_b, D_b, p_b,
                g_b, g_cloud_b, B_m_b, X_b, y_b, mask_b, sizes_b, sched_b,
                assign_b, lr, *, M: int, L: int, Q: int, alloc_steps: int,
                train_only: bool = False, agg_kernel: bool = False,
                lane_chunk: Optional[int] = None, done_b=None,
                codec: Optional[comp.CompressionConfig] = None,
                codec_state_b=None,
                codec_noise_b: Optional[Sequence[comp.NoiseSource]] = None):
    """One round for S lanes at once.

    Population/data tensors carry a leading lane axis (S, ...); sched_b
    and assign_b are (S, H) int64; sizes_b (S, N) holds the Algorithm-1
    aggregation weights. Gathers each lane's cohort and runs the
    lane-batched round, returning (params_b, (T_i, E_i)) with (S,) cost
    vectors. ``train_only`` skips allocation and pricing (zero costs).
    ``agg_kernel`` routes every hop of every lane through one K1 (or,
    compressed, K4) call. ``done_b``: optional (S,) bool mask of lanes
    that reached the sweep's accuracy target — their params pass through
    unchanged and their T_i/E_i are 0. ``lane_chunk``: None runs the
    whole lane axis as one batch, an int runs the lanes in sequential
    chunks of that size (must divide S).

    With an active ``codec``: ``codec_state_b`` is ``(dev_resid
    (S, N, ...), edge_resid (S, M, ...))`` (cohort rows gathered and
    scattered per lane, frozen on done lanes like the params),
    ``codec_noise_b`` one int8 noise source a lane for this round, and
    the return gains a third element, the updated state.
    """
    S = sched_b.shape[0]
    if done_b is None:
        done_b = torch.zeros((S,), dtype=torch.bool, device=sched_b.device)
    lane_in = (params_b, u_b, D_b, p_b, g_b, g_cloud_b, B_m_b, X_b, y_b,
               mask_b, sizes_b, sched_b, assign_b)
    kw = dict(M=M, L=L, Q=Q, alloc_steps=alloc_steps, train_only=train_only,
              agg_kernel=agg_kernel, codec=codec)
    if lane_chunk is None:
        return _sweep_round_lanes(apply_fn, sp, *lane_in, lr, done_b,
                                  codec_state_b, codec_noise_b, **kw)
    if S % lane_chunk != 0:
        raise ValueError(f"lane_chunk={lane_chunk} must divide the lane "
                         f"axis ({S})")
    outs = []
    for lo in range(0, S, lane_chunk):
        def cut(tree):
            return tree_map(lambda x: None if x is None
                            else x[lo:lo + lane_chunk], tree)
        outs.append(_sweep_round_lanes(
            apply_fn, sp, *cut(lane_in), lr, cut(done_b),
            cut(codec_state_b),
            None if codec_noise_b is None
            else codec_noise_b[lo:lo + lane_chunk], **kw))
    return tree_map(lambda *xs: torch.cat(xs), outs[0], *outs[1:])


@torch.no_grad()
def sweep_eval(apply_fn, params_b, Xt_b, yt_b, batch: int = 512
               ) -> torch.Tensor:
    """(S,) f64 test accuracy of every lane, on the device: batches of
    ``batch`` samples, correct answers counted as integers, so the result
    is each lane's exact accuracy. Xt_b (S, n, ...), yt_b (S, n)."""
    S, n = yt_b.shape
    fn = vmap(apply_fn)
    correct = torch.zeros((S,), dtype=torch.int64, device=yt_b.device)
    for i in range(0, n, batch):
        logits = fn(params_b, Xt_b[:, i:i + batch])
        correct = correct + (torch.argmax(logits, dim=-1)
                             == yt_b[:, i:i + batch]).sum(1)
    return correct.double() / n


# ------------------------------------------------------------ fused scan

_HFEL_FUSED_DEFAULTS = dict(n_transfer=40, n_exchange=80, n_candidates=16,
                            warm_steps=None, accept_top=4)


def sweep_scan(apply_fn, sp: cm.SystemParams, sp_assign, params_b, u_b,
               D_b, p_b, g_b, g_cloud_b, B_m_b, X_b, y_b, mask_b, sizes_b,
               dev_pos_b, edge_pos_b, Xt_b, yt_b, sched_rs, sched_state_b,
               assign_words_b, done_b, drl_params, lr, codec_state_b=None,
               codec_noise_b=None, r0: int = 0, *, M: int, L: int, Q: int,
               alloc_steps: int, train_only: bool = False,
               agg_kernel: bool = False, lane_chunk: Optional[int] = None,
               assign: str = "geo", hfel_cfg=None,
               target_acc: Optional[float] = None, n_rounds: int = 1,
               traced_sched: Optional[TracedFedAvg] = None,
               codec: Optional[comp.CompressionConfig] = None):
    """An R-round, S-lane sweep on the device, with no host
    synchronisation between its first round and its last.

    Each round: the schedule (row ``i`` of the precomputed (R, S, H)
    ``sched_rs`` of host schedulers, or a ``traced_sched.step`` of the
    carried (S, 2) ``sched_state_b``), the device assignment (``assign``
    in mod|geo|drl|hfel: ``sched % M``, ``geo_assign_traced``,
    ``drl_assign_traced`` with ``drl_params``, or ``hfel_search_traced``
    scoring with ``sp_assign`` and keyed by ``assign_words_b`` (S, W)
    plus the round index), the lane-batched round, the in-step eval,
    and the done-mask update: a lane's round is recorded, then its done
    flag absorbs ``acc >= target_acc``, freezing it from the next round
    on. Population/data tensors as in ``sweep_round``, plus dev_pos_b /
    edge_pos_b (S, ·, 2) positions and Xt_b / yt_b test stacks.

    Rounds are numbered from ``r0`` (the hfel key and the codec noise
    read it). Each round is a ``round`` span of the current tracer, unit
    ``(r0, r)``, holding its ``schedule`` (traced schedulers only),
    ``assign``, ``allocate``, ``train``, ``aggregate`` and ``eval``
    spans. With an active ``codec`` the error-feedback state
    ``codec_state_b`` is carried and ``codec_noise_b`` holds one
    round -> noise-source callable a lane.

    Returns ((params_b, done_b, sched_state_b, codec_state_b),
    (acc (R, S) f64, T_i (R, S), E_i (R, S))), all on the device.
    """
    hfel_kw = dict(hfel_cfg or ())
    codec_on = codec is not None and codec.active
    S = done_b.shape[0]
    accs, Ts, Es = [], [], []
    for i in range(n_rounds):
        r = r0 + i
        with trace.span("round", unit=(r0, r)):
            if traced_sched is None:
                sched_b = sched_rs[i]
            else:
                with trace.span("schedule"):
                    sched_state_b, sched_b = traced_sched.step(sched_state_b)
            with trace.span("assign"):
                if assign == "mod":
                    assign_b = sched_b % M
                elif assign == "geo":
                    assign_b = geo_assign_traced(dev_pos_b, edge_pos_b,
                                                 sched_b)
                elif assign == "drl":
                    assign_b = drl_assign_traced(drl_params, u_b, D_b, p_b,
                                                 g_b, sched_b)
                else:
                    words = torch.cat([assign_words_b,
                                       assign_words_b.new_full((S, 1), r)],
                                      dim=1)
                    assign_b, _ = hfel_search_traced(
                        sp_assign, _lane_take(u_b, sched_b),
                        _lane_take(D_b, sched_b), _lane_take(p_b, sched_b),
                        _lane_take(g_b, sched_b), B_m_b, g_cloud_b, words,
                        alloc_steps=alloc_steps, **hfel_kw)
            kw = {}
            if codec_on:
                kw = dict(codec=codec, codec_state_b=codec_state_b,
                          codec_noise_b=[f(r) for f in codec_noise_b])
            out = sweep_round(
                apply_fn, sp, params_b, u_b, D_b, p_b, g_b, g_cloud_b, B_m_b,
                X_b, y_b, mask_b, sizes_b, sched_b, assign_b, lr, M=M, L=L,
                Q=Q, alloc_steps=alloc_steps, train_only=train_only,
                agg_kernel=agg_kernel, lane_chunk=lane_chunk, done_b=done_b,
                **kw)
            params_b, (T_i, E_i) = out[0], out[1]
            if codec_on:
                codec_state_b = out[2]
            with trace.span("eval"):
                acc = sweep_eval(apply_fn, params_b, Xt_b, yt_b)
                if target_acc is not None:
                    done_b = done_b | (acc >= target_acc)
        accs.append(acc)
        Ts.append(T_i)
        Es.append(E_i)
    return ((params_b, done_b, sched_state_b, codec_state_b),
            (torch.stack(accs), torch.stack(Ts), torch.stack(Es)))


# ------------------------------------------------------ lane sharding

def gather_lanes(x, mesh):
    """Concatenate every rank's block of a lane-major array (numpy, or a
    tensor, returned on its device) over the 1-D lane ``mesh``'s group,
    in rank order: (block, ...) -> (S_pad, ...). Each rank's own block
    is kept as it is."""
    group = mesh.get_group()
    if dist.get_world_size(group) == 1:
        return x
    host = x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else x
    parts = [None] * dist.get_world_size(group)
    dist.all_gather_object(parts, host, group=group)
    parts[dist.get_rank(group)] = host
    out = np.concatenate(parts)
    return (torch.as_tensor(out, device=x.device)
            if isinstance(x, torch.Tensor) else out)


def sweep_round_sharded(apply_fn, sp: cm.SystemParams, params_b, u_b, D_b,
                        p_b, g_b, g_cloud_b, B_m_b, X_b, y_b, mask_b,
                        sizes_b, sched_b, assign_b, lr, *, mesh, **kw):
    """``sweep_round`` laid out over a 1-D ``("lane",)`` mesh: every
    lane-stacked argument is this rank's contiguous block of the S_pad
    lanes (``SweepRunner`` pads S with dead, done-masked lanes), and the
    round runs on it as plain tensors on this rank's device, with no
    collective inside it (lanes are independent, as in the reference's
    ``shard_map``). Returns this rank's params block (and codec state)
    and the (S_pad,) T_i/E_i of every lane, gathered over the group.
    Other keywords as ``sweep_round``."""
    out = sweep_round(apply_fn, sp, params_b, u_b, D_b, p_b, g_b, g_cloud_b,
                      B_m_b, X_b, y_b, mask_b, sizes_b, sched_b, assign_b,
                      lr, **kw)
    T_i, E_i = out[1]
    return (out[0], (gather_lanes(T_i, mesh), gather_lanes(E_i, mesh)),
            *out[2:])


def sweep_scan_sharded(*args, mesh, **kw):
    """``sweep_scan`` over a 1-D ``("lane",)`` mesh: this rank's lane
    block runs the R rounds as ``sweep_scan`` does (its done-mask freezes
    its own lanes; nothing crosses ranks inside the scan), and the (R,
    block) accuracy and cost records are then gathered to (R, S_pad).
    Returns (this rank's carry, gathered records)."""
    carry, recs = sweep_scan(*args, **kw)
    return carry, tuple(gather_lanes(r.transpose(0, 1), mesh).transpose(0, 1)
                        for r in recs)


# ------------------------------------------------------- host assigners

def _mod_assign(pop: cm.Population, sched: np.ndarray, rng) -> np.ndarray:
    """Fixed round-robin assignment (Fig. 3/4 training-only sweeps)."""
    return np.asarray(sched) % pop.n_edges


def _geo_assign(pop: cm.Population, sched: np.ndarray, rng) -> np.ndarray:
    """Delegates to the canonical GeoAssigner (sp is unused by it)."""
    return np.asarray(GeoAssigner(None).assign(pop, sched, rng)[0])


ASSIGN_FNS: Dict[str, Callable] = {"mod": _mod_assign, "geo": _geo_assign}


def make_hfel_assign(sp: cm.SystemParams, *, n_transfer: int = 40,
                     n_exchange: int = 80, alloc_steps: int = 100,
                     n_candidates: int = 16) -> Callable:
    """Assignment callable driving the batched K-candidate HFEL search
    (``assign="hfel"`` in ``SweepRunner.run``), on the population's
    device. Reduced trial budget by default: sweeps re-assign every
    round."""
    assigner = HFELAssigner(sp, n_transfer=n_transfer,
                            n_exchange=n_exchange, alloc_steps=alloc_steps,
                            search="batched", n_candidates=n_candidates)

    def fn(pop: cm.Population, sched: np.ndarray, rng) -> np.ndarray:
        return np.asarray(assigner.assign(pop, sched, rng)[0])

    return fn


def make_drl_assign(sp: cm.SystemParams, params, device="cuda") -> Callable:
    """Assignment callable wrapping a trained D3QN agent (greedy) —
    ``assign="drl"`` in ``SweepRunner.run``. ``params``: the agent's
    parameters (the port's tensors or the reference's arrays), moved to
    ``device``."""
    assigner = DRLAssigner(sp, params_from_numpy(params, device))

    def fn(pop: cm.Population, sched: np.ndarray, rng) -> np.ndarray:
        return np.asarray(assigner.assign(pop, sched, rng)[0])

    return fn


def _iters(acc_a: np.ndarray, target_acc: Optional[float]) -> np.ndarray:
    """Rounds each lane took to reach ``target_acc`` (all when never)."""
    S, R = acc_a.shape
    if target_acc is None:
        return np.full(S, R)
    reached = acc_a >= target_acc
    return np.where(reached.any(axis=1), reached.argmax(axis=1) + 1, R)


class SweepRunner:
    """Multi-lane driver for the lane-batched round engine.

    worlds: list of (Population, FederatedData), one per sweep lane —
    identical shapes required (same N devices, M edges, test-set size).
    Each lane gets its own model init, scheduler state and host RNG; the
    per-round compute of ALL lanes is one lane-batched round on
    ``device`` (``"cuda"`` unless the caller passes ``"cpu"``; a missing
    card raises).

    lane_chunk=k runs the lanes in sequential chunks of k (must divide
    the lane block): less device memory for the same per-lane result.

    shard=True lays the lanes over the ranks of ``mesh`` (default
    ``launch.mesh.sweep_mesh()``; a mesh whose axes are not ``("lane",)``
    raises ``ValueError``, and so does a missing process group,
    ``RuntimeError``). S is padded to ``S_pad = pad_lanes(S, world)``
    with dead lanes, clones of lane 0 that are done from round 0 and
    whose outputs are discarded, and rank r holds lanes
    ``[r·block, (r+1)·block)``, ``block = S_pad / world``, on ``device``
    (with NCCL, this rank's card: ``cuda`` is the current device that
    ``init_group`` set). Every rank builds every lane's world and draws
    its own lanes' inits, schedules, assignments and codec noise from
    per-lane streams, so each lane draws as in the unsharded run; the
    round's cohort width and the per-round records (accuracy, T_i, E_i)
    are gathered over the group, and every rank returns the result dict
    of ``shard=False``.

    init_params: S initial weight trees (e.g. the reference's, as numpy);
    otherwise lane s draws its init s-th from one ``torch.Generator``
    seeded with ``model_seed``. codec_noise: (lane seed, round) -> the
    int8 noise source of that lane's round (default
    ``compression.round_noise``; both engines read it by lane seed and
    round, so they draw the same noise). After a ``run`` the final
    lane-stacked params are ``params_b``: all S lanes, or, sharded, this
    rank's block (lanes ``self.lanes``, dead ones included); to rebuild
    the (S, ...) stack on every rank, pass each leaf through
    ``gather_lanes(leaf, runner.mesh)`` and keep its first S rows.
    """

    def __init__(self, sp: cm.SystemParams,
                 worlds: Sequence[Tuple[cm.Population, FederatedData]],
                 *, lr: float = 0.01, alloc_steps: int = 100,
                 model_seed: int = 0, agg_kernel: bool = False,
                 shard: bool = False, mesh=None,
                 lane_chunk: Optional[int] = None,
                 compression: Optional[comp.CompressionConfig] = None,
                 arch: str = "hfl-cnn", init_params=None,
                 codec_noise: Optional[
                     Callable[[int, int], comp.NoiseSource]] = None,
                 device="cuda"):
        if not worlds:
            raise ValueError("a sweep needs at least one world")
        self.S = len(worlds)
        self.mesh = None
        self.S_pad = block = self.S
        if shard:
            if mesh is None:
                from repro_torch.launch.mesh import sweep_mesh
                mesh = sweep_mesh(device_type=torch.device(device).type)
            axes = mesh_axes(mesh)
            if tuple(axes) != ("lane",):
                raise ValueError("shard=True needs a 1-D ('lane',) mesh "
                                 f"(got axes {tuple(axes)})")
            self.mesh = mesh
            self.S_pad = pad_lanes(self.S, axes["lane"])
            block = self.S_pad // axes["lane"]
        if lane_chunk is not None and block % lane_chunk != 0:
            raise ValueError(f"lane_chunk={lane_chunk} must divide the lane "
                             f"block ({block})")
        lo = 0
        if shard:
            if not dist.is_initialized():
                raise RuntimeError(
                    "SweepRunner(shard=True) needs an initialised process "
                    "group (repro_torch.launch.mesh.init_group)")
            lo = self.mesh.get_coordinate()[0] * block
        # this rank's lanes (global indices; >= S are dead clones of lane 0)
        self.lanes = list(range(lo, lo + block))
        self.device = dev = resolve_device(device)
        self.sp, self.lr, self.alloc_steps = sp, lr, alloc_steps
        self.arch = arch
        self.spec = get_hfl_spec(arch)
        self.agg_kernel = agg_kernel
        self.lane_chunk = lane_chunk
        self.codec = (compression if compression is not None
                      else comp.CompressionConfig())
        self.pops = [w[0] for w in worlds]
        self.feds = [w[1] for w in worlds]
        self.M = self.pops[0].n_edges
        self.N = self.feds[0].n_devices
        src = [i if i < self.S else 0 for i in self.lanes]
        pops = [self.pops[i] for i in src]
        feds = [self.feds[i] for i in src]

        Dmax = max(int(max(len(y) for y in fed.y)) for fed in self.feds)
        padded = [pad_device_data(fed, Dmax, device=dev) for fed in feds]
        self.X_b = torch.stack([t[0] for t in padded])   # (S, N, Dmax, ...)
        self.y_b = torch.stack([t[1] for t in padded])
        self.mask_b = torch.stack([t[2] for t in padded])

        def stack(arrays, dtype=None):
            return torch.stack([torch.as_tensor(np.asarray(a), dtype=dtype)
                                for a in arrays]).to(dev)

        self.Xt_b = stack([f.X_test for f in feds])
        self.yt_b = stack([f.y_test for f in feds], torch.int64)
        self.fed_sizes_b = stack([f.sizes for f in feds], torch.float32)
        for name in ("u", "D", "p", "g", "g_cloud", "B_m"):
            setattr(self, f"{name}_b", torch.stack(
                [getattr(p, name).to(dev) for p in pops]))
        self.dev_pos_b = stack([p.dev_pos for p in pops], torch.float32)
        self.edge_pos_b = stack([p.edge_pos for p in pops], torch.float32)

        if init_params is not None:
            if len(init_params) != self.S:
                raise ValueError(f"init_params needs {self.S} trees, got "
                                 f"{len(init_params)}")
            self.params0 = lanes_from_numpy([init_params[i] for i in src],
                                            dev)
        else:
            gen = torch.Generator().manual_seed(model_seed)
            inits = [self.spec.init_fn(gen, self.feds[0], dev)
                     for _ in range(max(src) + 1)]
            self.params0 = {k: torch.stack([inits[i][k] for i in src])
                            for k in inits[0]}
        self.params_b = self.params0
        self.apply_fn = self.spec.apply_fn
        one = {k: v[0] for k, v in self.params0.items()}
        self.model_bits = tree_bytes(one) * 8
        # codec="none" gives exactly model_bits
        self.uplink_bits = comp.message_bits(self.codec, one)
        self.codec_noise = codec_noise or functools.partial(
            comp.round_noise, self.codec, device=dev)

    def _all_lanes(self, a):
        """Every lane's rows of this rank's lane-major ``a`` (block, ...):
        gathered over the lane mesh when sharded, else ``a`` itself."""
        return a if self.mesh is None else gather_lanes(a, self.mesh)

    def _width(self, H: int) -> int:
        """The round's cohort width: the largest over every rank's lanes."""
        if self.mesh is None:
            return H
        return int(max(gather_lanes(np.array([H]), self.mesh)))

    def _local_seeds(self, seeds) -> List[int]:
        """The lane seeds of this rank's lanes (dead lanes: lane 0's)."""
        return [seeds[i] if i < self.S else seeds[0] for i in self.lanes]

    def _codec_state0(self):
        """Fresh lane-stacked error-feedback state ``(dev_resid
        (S, N, ...), edge_resid (S, M, ...))`` of zeros; None for the
        identity codec."""
        if not self.codec.active:
            return None
        one = {k: v[0] for k, v in self.params0.items()}
        return tuple({k: torch.zeros((len(self.lanes),) + tuple(z.shape),
                                     dtype=z.dtype,
                                     device=self.device)
                      for k, z in comp.init_state(self.codec, one, n).items()}
                     for n in (self.N, self.M))

    def _lane_noise(self, seeds) -> List[Callable[[int], comp.NoiseSource]]:
        """Per lane, round -> that round's int8 noise source: the codec
        stream is keyed by the lane's seed and the round index alone."""
        return [functools.partial(self.codec_noise, int(s)) for s in seeds]

    def _round_sp(self) -> cm.SystemParams:
        """The sweep's ``sp`` priced with the uplink message's bits (the
        assigners score with the unpatched ``self.sp``, as the
        reference's do)."""
        return dataclasses.replace(self.sp,
                                   model_bits=float(self.uplink_bits))

    def _result(self, acc_a, T_a, E_a, H, target_acc) -> Dict:
        sp = self._round_sp()
        msg_bits = cm.round_msg_bits(self.sp, sp.Q * H, self.M,
                                     msg_bits=self.uplink_bits)
        return {"acc": acc_a, "T_i": T_a, "E_i": E_a,
                "obj": E_a + sp.lam * T_a, "iters": _iters(acc_a, target_acc),
                "msg_bits_per_round": float(msg_bits), "H": H,
                "codec": self.codec.codec,
                "uplink_bits_per_msg": float(self.uplink_bits),
                "uplink_bytes_per_round": float(msg_bits / 8)}

    def _tensor(self, a, dtype=torch.int64) -> torch.Tensor:
        return torch.as_tensor(np.asarray(a), dtype=dtype).to(self.device)

    # ---------------------------------------------------------------- run

    def run(self, schedulers: Sequence, n_rounds: int,
            assign: Union[str, Callable] = "geo",
            seeds: Optional[Sequence[int]] = None,
            target_acc: Optional[float] = None,
            sizes: str = "pop", train_only: bool = False,
            drl_params=None, fused: Union[bool, str] = False,
            assign_seed: int = 0,
            hfel_opts: Optional[Dict] = None) -> Dict:
        """Run n_rounds of all S lanes; lane s uses schedulers[s].

        assign: "geo" | "mod" | "hfel" (batched K-candidate search via
        ``make_hfel_assign``) | "drl" (greedy trained D3QN agent via
        ``make_drl_assign``; requires ``drl_params``) |
        callable(pop, sched, rng) -> (H,) edges.
        sizes: Algorithm-1 aggregation weights — "pop" (cost-model pop.D,
        HFLFramework semantics) or "fed" (the federated partition sizes,
        the Fig. 3/4 training-curve semantics).
        train_only=True skips resource allocation / cost bookkeeping
        (T_i, E_i are zeros).
        Early stop is per lane: a lane that reaches ``target_acc`` is
        marked done — its model freezes, it draws no host rng and no
        assignment search (it reuses its last schedule/assignment) and
        its T_i/E_i rows are zero from then on — and the loop breaks
        once every lane is done.

        fused=True runs the whole sweep on the device with no host
        synchronisation between rounds (``sweep_scan``); ``fused=
        "oracle"`` drives the same step with a read-back after each
        round and is the fused path's parity baseline. Fused mode needs
        a *named* assigner (its device twin runs in the step); hfel
        proposals draw from the counter-based stream keyed by
        (``assign_seed``, lane seed, round), tunable via ``hfel_opts``
        (n_transfer, n_exchange, n_candidates, warm_steps, accept_top).
        Schedulers may be the host state machines (their (R, S, H)
        schedules are precomputed up front — exact, since scheduling
        never depends on training state) or per-lane ``TracedFedAvg``
        instances. The result dict gains ``n_dispatches``: 1 for the
        fused sweep, one a round for the oracle.

        Returns {"acc": (S, R), "T_i": (S, R), "E_i": (S, R),
        "msg_bits_per_round": float, "iters": (S,) rounds to target_acc
        (or the rounds run), "obj": (S, R), ...} as numpy arrays.
        """
        if len(schedulers) != self.S:
            raise ValueError(f"{len(schedulers)} schedulers for {self.S} "
                             "lanes")
        if fused not in (False, True, "oracle"):
            raise ValueError(f"fused must be False, True or 'oracle', "
                             f"got {fused!r}")
        if fused:
            return self._run_fused(
                schedulers, n_rounds, assign=assign, seeds=seeds,
                target_acc=target_acc, sizes=sizes, train_only=train_only,
                drl_params=drl_params, oracle=(fused == "oracle"),
                assign_seed=assign_seed, hfel_opts=hfel_opts)
        if isinstance(assign, str):
            if assign == "hfel":
                assign_fn = make_hfel_assign(self.sp,
                                             alloc_steps=self.alloc_steps)
            elif assign == "drl":
                if drl_params is None:
                    raise ValueError(
                        "assign='drl' needs drl_params (a trained "
                        "D3QNTrainer.params tree)")
                assign_fn = make_drl_assign(self.sp, drl_params,
                                            device=self.device)
            elif assign in ASSIGN_FNS:
                assign_fn = ASSIGN_FNS[assign]
            else:
                raise ValueError(f"unknown assign {assign!r}")
        else:
            assign_fn = assign
        sizes_b = self._sizes(sizes)
        if seeds is None:
            seeds = list(range(self.S))
        live = [i for i in self.lanes if i < self.S]
        rngs = [np.random.default_rng(seeds[i]) for i in live]
        sp = self._round_sp()
        codec_on = self.codec.active
        cstate = self._codec_state0()
        lane_noise = self._lane_noise(self._local_seeds(seeds))
        n_live, n_dead = len(live), len(self.lanes) - len(live)

        params_b = self.params0
        accs: List[np.ndarray] = []
        Ts: List[np.ndarray] = []
        Es: List[np.ndarray] = []
        H = None
        # done over every lane; dead pad lanes (sharding only) are done
        # from round 0: frozen params, zero costs, outputs sliced away
        done = np.arange(self.S_pad) >= self.S
        scheds = [None] * n_live
        assigns = [None] * n_live
        for r_i in range(n_rounds):
            # done lanes are frozen: reuse their last schedule/assignment
            # instead of spending scheduler rng and assignment search on
            # a lane that no longer trains.
            own_done = done[live]
            scheds, H = _draw_cohorts([schedulers[i] for i in live], rngs,
                                      self.N, scheds, own_done, self._width)
            assigns = [assigns[s] if own_done[s]
                       else np.asarray(assign_fn(self.pops[i], scheds[s],
                                                 rngs[s]))
                       for s, i in enumerate(live)]
            # dead lanes take any cohort: their round is masked by done
            pad_s = [np.arange(H) % self.N] * n_dead
            pad_a = [np.arange(H) % self.M] * n_dead
            ckw = {}
            if codec_on:
                ckw = dict(codec=self.codec, codec_state_b=cstate,
                           codec_noise_b=[f(r_i) for f in lane_noise])
            args = (self.apply_fn, sp, params_b, self.u_b, self.D_b,
                    self.p_b, self.g_b, self.g_cloud_b, self.B_m_b, self.X_b,
                    self.y_b, self.mask_b, sizes_b,
                    self._tensor(np.stack(scheds + pad_s)),
                    self._tensor(np.stack(assigns + pad_a)), self.lr)
            kw = dict(M=self.M, L=sp.L, Q=sp.Q, alloc_steps=self.alloc_steps,
                      train_only=train_only, agg_kernel=self.agg_kernel,
                      lane_chunk=self.lane_chunk,
                      done_b=self._tensor(done[self.lanes], torch.bool),
                      **ckw)
            out = (sweep_round(*args, **kw) if self.mesh is None
                   else sweep_round_sharded(*args, mesh=self.mesh, **kw))
            params_b, (T_i, E_i) = out[0], out[1]
            if codec_on:
                cstate = out[2]
            acc_full = self._all_lanes(self._eval(params_b))
            accs.append(acc_full[:self.S])
            Ts.append(T_i.cpu().numpy()[:self.S])
            Es.append(E_i.cpu().numpy()[:self.S])
            if target_acc is not None:
                done = done | (acc_full >= target_acc)
                if done.all():
                    break
        self.params_b = params_b
        return self._result(np.stack(accs, axis=1), np.stack(Ts, axis=1),
                            np.stack(Es, axis=1), H, target_acc)

    def _sizes(self, sizes: str) -> torch.Tensor:
        if sizes not in ("pop", "fed"):
            raise ValueError(f"sizes must be 'pop' or 'fed', got {sizes!r}")
        return self.D_b if sizes == "pop" else self.fed_sizes_b

    # --------------------------------------------------------- fused run

    def _run_fused(self, schedulers: Sequence, n_rounds: int,
                   **kw) -> Dict:
        """``run(fused=...)`` under a tracer (``repro_torch.trace``):
        the result's ``trace`` holds the spans and counters of the call,
        a ``dispatch`` span around its ``schedule`` (the cohorts'
        precompute), each round's spans (``sweep_scan``) and each
        ``readback``, its device times read after the last read-back."""
        tracer = trace.Tracer(self.device)
        with trace.use(tracer), tracer.span("dispatch"):
            out = self._fused(schedulers, n_rounds, **kw)
        out["trace"] = tracer.finish().record()
        return out

    def _fused(self, schedulers: Sequence, n_rounds: int, *,
               assign, seeds, target_acc, sizes, train_only,
               drl_params, oracle: bool, assign_seed: int,
               hfel_opts) -> Dict:
        """``run(fused=...)`` body: ``sweep_scan`` over all rounds with
        one read-back at the end (oracle=False), or one round a call
        with a read-back after each (oracle=True, the parity
        baseline)."""
        if not isinstance(assign, str):
            raise ValueError(
                "fused sweeps need a named assigner (mod/geo/drl/hfel) — "
                "callables cannot run in the device step")
        if assign not in ("mod", "geo", "drl", "hfel"):
            raise ValueError(f"unknown assign {assign!r} for fused run")
        if assign == "drl" and drl_params is None:
            raise ValueError("assign='drl' needs drl_params (a trained "
                             "D3QNTrainer.params tree)")
        sizes_b = self._sizes(sizes)
        if hfel_opts and assign != "hfel":
            raise ValueError("hfel_opts only applies to assign='hfel'")
        hfel_cfg = None
        if assign == "hfel":
            opts = dict(hfel_opts or {})
            bad = set(opts) - set(_HFEL_FUSED_DEFAULTS)
            if bad:
                raise ValueError(
                    f"unknown hfel_opts keys {sorted(bad)}; valid: "
                    f"{sorted(_HFEL_FUSED_DEFAULTS)} (alloc_steps is the "
                    "runner's constructor knob)")
            hfel_cfg = tuple(sorted({**_HFEL_FUSED_DEFAULTS, **opts}.items()))
        if seeds is None:
            seeds = list(range(self.S))
        sp = self._round_sp()
        codec_on = self.codec.active
        cstate = self._codec_state0()

        # scheduling: TracedFedAvg state on the device, or an exact host
        # precompute (scheduling never reads training state, so the
        # (R, S, H) tensor reproduces the host loop's draws verbatim)
        with trace.span("schedule"):
            n_traced = sum(isinstance(s, TracedFedAvg) for s in schedulers)
            if n_traced == self.S:
                traced_sched = schedulers[0]
                if any(s != traced_sched for s in schedulers):
                    raise ValueError(
                        "fused TracedFedAvg lanes must share one (n_devices, "
                        "H) config — per-lane variation lives in the seed")
                H = traced_sched.H
                sched_state_b = traced_sched.init_state(
                    self._local_seeds(seeds), self.device)
                sched_rs = None
            elif n_traced:
                raise ValueError("cannot mix TracedFedAvg and host schedulers "
                                 "in one fused run")
            else:
                traced_sched = None
                sched_state_b = None
                live = [i for i in self.lanes if i < self.S]
                rngs = [np.random.default_rng(seeds[i]) for i in live]
                rounds = []
                H = None
                for _ in range(n_rounds):
                    scheds, H_r = _draw_cohorts(
                        [schedulers[i] for i in live], rngs, self.N,
                        width=self._width)
                    if H is None:
                        H = H_r
                    elif H_r != H:
                        raise ValueError(
                            f"fused sweeps need a round-constant cohort "
                            f"size (got H={H} then H={H_r}); use the "
                            "per-round host path for schedulers whose "
                            "worst-case cohort varies across rounds")
                    # dead lanes take any cohort: they are done from round 0
                    pad = ([np.arange(H_r) % self.N]
                           * (len(self.lanes) - len(live)))
                    rounds.append(np.stack(scheds + pad))
                sched_rs = self._tensor(np.stack(rounds))        # (R, S, H)

        local_seeds = self._local_seeds(seeds)
        assign_words_b = self._tensor(
            [[assign_seed, s] for s in local_seeds])         # (S, 2)
        done_b = self._tensor(np.array(self.lanes) >= self.S, torch.bool)
        params_b = self.params0
        drl_t = (params_from_numpy(drl_params, self.device)
                 if assign == "drl" else None)
        lane_noise = self._lane_noise(local_seeds) if codec_on else None
        statics = dict(M=self.M, L=sp.L, Q=sp.Q, alloc_steps=self.alloc_steps,
                       train_only=train_only, agg_kernel=self.agg_kernel,
                       lane_chunk=self.lane_chunk, assign=assign,
                       hfel_cfg=hfel_cfg, target_acc=target_acc,
                       traced_sched=traced_sched,
                       codec=self.codec if codec_on else None)

        scan = (sweep_scan if self.mesh is None else
                functools.partial(sweep_scan_sharded, mesh=self.mesh))

        def dispatch(params_b, done_b, sched_state_b, sched_rs, cstate, r0,
                     n_r):
            return scan(
                self.apply_fn, sp, self.sp, params_b, self.u_b, self.D_b,
                self.p_b, self.g_b, self.g_cloud_b, self.B_m_b, self.X_b,
                self.y_b, self.mask_b, sizes_b, self.dev_pos_b,
                self.edge_pos_b, self.Xt_b, self.yt_b, sched_rs,
                sched_state_b, assign_words_b, done_b, drl_t, self.lr,
                cstate, lane_noise, r0, n_rounds=n_r, **statics)

        if oracle:
            accs, Ts, Es = [], [], []
            n_dispatches = 0
            for r in range(n_rounds):
                xs_r = None if sched_rs is None else sched_rs[r:r + 1]
                (params_b, done_b, sched_state_b, cstate), (acc_r, T_r, E_r) \
                    = dispatch(params_b, done_b, sched_state_b, xs_r, cstate,
                               r, 1)
                n_dispatches += 1
                with trace.span("readback"):
                    accs.append(acc_r[0].cpu().numpy()[:self.S])
                    Ts.append(T_r[0].cpu().numpy()[:self.S])
                    Es.append(E_r[0].cpu().numpy()[:self.S])
                    stop = target_acc is not None and self._all_lanes(
                        done_b.cpu().numpy()).all()
                if stop:
                    break
            acc_a = np.stack(accs, axis=1)               # (S, R_run)
            T_a = np.stack(Ts, axis=1)
            E_a = np.stack(Es, axis=1)
        else:
            (params_b, *_), (acc_rs, T_rs, E_rs) = dispatch(
                params_b, done_b, sched_state_b, sched_rs, cstate, 0,
                n_rounds)
            n_dispatches = 1
            with trace.span("readback"):
                acc_a = acc_rs.cpu().numpy().T[:self.S]      # (S, R)
                T_a = T_rs.cpu().numpy().T[:self.S]
                E_a = E_rs.cpu().numpy().T[:self.S]
            if target_acc is not None:
                # trim trailing all-done rounds so the fused result is
                # row-for-row comparable with the early-breaking host loop
                # (done lanes' extra rows are frozen-acc / zero-cost)
                reached_by = np.maximum.accumulate(
                    acc_a >= target_acc, axis=1)
                all_done = reached_by.all(axis=0)
                if all_done.any():
                    R_eff = int(all_done.argmax()) + 1
                    acc_a = acc_a[:, :R_eff]
                    T_a = T_a[:, :R_eff]
                    E_a = E_a[:, :R_eff]
        self.params_b = params_b
        out = self._result(acc_a, T_a, E_a, H, target_acc)
        out["n_dispatches"] = n_dispatches
        return out

    def _eval(self, params_b, batch: int = 512) -> np.ndarray:
        """(S,) f64 test accuracy of every lane, read back to the host."""
        return sweep_eval(self.apply_fn, params_b, self.Xt_b, self.yt_b,
                          batch).cpu().numpy()

    # ---------------------------------------------------- ratio sweeps

    def sweep_ratios(self, ratios: Sequence[float], *, scheduler: str,
                     n_rounds: int, assign: Union[str, Callable] = "geo",
                     K: int = 10, seeds: Optional[Sequence[int]] = None,
                     target_acc: Optional[float] = None) -> Dict:
        """Paper-style scheduling-ratio sweep: H = ratio * N for each
        ratio in ``ratios`` (e.g. 0.3 / 0.5 / 1.0), each ratio one
        multi-lane run. Returns {ratio: run-result}."""
        if seeds is None:
            seeds = list(range(self.S))
        out = {}
        for r in ratios:
            H = max(1, int(round(r * self.N)))
            name = "fedavg" if H >= self.N else scheduler
            scheds = [build_scheduler(name, self.feds[s], self.sp, H, K=K,
                                      lr=self.lr, seed=seeds[s],
                                      arch=self.arch, device=self.device)
                      for s in range(self.S)]
            out[r] = self.run(scheds, n_rounds, assign=assign, seeds=seeds,
                              target_acc=target_acc)
        return out
