"""Device scheduling policies: FedAvg-random, VKC (Alg. 3), IKC (Alg. 4).

A numpy copy of ``repro.core.scheduling.schedulers``: the vectorized
engines (``FedAvgScheduler``, ``VKCScheduler``, ``IKCScheduler`` over the
CSR ``_ClusterState``) and the serial list-based oracles
(``SerialFedAvgScheduler``, ``SerialVKCScheduler``,
``SerialIKCScheduler``), so the same rng and labels give identical
cohorts in both packages, the IKC top-up rule included: devices
scheduled by top-up are recorded into their cluster's rotation set, so
no device repeats before its cluster-mates were scheduled once. The
serial engines are the distribution oracles of the vectorized ones
(``tests/test_torch_serial_sched.py``).

All schedulers expose ``schedule(rng) -> np.ndarray[H]`` of device
indices and ``topup_to(selected, target, rng)`` (Alg. 3 lines 12-15 /
Alg. 4 lines 21-24). Cluster membership lives in one flat CSR index
array, and a round is O(H log h) array ops. ``TracedFedAvg`` is the
device-side FedAvg draw of the fused sweep.
"""
from __future__ import annotations

import dataclasses
from typing import List, Sequence

import numpy as np
import torch

from repro_torch.utils import permutation_prefix, resolve_device


class Scheduler:
    n_devices: int

    def schedule(self, rng: np.random.Generator) -> np.ndarray:
        raise NotImplementedError

    def topup_to(self, selected, target: int, rng) -> np.ndarray:
        """Top ``selected`` up to ``target`` devices from the unscheduled
        pool (uniform, without replacement). Policies with rotation state
        override this to record the extra picks."""
        return np.asarray(_topup(list(np.asarray(selected, dtype=np.int64)),
                                 self.n_devices, target, rng),
                          dtype=np.int64)


def _topup(selected: List[int], n_devices: int, target: int, rng
           ) -> List[int]:
    """Alg.3 lines 12-15 / Alg.4 lines 21-24: random devices from the
    unscheduled pool until |H_i| == target. O(N) setdiff — the serial
    oracles' path; the vectorized schedulers use ``_sample_excluding``."""
    if len(selected) < target:
        pool = np.setdiff1d(np.arange(n_devices), np.asarray(selected, int))
        extra = rng.choice(pool, target - len(selected), replace=False)
        selected = selected + list(extra)
    return selected


# --------------------------------------------------------------------------
# serial oracles (the original list-based engines)
# --------------------------------------------------------------------------


class SerialFedAvgScheduler(Scheduler):
    """[3]: uniformly random H devices per round (serial oracle)."""

    def __init__(self, n_devices: int, H: int):
        self.n_devices = n_devices
        self.H = H

    def schedule(self, rng) -> np.ndarray:
        return rng.choice(self.n_devices, self.H, replace=False)


class SerialVKCScheduler(Scheduler):
    """Algorithm 3 — vanilla K-Center: h random devices per cluster
    (serial oracle)."""

    def __init__(self, clusters: Sequence[int], h: int):
        clusters = np.asarray(clusters)
        self.n_devices = len(clusters)
        self.K = int(clusters.max()) + 1
        self.h = h
        self.members = [np.flatnonzero(clusters == k) for k in range(self.K)]

    @property
    def H(self) -> int:
        return self.h * self.K

    def schedule(self, rng) -> np.ndarray:
        sel: List[int] = []
        for k in range(self.K):
            ck = self.members[k]
            if len(ck) >= self.h:                       # line 7
                sel += list(rng.choice(ck, self.h, replace=False))
            else:                                       # line 9
                sel += list(ck)
        sel = _topup(sel, self.n_devices, self.H, rng)
        return np.asarray(sel)


class SerialIKCScheduler(Scheduler):
    """Algorithm 4 — improved K-Center with per-cluster rotation sets G_k
    (serial oracle).

    C_k = not-recently-scheduled members, G_k = recently scheduled. Fresh
    devices are preferred; when C_k runs dry it is refilled from G_k,
    guaranteeing every cluster member is scheduled before any repeats.
    Top-up picks are recorded into their cluster's G_k so the invariant
    also holds across the Alg.-4 line 21-24 path.
    """

    def __init__(self, clusters: Sequence[int], h: int):
        clusters = np.asarray(clusters)
        self.clusters = clusters
        self.n_devices = len(clusters)
        self.K = int(clusters.max()) + 1
        self.h = h
        self.C = [list(np.flatnonzero(clusters == k)) for k in range(self.K)]
        self.G: List[List[int]] = [[] for _ in range(self.K)]

    @property
    def H(self) -> int:
        return self.h * self.K

    def schedule(self, rng) -> np.ndarray:
        sel: List[int] = []
        for k in range(self.K):
            Ck, Gk, h = self.C[k], self.G[k], self.h
            if len(Ck) + len(Gk) >= h:
                if len(Ck) >= h:                        # line 9
                    pick = list(rng.choice(Ck, h, replace=False))
                    self.C[k] = [d for d in Ck if d not in pick]
                    self.G[k] = Gk + pick
                else:                                   # lines 11-14
                    pick = list(Ck)
                    need = h - len(pick)
                    from_g = list(rng.choice(Gk, need, replace=False))
                    pick += from_g
                    remaining = [d for d in Gk if d not in from_g]
                    self.C[k] = remaining               # line 13
                    self.G[k] = list(pick)              # line 14
                sel += pick
            else:                                       # line 17
                sel += list(Ck) + list(Gk)
        return self.topup_to(np.asarray(sel, dtype=np.int64), self.H, rng)

    def topup_to(self, selected, target: int, rng) -> np.ndarray:
        """Alg.-4 top-up that keeps the rotation invariant: draw from the
        not-yet-rotated devices (any cluster's C_k) first, fall back to
        the general pool only once every fresh device is scheduled, and
        record each pick into its cluster's G_k."""
        selected = [int(d) for d in np.asarray(selected, dtype=np.int64)]
        need = target - len(selected)
        if need <= 0:
            return np.asarray(selected, dtype=np.int64)
        sel_set = set(selected)
        fresh = [d for k in range(self.K) for d in self.C[k]
                 if d not in sel_set]
        pick: List[int] = []
        if fresh:
            pick += [int(d) for d in rng.choice(
                np.asarray(fresh), min(need, len(fresh)), replace=False)]
        if len(pick) < need:
            pool = np.setdiff1d(np.arange(self.n_devices),
                                np.asarray(selected + pick, int))
            pick += [int(d) for d in rng.choice(pool, need - len(pick),
                                                replace=False)]
        for d in pick:
            k = int(self.clusters[d])
            if d in self.C[k]:                          # record the pick
                self.C[k].remove(d)
                self.G[k].append(d)
        return np.asarray(selected + pick, dtype=np.int64)


# --------------------------------------------------------------------------
# vectorized engines
# --------------------------------------------------------------------------


def _in_sorted(vals: np.ndarray, sorted_arr: np.ndarray) -> np.ndarray:
    """Membership of ``vals`` in a sorted array, O(|vals| log |sorted|)."""
    if len(sorted_arr) == 0:
        return np.zeros(len(vals), dtype=bool)
    idx = np.minimum(np.searchsorted(sorted_arr, vals), len(sorted_arr) - 1)
    return sorted_arr[idx] == vals


def _sample_excluding(rng, n: int, size: int,
                      exclude_sorted: np.ndarray) -> np.ndarray:
    """``size`` distinct uniform draws from [0, n) minus a sorted exclude
    set, in O(size log size) expected — the O(scheduled) replacement for
    the serial ``setdiff1d`` top-up pool.

    Rejection sampling: draw batches, drop excluded/duplicate values,
    keep a uniform random subset once enough survive (any scheme that is
    symmetric under relabelling of the pool yields a uniform
    without-replacement sample). Falls back to materializing the pool
    when the pool is under half of [0, n) or the request covers most of
    it — there the O(n) pass is O(size) anyway.
    """
    pool = n - len(exclude_sorted)
    if size > pool:
        raise ValueError(f"cannot draw {size} devices from a pool of {pool}")
    if size == 0:
        return np.empty(0, dtype=np.int64)
    if 2 * size > pool or 2 * pool < n:
        full = np.setdiff1d(np.arange(n), exclude_sorted)
        return rng.choice(full, size, replace=False).astype(np.int64)
    chosen = np.empty(0, dtype=np.int64)
    for _ in range(64):
        need = size - len(chosen)
        if need <= 0:
            break
        cand = rng.integers(0, n, 2 * need + 8)
        cand = cand[~_in_sorted(cand, exclude_sorted)]
        chosen = np.union1d(chosen, cand)
    else:  # pragma: no cover - pool >= 2*size makes this unreachable
        raise RuntimeError("rejection sampling failed to converge")
    if len(chosen) > size:
        chosen = rng.choice(chosen, size, replace=False)
    return chosen.astype(np.int64)


def _ragged_gather(flat: np.ndarray, starts: np.ndarray,
                   counts: np.ndarray) -> np.ndarray:
    """Concatenate ``flat[starts[r] : starts[r]+counts[r]]`` for all rows
    without a per-row Python loop."""
    counts = np.asarray(counts, dtype=np.int64)
    total = int(counts.sum())
    offs = np.cumsum(counts) - counts
    return flat[np.repeat(starts - offs, counts) + np.arange(total)]


class _ClusterState:
    """Vectorized cluster membership state shared by VKC/IKC.

    ``order`` is the flat CSR member array: ``order[offsets[k]:
    offsets[k+1]]`` holds cluster k's device ids in arbitrary order (one
    O(N) build at construction — the same information as a
    ``(K, max_cluster)`` padded index panel, minus the K*N worst case).
    ``pos`` inverts it (device id -> flat slot) so rotation bookkeeping
    can move an individual device in O(1). All per-round mutation goes
    through ``pick_tail`` — uniform without-replacement sampling inside
    per-cluster windows with the picked members swapped to each window's
    tail — which is what makes the schedulers' rotation-set transfer a
    boundary shift instead of list surgery.
    """

    #: windows at least this many times larger than the pick count use
    #: the rejection path; smaller windows are cheaper to fully permute.
    _REJECT_FACTOR = 8

    def __init__(self, clusters: Sequence[int]):
        clusters = np.asarray(clusters, dtype=np.int64)
        self.clusters = clusters
        self.n_devices = len(clusters)
        self.K = int(clusters.max()) + 1
        self.counts = np.bincount(clusters, minlength=self.K)
        self.offsets = np.concatenate(
            [np.zeros(1, dtype=np.int64), np.cumsum(self.counts)])
        self.order = np.argsort(clusters, kind="stable").astype(np.int64)
        self.pos = np.empty(self.n_devices, dtype=np.int64)
        self.pos[self.order] = np.arange(self.n_devices)

    def pick_tail(self, rng, rows: np.ndarray, sizes: np.ndarray,
                  n_pick: np.ndarray) -> None:
        """For each row r (ascending cluster ids), move ``n_pick[r]``
        uniformly-chosen members of the window ``[offsets[r],
        offsets[r]+sizes[r])`` into the window's tail slots, in place.

        O(total picked · log) with no per-row Python: big windows draw
        candidate slots with replacement, keep a random subset of the
        distinct ones (uniform by symmetry) and repair the tail with a
        searchsorted membership pass; small windows (< _REJECT_FACTOR ×
        pick) are fully permuted through one masked-argsort batch.
        """
        keep = n_pick > 0
        rows, sizes, n_pick = rows[keep], sizes[keep], n_pick[keep]
        if len(rows) == 0:
            return
        big = sizes >= self._REJECT_FACTOR * n_pick
        if big.any():
            self._pick_tail_reject(rng, self.offsets[rows[big]], sizes[big],
                                   n_pick[big])
        if (~big).any():
            self._pick_tail_permute(rng, self.offsets[rows[~big]],
                                    sizes[~big], n_pick[~big])

    def _pick_tail_reject(self, rng, base, sz, n_pick):
        # all big rows request the same count (a row with a smaller
        # natural pick, n_pick = window size, can never be 8x smaller
        # than its own window)
        h = int(n_pick.max())
        assert (n_pick == h).all()
        R, D = len(base), 2 * h + 8
        P = np.empty((R, h), dtype=np.int64)
        pending = np.arange(R)
        for _ in range(64):
            if len(pending) == 0:
                break
            cand = rng.integers(0, sz[pending, None], (len(pending), D))
            cand.sort(axis=1)
            first = np.ones(cand.shape, dtype=bool)
            first[:, 1:] = cand[:, 1:] != cand[:, :-1]
            ok = first.sum(axis=1) >= h
            keys = rng.random(cand.shape)
            keys[~first] = np.inf                  # duplicates never chosen
            sel = np.argsort(keys, axis=1)[:, :h]  # random h of the distinct
            P[pending[ok]] = np.take_along_axis(cand, sel, axis=1)[ok]
            pending = pending[~ok]
        else:  # pragma: no cover - sz >= 8h makes this unreachable
            raise RuntimeError("slot sampling failed to converge")
        P.sort(axis=1)
        # repair: picked values go to the tail window, tail values that
        # were not picked back-fill the holes the picked ones left.
        Pa = (P + base[:, None]).ravel()           # globally sorted: rows
        tail = (sz[:, None] - h + np.arange(h)[None, :] + base[:, None])
        ta = tail.ravel()                          # are disjoint ascending
        in_p = _in_sorted(ta, Pa)
        holes = Pa[(P < (sz - h)[:, None]).ravel()]
        fillers = ta[~in_p]                        # row-major on both sides,
        vals_p = self.order[Pa]                    # per-row counts match
        filler_vals = self.order[fillers]
        self.order[holes] = filler_vals
        self.order[ta] = vals_p
        self.pos[filler_vals] = holes
        self.pos[vals_p] = ta

    def _pick_tail_permute(self, rng, base, sz, n_pick):
        W = int(sz.max())
        cols = np.arange(W)[None, :]
        valid = cols < sz[:, None]
        idx = base[:, None] + np.minimum(cols, sz[:, None] - 1)
        vals = self.order[idx]
        keys = rng.random((len(base), W))
        keys[~valid] = np.inf                      # pad lanes sort last
        perm = np.argsort(keys, axis=1)
        new_vals = np.take_along_axis(vals, perm, axis=1)[valid]
        tgt = (base[:, None] + cols)[valid]
        self.order[tgt] = new_vals
        self.pos[new_vals] = tgt

    def refill_row(self, rng, k: int, nf_k: int, h: int) -> None:
        """Alg. 4 lines 11-14 for one cluster: pick = all of C_k plus
        h - |C_k| random members of G_k; the row is rebuilt as
        [G_k \\ picked | picked] so the new C_k is the survivors and the
        new G_k (the window tail) is exactly the pick. O(|cluster|),
        amortized O(h) per round (a cluster refills once per rotation).
        """
        base, cnt = int(self.offsets[k]), int(self.counts[k])
        row = self.order[base:base + cnt]
        fresh = row[:nf_k].copy()
        g = row[nf_k:].copy()
        smask = np.zeros(len(g), dtype=bool)
        smask[rng.choice(len(g), h - nf_k, replace=False)] = True
        new_row = np.concatenate([g[~smask], fresh, g[smask]])
        self.order[base:base + cnt] = new_row
        self.pos[new_row] = base + np.arange(cnt)


class FedAvgScheduler(Scheduler):
    """[3]: uniformly random H devices per round — O(H) rejection draw
    (the full-permutation path only when H exceeds half the population,
    where O(N) is O(H))."""

    def __init__(self, n_devices: int, H: int):
        self.n_devices = n_devices
        self.H = H

    def schedule(self, rng) -> np.ndarray:
        return _sample_excluding(rng, self.n_devices, self.H,
                                 np.empty(0, dtype=np.int64))

    def topup_to(self, selected, target: int, rng) -> np.ndarray:
        selected = np.asarray(selected, dtype=np.int64)
        if len(selected) >= target:
            return selected
        extra = _sample_excluding(rng, self.n_devices,
                                  target - len(selected), np.sort(selected))
        return np.concatenate([selected, extra])


class VKCScheduler(Scheduler):
    """Algorithm 3 — vanilla K-Center: h random devices per cluster
    (every member when a cluster is smaller than h), vectorized."""

    def __init__(self, clusters: Sequence[int], h: int):
        self.state = _ClusterState(clusters)
        self.n_devices = self.state.n_devices
        self.K = self.state.K
        self.h = h

    @property
    def H(self) -> int:
        return self.h * self.K

    def schedule(self, rng) -> np.ndarray:
        st = self.state
        n_pick = np.minimum(st.counts, self.h)           # lines 7 / 9
        st.pick_tail(rng, np.arange(st.K), st.counts, n_pick)
        sel = _ragged_gather(st.order, st.offsets[:-1] + st.counts - n_pick,
                             n_pick)
        if len(sel) < self.H:                            # lines 12-15
            sel = self.topup_to(sel, self.H, rng)
        return sel

    def topup_to(self, selected, target: int, rng) -> np.ndarray:
        selected = np.asarray(selected, dtype=np.int64)
        if len(selected) >= target:
            return selected
        extra = _sample_excluding(rng, self.n_devices,
                                  target - len(selected), np.sort(selected))
        return np.concatenate([selected, extra])


class IKCScheduler(Scheduler):
    """Algorithm 4 — improved K-Center with per-cluster rotation sets G_k,
    vectorized.

    Cluster k's CSR window is split by ``nf[k]``: the first nf[k] slots
    are C_k (fresh), the rest G_k (recently scheduled). A normal round
    swaps h fresh picks across the boundary (``pick_tail`` + nf -= h); a
    dry C_k refills from G_k (``refill_row``); clusters smaller than h
    contribute every member with no state change; and top-up picks are
    recorded by moving the device across its own cluster's boundary —
    every cluster member is scheduled once before any repeats, including
    through the top-up path.
    """

    def __init__(self, clusters: Sequence[int], h: int):
        self.state = _ClusterState(clusters)
        self.n_devices = self.state.n_devices
        self.K = self.state.K
        self.h = h
        self.nf = self.state.counts.copy()               # all fresh at t=0

    @property
    def H(self) -> int:
        return self.h * self.K

    def schedule(self, rng) -> np.ndarray:
        st, h = self.state, self.h
        cnt = st.counts
        short = cnt < h                                  # line 17
        normal = ~short & (self.nf >= h)                 # line 9
        rows = np.flatnonzero(normal)
        st.pick_tail(rng, rows, self.nf[rows],
                     np.full(len(rows), h, dtype=np.int64))
        self.nf[rows] -= h
        for k in np.flatnonzero(~short & (self.nf < h) & ~normal):
            st.refill_row(rng, int(k), int(self.nf[k]), h)   # lines 11-14
            self.nf[k] = cnt[k] - h
        # every non-short row's pick now sits at [nf, nf + h); short rows
        # contribute their whole window.
        starts = st.offsets[:-1] + np.where(short, 0, self.nf)
        sel = _ragged_gather(st.order, starts, np.where(short, cnt, h))
        if len(sel) < self.H:                            # lines 21-24
            sel = self.topup_to(sel, self.H, rng)
        return sel

    def topup_to(self, selected, target: int, rng) -> np.ndarray:
        """Alg.-4 top-up that keeps the rotation invariant: draw from the
        not-yet-rotated devices (any cluster's C_k window) first, fall
        back to the general pool only once every fresh device is
        scheduled, and record each pick into its cluster's G_k.
        O(picked log K) via rank sampling over the fresh windows."""
        selected = np.asarray(selected, dtype=np.int64)
        t = target - len(selected)
        if t <= 0:
            return selected
        extra = self._draw_fresh(rng, t, np.sort(selected))
        self._record_scheduled(extra)
        if len(extra) < t:
            exclude = np.sort(np.concatenate([selected, extra]))
            more = _sample_excluding(rng, self.n_devices, t - len(extra),
                                     exclude)
            self._record_scheduled(more)    # no-op: nothing fresh is left
            extra = np.concatenate([extra, more])
        return np.concatenate([selected, extra])

    def _draw_fresh(self, rng, t: int, sel_sorted: np.ndarray) -> np.ndarray:
        """Up to ``t`` distinct uniform draws from the union of the fresh
        windows minus the already-selected devices."""
        st = self.state
        F = int(self.nf.sum())
        if F == 0:
            return np.empty(0, dtype=np.int64)
        k_sel = st.clusters[sel_sorted]
        rel = st.pos[sel_sorted] - st.offsets[k_sel]
        avail = F - int((rel < self.nf[k_sel]).sum())
        take = min(t, avail)
        if take == 0:
            return np.empty(0, dtype=np.int64)
        if 2 * take > avail or avail <= 64:
            # near-exhausted rotation: materialize the fresh windows —
            # O(F), and F is O(selected + take) in this regime
            fresh = _ragged_gather(st.order, st.offsets[:-1], self.nf)
            pool = fresh[~_in_sorted(fresh, sel_sorted)]
            return rng.choice(pool, take, replace=False).astype(np.int64)
        cum_hi = np.cumsum(self.nf)
        cum_lo = cum_hi - self.nf
        got = np.empty(0, dtype=np.int64)
        for _ in range(64):
            need = take - len(got)
            if need <= 0:
                break
            ranks = rng.integers(0, F, 2 * need + 8)
            kk = np.searchsorted(cum_hi, ranks, side="right")
            d = st.order[st.offsets[kk] + (ranks - cum_lo[kk])]
            got = np.union1d(got, d[~_in_sorted(d, sel_sorted)])
        else:  # pragma: no cover - avail >= 2*take makes this unreachable
            raise RuntimeError("fresh-pool sampling failed to converge")
        if len(got) > take:
            got = rng.choice(got, take, replace=False)
        return got.astype(np.int64)

    def _record_scheduled(self, devs: np.ndarray) -> None:
        """Move freshly top-upped devices from C_k into G_k (devices that
        are already in G_k stay put). O(1) per device via ``pos``."""
        st = self.state
        for d in devs:
            p = int(st.pos[d])
            k = int(st.clusters[d])
            rel = p - st.offsets[k]
            if rel < self.nf[k]:
                last = int(st.offsets[k] + self.nf[k] - 1)
                other = int(st.order[last])
                st.order[last], st.order[p] = d, other
                st.pos[d], st.pos[other] = last, p
                self.nf[k] -= 1


# --------------------------------------------------------------------------
# traced scheduler (fused sweep)
# --------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class TracedFedAvg:
    """Device-side FedAvg scheduler for the fused sweep (port of the
    reference's ``TracedFedAvg``).

    The host schedulers above are numpy state machines; this one keeps
    its per-lane state on the device, so a fused sweep draws every
    round's cohort with no host round trip. State: an (S, 2) int64
    tensor of (lane seed, round). ``step`` takes the first H of a random
    permutation of the N devices per lane, a counter-based draw keyed by
    (lane seed, round) alone (``utils.permutation_prefix``), so a lane's
    schedule does not depend on which lanes share its batch. It is the
    uniform without-replacement draw of ``FedAvgScheduler``, matching it
    in distribution, not bitwise (as the reference's JAX stream does).
    """
    n_devices: int
    H: int

    def __post_init__(self):
        if not 0 < self.H <= self.n_devices:
            raise ValueError(f"need 0 < H <= N, got H={self.H}, "
                             f"N={self.n_devices}")

    def init_state(self, seeds, device="cuda") -> torch.Tensor:
        """(S, 2) int64 state for lane seeds ``seeds`` (an int is one
        lane), on ``device``."""
        seeds = np.atleast_1d(np.asarray(seeds, np.int64))
        state = np.stack([seeds, np.zeros_like(seeds)], axis=1)
        return torch.from_numpy(state).to(resolve_device(device))

    def step(self, state: torch.Tensor):
        """One scheduling round: (S, 2) state -> (next state, (S, H)
        int64 distinct device ids per lane)."""
        sched = permutation_prefix(state, (), self.n_devices, self.H)
        # + (0, 1): the round advances (arange, not a tensor built from a
        # host list, whose copy to the device would synchronise)
        return state + torch.arange(2, device=state.device), sched
