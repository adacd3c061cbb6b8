"""A frozen copy of the IKC scheduler (Algorithm 4, with the top-up rule
that records its picks in the rotation sets) as the program draws it:
the same numpy draws in the same order, so the same labels and the same
``np.random.Generator`` give the same cohorts. Kept here so that a later
change to the program cannot move the reference's schedule.
"""
from __future__ import annotations

from typing import Sequence

import numpy as np


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


class IKCScheduler:
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
