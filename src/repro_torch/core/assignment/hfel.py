"""HFEL [15] device-assignment search baseline.

Port of ``repro.core.assignment.hfel``'s host engines. Iterative local
search over assignment patterns: *transfer* adjustments (move one device
to another edge) and *exchange* adjustments (swap two devices between
edges), each accepted iff it lowers the one-round objective (17):

    J(Ψ) = Σ_m E_m(Ψ) + λ max_m T_m(Ψ)

where per-edge (T_m, E_m) come from the convex resource allocator
(problem 27) plus the constant cloud terms. HFEL-100/HFEL-300 bound the
number of exchange trials as in §VI-B.

Two search engines share the move neighborhood:

* ``search="serial"`` — one trial per step, each re-solving its two
  affected edges (the oracle);
* ``search="batched"`` (default) — K candidate moves a round, sampled
  without replacement; their 2K affected edges solve in one
  ``resource.allocate_batch_warm`` call, warm-started from the
  incumbent's per-edge iterates at ``_warm_steps(alloc_steps)`` Adam
  steps (40 %); the accept pass (``_accept_scan_core``) commits up to
  ``_ACCEPT_TOP`` non-conflicting improving moves in ΔJ order,
  re-verifying each against the exact combined objective.
  ``assign_batch`` runs E populations' searches in lockstep: one solve
  and one accept pass a round for all of them; ``assign`` is its
  one-population case.

``hfel_search_traced`` is the device engine of the fused sweep: the
batched search with no carry list and no host round trip, for S lanes
at once (see its docstring).

Every decision of the host engines is made on the host in numpy, with
the reference's code:
proposals (``rng.choice(..., replace=False)`` and an ordered ``seen``
set), the candidate order (``np.argsort``), the padding rows (the
incumbent, marked invalid, J = inf). The population's device runs the
allocator solves and the accept pass. Objectives sum the M edges in f32
one after another, as numpy and XLA sum a few elements, so the host
scores and the device's re-verification agree bitwise.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core import cost_model as cm
from repro_torch.core import resource as ra
from repro_torch.utils import permutation_prefix

_TRANSFER, _EXCHANGE = 0, 1
_ACCEPT_TOP = 4          # max non-conflicting accepts per batched round


def _warm_steps(alloc_steps: int) -> int:
    """Adam steps of a batched round's warm trial re-solves."""
    return max(25, (2 * alloc_steps) // 5)


def _objective(Tv, Ev, T_cl, E_cl, lam):
    """J(Ψ) (17) including the constant cloud terms, over the trailing
    edge axis: one (M,) pattern or a (..., K, M) candidate round, numpy
    or torch. The M energies are summed one after another in f32."""
    e = Ev + E_cl
    tot = e[..., 0]
    for m in range(1, e.shape[-1]):
        tot = tot + e[..., m]
    t = Tv + T_cl
    tmax = torch.amax(t, -1) if isinstance(t, torch.Tensor) else t.max(-1)
    return tot + lam * tmax


def _accept_scan_core(J, edges, Tn, En, T0, E0, cur0, T_cl, E_cl, lam, valid,
                      *, accept_top: int):
    """Accept pass over one round's candidates, sorted by ascending J.

    Tensors on one device, with any leading population axes ``P``
    (the reference's ``_accept_scan`` has none, ``_accept_scan_pops``
    one): J (P.., K), edges (P.., K, 2) int64, Tn/En (P.., K, 2),
    T0/E0 (P.., M), cur0 (P..), T_cl/E_cl (P.., M), lam (P..) and valid
    (P.., K). Per candidate, in order:

    * improving — J beats the round-start incumbent ``cur0``;
    * blocked — an edge already touched by an accepted move, or the
      ``accept_top`` cap: flagged for carry-over;
    * otherwise the exact combined objective is re-verified against the
      carried tables and the move accepted iff it beats the carried
      ``cur``.

    Returns (T, E, cur, accept_flags, carry_flags), flags in the sorted
    order.
    """
    K = J.shape[-1]
    ids = torch.arange(T0.shape[-1], device=T0.device)
    T, E, cur = T0, E0, cur0
    used = torch.zeros(T0.shape, dtype=torch.bool, device=T0.device)
    n_acc = torch.zeros(cur0.shape, dtype=torch.int64, device=T0.device)
    thr0 = cur0 - 1e-9
    acc, car = [], []
    for i in range(K):
        e = edges[..., i, :]
        improving = valid[..., i] & (J[..., i] < thr0)
        blocked = used.gather(-1, e).any(-1) | (n_acc >= accept_top)
        T_try = T.scatter(-1, e, Tn[..., i, :])
        E_try = E.scatter(-1, e, En[..., i, :])
        J_try = _objective(T_try, E_try, T_cl, E_cl, lam)
        ok = improving & ~blocked & (J_try < cur - 1e-9)
        T = torch.where(ok[..., None], T_try, T)
        E = torch.where(ok[..., None], E_try, E)
        cur = torch.where(ok, J_try, cur)
        touched = (ids == e[..., :1]) | (ids == e[..., 1:])
        used = used | (ok[..., None] & touched)
        n_acc = n_acc + ok.long()
        acc.append(ok)
        car.append(improving & blocked)
    return T, E, cur, torch.stack(acc, -1), torch.stack(car, -1)


def _tensor(a, device):
    """A numpy array (or a broadcast view) as a tensor on ``device``;
    floats as f32, integers as int64."""
    a = np.asarray(a)
    dtype = (torch.bool if a.dtype == np.bool_ else
             torch.int64 if np.issubdtype(a.dtype, np.integer) else
             torch.float32)
    return torch.tensor(a, dtype=dtype, device=device)


def _host(t) -> np.ndarray:
    return t.detach().cpu().numpy()


def _solve(sp, arrays, steps: int, device):
    """``allocate_batch_warm`` on numpy (u, D, p, g, B, masks, tb0, tf0)
    moved to ``device``; returns numpy (T, E, tb, tf)."""
    res, (tb, tf) = ra.allocate_batch_warm(
        sp, *(_tensor(a, device) for a in arrays), steps=steps)
    return _host(res.T_edge), _host(res.E_edge), _host(tb), _host(tf)


def _edges_eval_warm(sp, feats, assign, edges, B, steps, tb0, tf0, *,
                     device):
    """Resource-allocate a subset of edges in one batched call.

    feats: dict of (H,)/(H, M) numpy cohort arrays; edges: edge ids to
    solve; tb0/tf0: (len(edges), H) warm-start iterates (neutral zeros/
    ones make it the cold solve). Returns numpy (T, E, tb, tf): per-edge
    costs without the cloud constants, and the final iterates.
    """
    edges = np.asarray(edges)
    k = len(edges)
    H = feats["u"].shape[0]
    masks = np.asarray(assign)[None, :] == edges[:, None]
    return _solve(sp, (np.broadcast_to(feats["u"], (k, H)),
                       np.broadcast_to(feats["D"], (k, H)),
                       np.broadcast_to(feats["p"], (k, H)),
                       np.asarray(feats["g"])[:, edges].T,
                       np.asarray(B)[edges], masks, tb0, tf0),
                  steps, device)


def _edges_eval(sp, feats, assign, edges: Sequence[int], B,
                alloc_steps: int, *, device) -> Tuple[np.ndarray, np.ndarray]:
    """Cold ``_edges_eval_warm`` returning just the (T, E) costs — the
    serial oracle's per-trial solve."""
    k = len(np.asarray(edges))
    H = feats["u"].shape[0]
    T, E, _, _ = _edges_eval_warm(sp, feats, assign, edges, B, alloc_steps,
                                  np.zeros((k, H), np.float32),
                                  np.ones((k, H), np.float32), device=device)
    return T, E


def _edges_eval_warm_pops(sp, feats_e, assign_e, B_e, steps: int, tb0, tf0,
                          *, device):
    """``_edges_eval_warm`` over E populations' full edge sets at once:
    population e's (M, H) problems are rows [e·M, (e+1)·M) of one batch.
    tb0/tf0: (E, M, H). Returns numpy (T (E, M), E (E, M), tb, tf
    (E, M, H))."""
    E_pop = len(feats_e)
    H = feats_e[0]["u"].shape[0]
    M = len(np.asarray(B_e[0]))
    edge_ids = np.arange(M)
    parts = []
    for feats, assign, B in zip(feats_e, assign_e, B_e):
        masks = np.asarray(assign)[None, :] == edge_ids[:, None]
        parts.append((np.broadcast_to(feats["u"], (M, H)),
                      np.broadcast_to(feats["D"], (M, H)),
                      np.broadcast_to(feats["p"], (M, H)),
                      np.asarray(feats["g"]).T, np.asarray(B), masks))
    cat = [np.concatenate([p[i] for p in parts]) for i in range(6)]
    T, E, tb, tf = _solve(sp, (*cat, np.reshape(tb0, (E_pop * M, H)),
                               np.reshape(tf0, (E_pop * M, H))),
                          steps, device)
    return (T.reshape(E_pop, M), E.reshape(E_pop, M),
            tb.reshape(E_pop, M, H), tf.reshape(E_pop, M, H))


def total_objective(sp: cm.SystemParams, pop: cm.Population, sched_idx,
                    assign, alloc_steps: int = 200
                    ) -> Tuple[float, np.ndarray, np.ndarray]:
    """J(Ψ) for a full assignment; returns (J, T_m array, E_m array)."""
    dev = pop.u.device
    res = ra.allocate_all_edges(
        sp, pop, torch.as_tensor(np.asarray(sched_idx), device=dev),
        torch.as_tensor(np.asarray(assign), device=dev), steps=alloc_steps)
    T_cl, E_cl = cm.cloud_cost(sp, pop.g_cloud)
    T_m = _host(res.T_edge) + _host(T_cl)
    E_m = _host(res.E_edge) + _host(E_cl)
    return float(E_m.sum() + sp.lam * T_m.max()), T_m, E_m


def _apply_move(assign: np.ndarray, move) -> np.ndarray:
    """New assignment after one transfer/exchange move (copy)."""
    kind, x, y = move
    na = assign.copy()
    if kind == _TRANSFER:
        na[x] = y
    else:
        na[x], na[y] = assign[y], assign[x]
    return na


def _move_edges(assign: np.ndarray, move) -> Tuple[int, int]:
    """The two edges whose membership a move changes."""
    kind, x, y = move
    return (int(assign[x]), int(y)) if kind == _TRANSFER else \
        (int(assign[x]), int(assign[y]))


@dataclasses.dataclass
class _BatchedState:
    """Incumbent of the batched search: assignment, per-edge (T, E)
    caches, and the per-edge solver iterates seeding warm re-solves."""
    assign: np.ndarray   # (H,) current edge per scheduled device
    T: np.ndarray        # (M,) cached per-edge delays
    E: np.ndarray        # (M,) cached per-edge energies
    tb: np.ndarray       # (M, H) bandwidth-logit iterates
    tf: np.ndarray       # (M, H) frequency iterates
    cur: float = np.inf  # objective J of the incumbent


@dataclasses.dataclass
class HFELAssigner:
    """HFEL search on the device of the population it is given."""
    sp: cm.SystemParams
    n_transfer: int = 100
    n_exchange: int = 300
    alloc_steps: int = 200
    search: str = "batched"        # "batched" | "serial" (oracle)
    n_candidates: int = 16         # K: trials per batched round

    def _check_search(self):
        if self.search not in ("batched", "serial"):
            raise ValueError(f"unknown HFEL search engine: {self.search!r}")

    def assign(self, pop: cm.Population, sched_idx: np.ndarray,
               rng: np.random.Generator,
               init_assign: Optional[np.ndarray] = None
               ) -> Tuple[np.ndarray, float]:
        """(assignment (H,), J) for the scheduled cohort ``sched_idx``;
        ``rng`` draws the proposals (the caller's Generator advances)."""
        self._check_search()
        if self.search == "batched":
            A, J = self.assign_batch(
                [pop], sched_idx, [rng],
                None if init_assign is None else [init_assign])
            return A[0], float(J[0])
        sched_idx = np.asarray(sched_idx)
        feats, B, T_cl, E_cl, assign = self._cohort(pop, sched_idx,
                                                    init_assign)
        obj = functools.partial(_objective, T_cl=T_cl, E_cl=E_cl,
                                lam=self.sp.lam)
        return self._search_serial(feats, B, obj, assign, rng,
                                   len(sched_idx), pop.n_edges, pop.u.device)

    def _cohort(self, pop: cm.Population, sched: np.ndarray,
                init_assign: Optional[np.ndarray]):
        """Host-side numpy cohort of one population: feature dict,
        bandwidths, cloud constants and the initial (best-gain or
        caller-provided) assignment."""
        g = _host(pop.g)[sched]
        feats = {"u": _host(pop.u)[sched], "D": _host(pop.D)[sched],
                 "p": _host(pop.p)[sched], "g": g}
        T_cl, E_cl = cm.cloud_cost(self.sp, pop.g_cloud)
        if init_assign is None:
            assign = np.asarray(np.argmax(g, axis=1))
        else:
            assign = np.asarray(init_assign).copy()
        return feats, _host(pop.B_m), _host(T_cl), _host(E_cl), assign

    # ----------------------------------------- lockstep population waves

    def assign_batch(self, pops, sched_idx, rngs,
                     init_assigns: Optional[np.ndarray] = None
                     ) -> Tuple[np.ndarray, np.ndarray]:
        """Search E populations' assignments in lockstep waves (the D3QN
        trainer's imitation targets).

        pops: a ``cost_model.PopulationBatch`` or a sequence of
        same-shape ``Population``s; sched_idx: one shared (H,) schedule
        or per-population (E, H); rngs: one Generator (or int seed) per
        population, consumed as E independent ``assign`` calls would
        consume them. Under ``search="batched"`` each round solves every
        population's K candidates in one ``allocate_batch_warm`` call and
        commits them through one accept pass; population e's search is
        the one ``assign(pops[e], ..., rngs[e])`` would run alone (the
        batched ``assign`` is this call with E=1). ``search="serial"``
        runs E oracle searches.

        Returns (assigns (E, H), objectives (E,)).
        """
        self._check_search()
        pop_list = (pops.populations() if hasattr(pops, "populations")
                    else list(pops))
        E_pop = len(pop_list)
        rngs = [r if isinstance(r, np.random.Generator)
                else np.random.default_rng(r) for r in rngs]
        sched_idx = np.asarray(sched_idx)
        if sched_idx.ndim == 1:
            scheds = np.broadcast_to(sched_idx, (E_pop, len(sched_idx)))
        else:
            scheds = sched_idx

        if self.search == "serial":
            outs = [self.assign(pop, scheds[e], rngs[e],
                                None if init_assigns is None
                                else init_assigns[e])
                    for e, pop in enumerate(pop_list)]
            return (np.stack([o[0] for o in outs]),
                    np.array([o[1] for o in outs]))

        device = pop_list[0].u.device
        H = scheds.shape[1]
        M = pop_list[0].n_edges
        K = max(1, int(self.n_candidates))

        feats_e, B_e, Tcl_e, Ecl_e, assigns0 = [], [], [], [], []
        for e, pop in enumerate(pop_list):
            feats, B, T_cl, E_cl, assign0 = self._cohort(
                pop, scheds[e],
                None if init_assigns is None else init_assigns[e])
            feats_e.append(feats)
            B_e.append(B)
            Tcl_e.append(T_cl)
            Ecl_e.append(E_cl)
            assigns0.append(assign0)

        # all E*M edges in one full-fidelity cold solve
        T0, E0, tb0, tf0 = _edges_eval_warm_pops(
            self.sp, feats_e, assigns0, B_e, self.alloc_steps,
            np.zeros((E_pop, M, H), np.float32),
            np.ones((E_pop, M, H), np.float32), device=device)
        states = []
        for e in range(E_pop):
            st = _BatchedState(assigns0[e], T0[e], E0[e],
                               np.array(tb0[e]), np.array(tf0[e]))
            st.cur = float(_objective(st.T, st.E, Tcl_e[e], Ecl_e[e],
                                      self.sp.lam))
            states.append(st)
        # population-stacked cohort arrays: each round assembles its
        # trial batch with whole-(E, K, 2, ...) numpy ops on these
        stk = {"u": np.stack([f["u"] for f in feats_e]),
               "D": np.stack([f["D"] for f in feats_e]),
               "p": np.stack([f["p"] for f in feats_e]),
               "gT": np.stack([f["g"].T for f in feats_e]),   # (E, M, H)
               "B": np.stack(B_e),
               "Tcl": np.stack(Tcl_e), "Ecl": np.stack(Ecl_e)}

        for kind, budget in ((_TRANSFER, self.n_transfer),
                             (_EXCHANGE, self.n_exchange)):
            remaining = int(budget)
            carries: List[List[tuple]] = [[] for _ in range(E_pop)]
            while remaining > 0:
                k = min(K, remaining)
                remaining -= k
                moves_e = [self._propose(rngs[e], states[e].assign, H, M,
                                         k, kind, carries[e])
                           for e in range(E_pop)]
                carries = self._round_pops(moves_e, stk, states, K,
                                           _warm_steps(self.alloc_steps),
                                           device)
        return (np.stack([st.assign for st in states]),
                np.array([st.cur for st in states]))

    def _round_pops(self, moves_e, stk, states, K, warm_steps, device
                    ) -> List[List[tuple]]:
        """One lockstep round: every population's K candidates solved in
        one ``allocate_batch_warm`` call and committed through one accept
        pass. A population with fewer than K valid moves pads with
        incumbent rows, solved but marked invalid. Returns the
        per-population carry lists."""
        E_pop = len(states)
        H = states[0].assign.shape[0]
        ns = np.array([len(m) for m in moves_e])
        cand = np.empty((E_pop, K, H), states[0].assign.dtype)
        edges = np.zeros((E_pop, K, 2), np.int64)
        for e, (moves, st) in enumerate(zip(moves_e, states)):
            cand[e] = st.assign            # padding rows: incumbent, edge 0
            for i, mv in enumerate(moves):
                cand[e, i] = _apply_move(st.assign, mv)
                edges[e, i] = _move_edges(st.assign, mv)

        eE = np.arange(E_pop)[:, None, None]
        masks = cand[:, :, None, :] == edges[:, :, :, None]     # (E,K,2,H)
        g = stk["gT"][eE, edges]                                # (E,K,2,H)
        u = np.broadcast_to(stk["u"][:, None, None, :], masks.shape)
        D = np.broadcast_to(stk["D"][:, None, None, :], masks.shape)
        p = np.broadcast_to(stk["p"][:, None, None, :], masks.shape)
        B_k = stk["B"][eE, edges]                               # (E,K,2)
        tb0 = np.stack([st.tb for st in states])[eE, edges]     # (E,K,2,H)
        tf0 = np.stack([st.tf for st in states])[eE, edges]

        def fl(a):             # (E, K, 2, ...) -> trial-major (E*K, 2, ...)
            return a.reshape((E_pop * K,) + a.shape[2:])

        flat = ra.flatten_trials(fl(u), fl(D), fl(p), fl(g), fl(B_k),
                                 fl(masks), fl(tb0), fl(tf0))
        Tn, En, tb, tf = _solve(self.sp, flat, warm_steps, device)
        Tn = Tn.reshape(E_pop, K, 2)
        En = En.reshape(E_pop, K, 2)
        tb_n = tb.reshape(E_pop, K, 2, H)
        tf_n = tf.reshape(E_pop, K, 2, H)

        # score all E*K candidate objectives in one vectorised pass
        T_inc = np.stack([st.T for st in states])               # (E, M)
        E_inc = np.stack([st.E for st in states])
        T2 = np.repeat(T_inc[:, None], K, axis=1)               # (E, K, M)
        E2 = np.repeat(E_inc[:, None], K, axis=1)
        kK = np.arange(K)[None, :, None]
        T2[eE, kK, edges] = Tn
        E2[eE, kK, edges] = En
        J = np.asarray(_objective(T2, E2, stk["Tcl"][:, None],
                                  stk["Ecl"][:, None], self.sp.lam))
        valid = np.arange(K)[None] < ns[:, None]                # (E, K)
        J = np.where(valid, J, np.inf)                          # pad rows last
        order = np.argsort(J, axis=1)

        def srt(a):
            ix = order.reshape(E_pop, K, *([1] * (a.ndim - 2)))
            return np.take_along_axis(a, ix, axis=1)

        T_out, E_out, cur, acc, car = (_host(t) for t in _accept_scan_core(
            *(_tensor(a, device) for a in (
                np.take_along_axis(J, order, axis=1), srt(edges), srt(Tn),
                srt(En), T_inc, E_inc,
                np.array([st.cur for st in states], np.float32),
                stk["Tcl"], stk["Ecl"],
                np.full((E_pop,), self.sp.lam, np.float32), valid)),
            accept_top=_ACCEPT_TOP))

        carries: List[List[tuple]] = []
        for e in range(E_pop):
            st = states[e]
            moves = moves_e[e]
            carry: List[tuple] = []
            for pos in range(ns[e]):
                i = order[e, pos]
                if acc[e, pos]:
                    st.assign = _apply_move(st.assign, moves[i])
                    st.tb[edges[e, i]] = tb_n[e, i]
                    st.tf[edges[e, i]] = tf_n[e, i]
                elif car[e, pos]:
                    carry.append(moves[i])
            if acc[e, :ns[e]].any():
                st.T, st.E = T_out[e].copy(), E_out[e].copy()
                st.cur = float(cur[e])
            carries.append(carry)
        return carries

    # ------------------------------------------------------ serial oracle

    def _search_serial(self, feats, B, obj, assign, rng, H, M, device):
        """One-trial-at-a-time accept/reject loop (original HFEL)."""
        # per-edge cached terms — all M edges in one batched solve
        T, E = _edges_eval(self.sp, feats, assign, np.arange(M), B,
                           self.alloc_steps, device=device)
        cur = float(obj(T, E))

        def try_move(new_assign, edges):
            nonlocal cur, assign, T, E
            T2, E2 = T.copy(), E.copy()
            edges = list(edges)
            T2[edges], E2[edges] = _edges_eval(
                self.sp, feats, new_assign, edges, B, self.alloc_steps,
                device=device)
            new = float(obj(T2, E2))
            if new < cur - 1e-9:
                assign, T, E, cur = new_assign, T2, E2, new
                return True
            return False

        # ---- transfer adjustments
        for _ in range(self.n_transfer):
            h = rng.integers(H)
            src = assign[h]
            dst = rng.integers(M)
            if dst == src:
                continue
            na = assign.copy()
            na[h] = dst
            try_move(na, (src, dst))

        # ---- exchange adjustments
        for _ in range(self.n_exchange):
            h1, h2 = rng.integers(H), rng.integers(H)
            m1, m2 = assign[h1], assign[h2]
            if m1 == m2:
                continue
            na = assign.copy()
            na[h1], na[h2] = m2, m1
            try_move(na, (m1, m2))

        return assign, cur

    # -------------------------------------------------- batched K-rounds

    def _propose(self, rng, assign, H, M, k, kind,
                 carry: List[tuple]) -> List[tuple]:
        """One round of k trial moves: carried-over moves first
        (improving last round but blocked by an accepted move), topped up
        with fresh proposals sampled without replacement from the move
        neighborhood of ``assign``. Invalid draws (self-transfer,
        same-edge exchange) consume trial budget without a solve, so a
        budget of n means n raw trials under either engine."""
        moves = [mv for mv in carry
                 if _move_edges(assign, mv)[0] != _move_edges(assign, mv)[1]
                 ][:k]
        seen = {mv[1:] if mv[0] == _EXCHANGE else mv for mv in moves}
        fresh = k - len(moves)
        if fresh <= 0:
            return moves
        if kind == _TRANSFER:                      # (device h, dest edge)
            raw = rng.choice(H * M, size=min(fresh, H * M), replace=False)
            h, dst = raw // M, raw % M
            ok = assign[h] != dst
            for a, b in zip(h[ok], dst[ok]):
                mv = (_TRANSFER, int(a), int(b))
                if mv not in seen:
                    seen.add(mv)
                    moves.append(mv)
            return moves
        # exchange: ordered (h1, h2) like the serial draws, then
        # canonicalised so a round never evaluates the same swap twice
        raw = rng.choice(H * H, size=min(fresh, H * H), replace=False)
        h1, h2 = raw // H, raw % H
        ok = (h1 != h2) & (assign[h1] != assign[h2])
        for a, b in zip(h1[ok], h2[ok]):
            key = (int(min(a, b)), int(max(a, b)))
            if key not in seen:
                seen.add(key)
                moves.append((_EXCHANGE, key[0], key[1]))
        return moves


# ------------------------------------------------ device search (fused)

def _round_plan(n_transfer: int, n_exchange: int, K: int):
    """Static per-round (kind, budget) plan of the K-candidate search:
    ``ceil(n_transfer/K)`` transfer rounds then ``ceil(n_exchange/K)``
    exchange rounds, the last round of each phase carrying the remainder
    budget — the host engines' trial accounting as two int32 arrays."""
    kinds, budgets = [], []
    for kind, budget in ((_TRANSFER, n_transfer), (_EXCHANGE, n_exchange)):
        remaining = int(budget)
        while remaining > 0:
            k = min(K, remaining)
            remaining -= k
            kinds.append(kind)
            budgets.append(k)
    return np.asarray(kinds, np.int32), np.asarray(budgets, np.int32)


def hfel_search_traced(sp: cm.SystemParams, u, D, p, g, B_m, g_cloud,
                       words: Optional[torch.Tensor] = None, *,
                       draws=None, n_transfer: int = 40,
                       n_exchange: int = 80, n_candidates: int = 16,
                       alloc_steps: int = 100,
                       warm_steps: Optional[int] = None,
                       accept_top: int = _ACCEPT_TOP):
    """The K-candidate HFEL search of S lanes at once, entirely on the
    device (the fused sweep's assigner; port of the reference's
    ``hfel_search_traced``).

    u/D/p (S, H) cohort features, g (S, H, M) cohort gains, B_m and
    g_cloud (S, M). Per lane, as the reference: the best-gain start and
    a cold solve of its M edges; then for each round of
    :func:`_round_plan` both proposal kinds are drawn (the first K of a
    permutation of the H·M transfers and of the H·H ordered exchanges)
    and selected on the round's kind, the 2K affected edges of all lanes
    solve in one ``allocate_batch_warm`` call (S·K·2 rows, warm from the
    incumbent's iterates), ``_accept_scan_core`` commits up to
    ``accept_top`` non-conflicting improving moves in J order, and the
    accepted moves' assignments and iterates are written back. No carry
    list, as in the reference: a blocked move may be drawn again.

    Proposals: ``draws`` gives the raw permutation prefixes,
    ``(raw_t, raw_e)``, each (S, n_plan_rounds, K) int64 (a test feeds
    the reference's ``jax.random`` outcomes); otherwise they come from
    the counter-based stream of ``words`` ((S, W) int64, one row a lane;
    ``utils.permutation_prefix``). Returns (assign (S, H) int64, J (S,)).
    """
    S, H, M = g.shape
    K = max(1, int(n_candidates))
    if K > min(H * M, H * H):
        raise ValueError(f"n_candidates={K} exceeds the move "
                         f"neighborhood (H={H}, M={M})")
    if draws is None and words is None:
        raise ValueError("hfel_search_traced needs words= or draws=")
    warm = warm_steps or _warm_steps(alloc_steps)
    dev = g.device
    T_cl, E_cl = cm.cloud_cost(sp, g_cloud)                  # (S, M)
    lam = sp.lam
    gT = g.transpose(1, 2)                                  # (S, M, H)
    assign = torch.argmax(g, dim=-1)                        # (S, H)
    lanes = torch.arange(S, device=dev)
    rowsK = torch.arange(K, device=dev)

    # cold solve of every lane's M incumbent edges at full fidelity
    masks0 = assign[:, None, :] == torch.arange(M, device=dev)[None, :, None]
    flat = S * M
    res0, (tb, tf) = ra.allocate_batch_warm(
        sp, u[:, None].expand(S, M, H).reshape(flat, H),
        D[:, None].expand(S, M, H).reshape(flat, H),
        p[:, None].expand(S, M, H).reshape(flat, H), gT.reshape(flat, H),
        B_m.reshape(flat), masks0.reshape(flat, H),
        torch.zeros((flat, H), device=dev), torch.ones((flat, H), device=dev),
        steps=alloc_steps)
    T = res0.T_edge.reshape(S, M)
    E = res0.E_edge.reshape(S, M)
    tb, tf = tb.reshape(S, M, H), tf.reshape(S, M, H)
    cur = _objective(T, E, T_cl, E_cl, lam)

    def take(a, idx):                    # a (S, H), idx (S, K) -> (S, K)
        return torch.gather(a, 1, idx)

    kinds, budgets = _round_plan(n_transfer, n_exchange, K)
    for j, (kind, k_budget) in enumerate(zip(kinds, budgets)):
        if draws is None:
            raw_t = permutation_prefix(words, (j, 0), H * M, K)
            raw_e = permutation_prefix(words, (j, 1), H * H, K)
        else:
            raw_t, raw_e = draws[0][:, j], draws[1][:, j]
        h_t, dst = raw_t // M, raw_t % M
        src = take(assign, h_t)
        h1, h2 = raw_e // H, raw_e % H
        a1, a2 = take(assign, h1), take(assign, h2)
        # unified move layout: device d0 -> edge v0, device d1 -> edge v1
        # (transfer: d0 == d1 == the moved device), affected edges (e0, e1)
        if kind == _TRANSFER:
            d0 = d1 = h_t
            v0 = v1 = dst
            e0, e1, valid = src, dst, src != dst
        else:
            d0, d1, v0, v1 = h1, h2, a2, a1
            e0, e1, valid = a1, a2, (h1 != h2) & (a1 != a2)
        valid = valid & (rowsK < int(k_budget))

        cand = assign[:, None, :].repeat(1, K, 1)           # (S, K, H)
        cand.scatter_(2, d0[..., None], v0[..., None])
        cand.scatter_(2, d1[..., None], v1[..., None])
        edges = torch.stack([e0, e1], dim=-1)               # (S, K, 2)
        masks = cand[:, :, None, :] == edges[..., None]     # (S, K, 2, H)
        li = lanes[:, None, None]
        rows = S * K * 2

        def trial(x):                    # (S, H) -> (S·K·2, H)
            return x[:, None, None].expand(S, K, 2, H).reshape(rows, H)

        res, (tb_f, tf_f) = ra.allocate_batch_warm(
            sp, trial(u), trial(D), trial(p), gT[li, edges].reshape(rows, H),
            B_m[li, edges].reshape(rows), masks.reshape(rows, H),
            tb[li, edges].reshape(rows, H), tf[li, edges].reshape(rows, H),
            steps=warm)
        Tn = res.T_edge.reshape(S, K, 2)
        En = res.E_edge.reshape(S, K, 2)
        tb_n, tf_n = tb_f.reshape(S, K, 2, H), tf_f.reshape(S, K, 2, H)

        T2 = T[:, None].repeat(1, K, 1).scatter(2, edges, Tn)    # (S, K, M)
        E2 = E[:, None].repeat(1, K, 1).scatter(2, edges, En)
        J = torch.where(valid, _objective(T2, E2, T_cl[:, None],
                                          E_cl[:, None], lam), torch.inf)
        order = torch.argsort(J, dim=1, stable=True)

        def srt(a):
            return torch.take_along_dim(
                a, order.reshape((S, K) + (1,) * (a.dim() - 2)), dim=1)

        T, E, cur, acc, _ = _accept_scan_core(
            srt(J), srt(edges), srt(Tn), srt(En), T, E, cur, T_cl, E_cl,
            lam, srt(valid), accept_top=accept_top)

        # commit the accepted moves in sorted order; accepted sets are
        # edge-disjoint hence device-disjoint, so the round-start (d, v)
        # values compose exactly
        for i in range(K):
            idx = order[:, i:i + 1]                         # (S, 1)
            on = acc[:, i:i + 1]
            for d, v in ((d0, v0), (d1, v1)):
                di = take(d, idx)
                assign.scatter_(1, di, torch.where(on, take(v, idx),
                                                   take(assign, di)))
            ei = edges[lanes, idx[:, 0]]                    # (S, 2)
            keep = on[..., None]
            tb[lanes[:, None], ei] = torch.where(
                keep, tb_n[lanes, idx[:, 0]], tb[lanes[:, None], ei])
            tf[lanes[:, None], ei] = torch.where(
                keep, tf_n[lanes, idx[:, 0]], tf[lanes[:, None], ei])
    return assign, cur
