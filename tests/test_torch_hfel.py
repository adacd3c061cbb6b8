"""The port's HFEL search (``repro_torch.core.assignment.hfel``), its
resource helpers and ``PopulationBatch`` against ``repro``, at
``SystemParams(n_devices=10, n_edges=3)`` and cohorts of H=8.

Tolerances:
- populations, ``PopulationBatch`` and ``_propose``: bitwise (numpy in
  the reference's draw order on both sides);
- warm allocator at 30 Adam steps, from neutral and from carried
  iterates: rtol 1e-4 (each step carries the f32 gap of another
  softmax/logsumexp summation order forward; measured ≤ 2.3e-5 at 30
  steps in ``test_torch_hfl_resource.py``);
- accept pass on identical inputs: flags equal, T/E/cur rtol 1e-6
  (sums of a few f32 terms in the same order);
- whole searches (serial, batched, ``assign_batch``) at
  ``alloc_steps=30``, fixed seeds: equal assignments, J rtol 1e-4. No
  decision flipped at these seeds; a flip would show as an assignment
  mismatch, and the test keeps its seed;
- ``total_objective``: J and each edge's E_m + T_m rtol 1e-4; its T/E
  split rtol 1e-3 (at 30 steps one edge's E_m differs by 3.2e-4 while
  its E_m + T_m agrees to 3.8e-5: the split of a flat optimum moves);
- ``HFLFramework(assigner="hfel")``: cohorts and assignments equal, the
  framework test's record tolerances (T_i/E_i/obj_i rtol 1e-5, accuracy
  to one test sample). The framework builds HFEL with its own
  ``alloc_steps=200``; both sides then get ``alloc_steps=30`` and
  HFEL-20/40 so the search runs in seconds and stays inside the
  allocator's well-conditioned range. Final params atol 1e-3 (measured
  2e-4): HFEL's round-2 assignment puts the whole cohort on one edge,
  and there Algorithm 1 (not HFEL) sits at a kink of this world's
  training (ReLU and max-pool are piecewise linear): on this cohort the
  port's own params move by 2.6e-4 under a 2e-7 relative change of the
  initial weights (the reference's by 1.5e-5 under 1e-6), while a
  round's update is ~1.2e-2. Algorithm 1 is held to atol 1e-6 on the
  geo world in ``test_torch_framework.py``.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core.cost_model as jcm
import repro.core.resource as jra
from repro.core.assignment import hfel as jh
from repro.core.framework import FrameworkConfig as JConfig
import repro_torch.core.cost_model as tcm
import repro_torch.core.resource as tra
from repro_torch.core.assignment import hfel as th
from repro_torch.core.framework import FrameworkConfig as TConfig
from test_torch_framework import _two_rounds_match_reference
from test_torch_framework import one_torch_thread  # noqa: F401 (autouse)

KW = dict(n_devices=10, n_edges=3)
SP_J, SP_T = jcm.SystemParams(**KW), tcm.SystemParams(**KW)
SCHED = np.arange(1, 9)
H, M = len(SCHED), 3


def _pops(seed=3):
    return (jcm.sample_population(SP_J, seed=seed),
            tcm.sample_population(SP_T, seed=seed, device="cpu"))


def _edge_inputs(pop, assign):
    """(M, H) allocation inputs of SCHED under ``assign``, numpy."""
    g = np.asarray(pop.g)[SCHED]
    mask = assign[None, :] == np.arange(M)[:, None]
    bc = lambda a: np.broadcast_to(np.asarray(a)[SCHED], (M, H))  # noqa: E731
    return bc(pop.u), bc(pop.D), bc(pop.p), g.T, np.asarray(pop.B_m), mask


def _t(*arrs):
    return [torch.tensor(np.asarray(a)) for a in arrs]


def test_allocate_batch_warm_matches_from_neutral_and_carried_iterates():
    pj, pt = _pops()
    assign = np.array([0, 1, 2, 0, 0, 1, 2, 2])
    ins = _edge_inputs(pj, assign)
    tb0, tf0 = np.zeros((M, H), np.float32), np.ones((M, H), np.float32)
    rj, (tbj, tfj) = jra.allocate_batch_warm(SP_J, *ins, tb0, tf0, steps=30)
    rt, (tbt, tft) = tra.allocate_batch_warm(SP_T, *_t(*ins, tb0, tf0),
                                             steps=30)
    for f in ("b", "f", "T_edge", "E_edge", "obj"):
        np.testing.assert_allclose(getattr(rt, f).numpy(),
                                   np.asarray(getattr(rj, f)), rtol=1e-4,
                                   err_msg=f)
    # neutral iterates are the cold solve, bit for bit
    cold = tra.allocate_batch(SP_T, *_t(*ins), steps=30)
    for f in ("b", "f", "T_edge", "E_edge"):
        torch.testing.assert_close(getattr(cold, f), getattr(rt, f),
                                   rtol=0, atol=0)
    # carried iterates: the reference's own, into a moved-device problem
    moved = assign.copy()
    moved[0] = 1
    ins2 = _edge_inputs(pj, moved)
    tbc, tfc = np.asarray(tbj), np.asarray(tfj)
    rj2, (tbj2, _) = jra.allocate_batch_warm(SP_J, *ins2, tbc, tfc, steps=30)
    rt2, (tbt2, _) = tra.allocate_batch_warm(SP_T, *_t(*ins2, tbc, tfc),
                                             steps=30)
    for f in ("b", "f", "T_edge", "E_edge", "obj"):
        np.testing.assert_allclose(getattr(rt2, f).numpy(),
                                   np.asarray(getattr(rj2, f)), rtol=1e-4,
                                   err_msg=f)
    np.testing.assert_allclose(tbt2.numpy(), np.asarray(tbj2), rtol=1e-4,
                               atol=1e-4)


def test_trial_layout_and_edge_helpers_match():
    """flatten/unflatten, gather_edge_inputs + allocate_all_edges,
    allocate_uniform, edge_objective_with_cloud and total_objective."""
    pj, pt = _pops(5)
    K, E = 4, 2
    rng = np.random.default_rng(0)
    arrs = [rng.random((K, E, H)).astype(np.float32) for _ in range(4)]
    B = rng.random((K, E)).astype(np.float32)
    mask = rng.random((K, E, H)) < 0.5
    fj = jra.flatten_trials(*arrs, B, mask, arrs[0])
    ft = tra.flatten_trials(*_t(*arrs, B, mask, arrs[0]))
    for a, b in zip(fj, ft):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))
    res = tra.AllocResult(*(ft[0], ft[1], ft[4], ft[4], ft[4]))
    un = tra.unflatten_trials(res, K, E)
    np.testing.assert_array_equal(un.b.numpy(), arrs[0])
    np.testing.assert_array_equal(un.T_edge.numpy(), B)

    assign = np.array([2, 1, 2, 0, 0, 1, 2, 1])
    for a, b in zip(jra.gather_edge_inputs(pj, SCHED, assign),
                    tra.gather_edge_inputs(pt, *_t(SCHED, assign))):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))
    rj = jra.allocate_all_edges(SP_J, pj, SCHED, assign, steps=30)
    rt = tra.allocate_all_edges(SP_T, pt, *_t(SCHED, assign), steps=30)
    np.testing.assert_allclose(rt.obj.numpy(), np.asarray(rj.obj), rtol=1e-4)
    cj = jra.edge_objective_with_cloud(SP_J, rj, pj.g_cloud)
    ct = tra.edge_objective_with_cloud(SP_T, rt, pt.g_cloud)
    np.testing.assert_allclose(ct.numpy(), np.asarray(cj), rtol=1e-4)
    Jj, Tj, Ej = jh.total_objective(SP_J, pj, SCHED, assign, alloc_steps=30)
    Jt, Tt, Et = th.total_objective(SP_T, pt, SCHED, assign, alloc_steps=30)
    np.testing.assert_allclose([Jt, *(Et + Tt)], [Jj, *(Ej + Tj)], rtol=1e-4)
    np.testing.assert_allclose([*Tt, *Et], [*Tj, *Ej], rtol=1e-3)

    u, D, p, g, Bm, m = _edge_inputs(pj, assign)
    uj = jra.allocate_uniform(SP_J, u[1], D[1], p[1], g[1], Bm[1], m[1])
    ut = tra.allocate_uniform(SP_T, *_t(u[1], D[1], p[1], g[1]),
                              torch.tensor(Bm[1]), torch.from_numpy(m[1]))
    for f in uj._fields:
        np.testing.assert_allclose(getattr(ut, f).numpy(),
                                   np.asarray(getattr(uj, f)), rtol=1e-6,
                                   err_msg=f)


def test_population_batch_bitwise():
    seeds = [11, 22, 33]
    bj = jcm.sample_population_batch(SP_J, seeds=seeds, d_range=(50, 90))
    bt = tcm.sample_population_batch(SP_T, seeds=seeds, d_range=(50, 90),
                                     device="cpu")
    assert (bt.n_pops, bt.n_devices, bt.n_edges) == (3, 10, 3)
    for name in ("u", "D", "p", "f_max", "g", "g_cloud", "B_m", "dev_pos",
                 "edge_pos"):
        got = getattr(bt, name)
        got = got.numpy() if isinstance(got, torch.Tensor) else got
        np.testing.assert_array_equal(got, np.asarray(getattr(bj, name)),
                                      err_msg=name)
    np.testing.assert_array_equal(bt.features().numpy(),
                                  np.asarray(bj.features()))
    for e, s in enumerate(seeds):
        one = tcm.sample_population(SP_T, seed=s, d_range=(50, 90),
                                    device="cpu")
        np.testing.assert_array_equal(bt.pop(e).features().numpy(),
                                      one.features().numpy())
        np.testing.assert_array_equal(
            one.features().numpy(),
            np.asarray(jcm.sample_population(SP_J, seed=s,
                                             d_range=(50, 90)).features()))
    assert float(bt.D.min()) >= 50 and float(bt.D.max()) <= 90
    # n_pops: seeds from SeedSequence, as the reference derives them
    nj = jcm.sample_population_batch(SP_J, n_pops=2, seed=4)
    nt = tcm.sample_population_batch(SP_T, n_pops=2, seed=4, device="cpu")
    np.testing.assert_array_equal(nt.g.numpy(), np.asarray(nj.g))
    with pytest.raises(ValueError, match="n_pops or seeds"):
        tcm.sample_population_batch(SP_T, device="cpu")


def test_propose_bitwise():
    hj, ht = jh.HFELAssigner(SP_J), th.HFELAssigner(SP_T)
    assign = np.array([0, 1, 2, 0, 0, 1, 2, 2])
    carry = [(jh._TRANSFER, 3, 1), (jh._EXCHANGE, 0, 1),
             (jh._TRANSFER, 2, 2)]
    for kind in (jh._TRANSFER, jh._EXCHANGE):
        for k in (3, 8, 40):
            rj, rt = np.random.default_rng(k), np.random.default_rng(k)
            for _ in range(3):
                mj = hj._propose(rj, assign, H, M, k, kind, list(carry))
                mt = ht._propose(rt, assign, H, M, k, kind, list(carry))
                assert mt == mj
    assert rt.random() == rj.random()


@pytest.mark.parametrize("pops", [False, True])
def test_accept_scan_matches_on_identical_inputs(pops):
    """Sorted candidates with near-ties, conflicts and padding; the
    single form and the population-batched form."""
    rng = np.random.default_rng(1 + pops)
    P, K, M_ = 3, 8, 4
    T0 = rng.uniform(1, 10, (P, M_)).astype(np.float32)
    E0 = rng.uniform(1, 10, (P, M_)).astype(np.float32)
    Tcl = rng.uniform(0.1, 1, (P, M_)).astype(np.float32)
    Ecl = rng.uniform(0.1, 1, (P, M_)).astype(np.float32)
    lam = np.ones(P, np.float32)
    cur0 = np.asarray(jh._objective(T0, E0, Tcl, Ecl, 1.0), np.float32)
    edges = np.stack([rng.choice(M_, 2, replace=False)
                      for _ in range(P * K)]).reshape(P, K, 2)
    Tn = (T0[np.arange(P)[:, None, None], edges]
          * rng.uniform(0.6, 1.1, (P, K, 2))).astype(np.float32)
    En = (E0[np.arange(P)[:, None, None], edges]
          * rng.uniform(0.6, 1.1, (P, K, 2))).astype(np.float32)
    T2 = np.repeat(T0[:, None], K, 1)
    E2 = np.repeat(E0[:, None], K, 1)
    kk = np.arange(K)[None, :, None]
    T2[np.arange(P)[:, None, None], kk, edges] = Tn
    E2[np.arange(P)[:, None, None], kk, edges] = En
    J = np.asarray(jh._objective(T2, E2, Tcl[:, None], Ecl[:, None], 1.0))
    valid = np.arange(K)[None] < np.array([K, K - 2, 5])[:, None]
    J = np.where(valid, J, np.inf).astype(np.float32)
    order = np.argsort(J, axis=1)
    srt = lambda a: np.take_along_axis(  # noqa: E731
        a, order.reshape(P, K, *([1] * (a.ndim - 2))), axis=1)
    args = [np.take_along_axis(J, order, 1), srt(edges), srt(Tn), srt(En),
            T0, E0, cur0, Tcl, Ecl, lam, valid]
    if pops:
        outj = jh._accept_scan_pops(*map(jnp.asarray, args), accept_top=2)
        outt = th._accept_scan_core(*_t(*args), accept_top=2)
    else:
        args = [a[0] for a in args]
        outj = jh._accept_scan(*map(jnp.asarray, args), accept_top=2)
        outt = th._accept_scan_core(*_t(*args), accept_top=2)
    for a, b in zip(outj[:3], outt[:3]):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-6)
    for a, b in zip(outj[3:], outt[3:]):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))
    assert np.asarray(outj[3]).any() and np.asarray(outj[4]).any()


@pytest.mark.parametrize("search", ["serial", "batched"])
def test_assign_matches_reference(search):
    pj, pt = _pops(3)
    kw = dict(n_transfer=20, n_exchange=40, alloc_steps=30, search=search,
              n_candidates=4)
    rj, rt = np.random.default_rng(0), np.random.default_rng(0)
    aj, Jj = jh.HFELAssigner(SP_J, **kw).assign(pj, SCHED, rj)
    at, Jt = th.HFELAssigner(SP_T, **kw).assign(pt, SCHED, rt)
    np.testing.assert_array_equal(at, aj)
    np.testing.assert_allclose(Jt, Jj, rtol=1e-4)
    assert rt.random() == rj.random()          # same draws consumed
    init = np.asarray(np.argmax(np.asarray(pj.g)[SCHED], axis=1))
    J0, _, _ = th.total_objective(SP_T, pt, SCHED, init, alloc_steps=30)
    assert Jt < J0


def test_assign_batch_matches_reference_and_per_population_assign():
    seeds = [11, 22, 33]
    bj = jcm.sample_population_batch(SP_J, seeds=seeds)
    bt = tcm.sample_population_batch(SP_T, seeds=seeds, device="cpu")
    kw = dict(n_transfer=12, n_exchange=16, alloc_steps=30, n_candidates=4)
    hj, ht = jh.HFELAssigner(SP_J, **kw), th.HFELAssigner(SP_T, **kw)
    Aj, Jj = hj.assign_batch(bj, SCHED, [0, 1, 2])
    At, Jt = ht.assign_batch(bt, SCHED, [0, 1, 2])
    assert At.shape == (3, H) and Jt.shape == (3,)
    np.testing.assert_array_equal(At, Aj)
    np.testing.assert_allclose(Jt, Jj, rtol=1e-4)
    for e in range(3):
        a, j = ht.assign(bt.pop(e), SCHED, np.random.default_rng(e))
        np.testing.assert_array_equal(At[e], a)
        assert Jt[e] == pytest.approx(j, rel=1e-6)
    ser = dataclasses.replace(ht, search="serial")
    A2, J2 = ser.assign_batch(bt.populations()[:2], SCHED, [0, 1])
    for e in range(2):
        a, j = ser.assign(bt.pop(e), SCHED, np.random.default_rng(e))
        np.testing.assert_array_equal(A2[e], a)
        assert J2[e] == j
    with pytest.raises(ValueError, match="search engine"):
        dataclasses.replace(ht, search="magic").assign_batch(bt, SCHED, [0])


def test_framework_hfel_two_rounds_match_reference():
    kw = dict(H=6, K=3, alloc_steps=30, scheduler="ikc", assigner="hfel",
              hfel_candidates=4, seed=0)

    def shrink(fw):                 # HFEL-20/40 at 30 allocator steps
        assert fw.assigner.alloc_steps == 200
        fw.assigner.n_transfer, fw.assigner.n_exchange = 20, 40
        fw.assigner.alloc_steps = 30

    _two_rounds_match_reference(JConfig(**kw), TConfig(device="cpu", **kw),
                                prepare=shrink, param_atol=1e-3)
