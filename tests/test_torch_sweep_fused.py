"""The fused sweep engine of ``repro_torch.core.sweep`` and the device
twins it runs: ``TracedFedAvg``, ``geo_assign_traced``,
``drl_features_traced`` / ``drl_assign_traced``, ``_round_plan`` and
``hfel_search_traced``.

Parity matrix (who is the oracle for what):

* traced assigners against the reference's traced twins (and the host
  assigners) on random worlds, lane-batched: geo and the greedy DRL
  assignment equal, the DRL features to atol 1e-6 (f32 on both sides);
  the HFEL round plan equal; ``hfel_search_traced`` fed the reference's
  ``jax.random`` permutation prefixes gives the reference's assignment,
  J to rtol 1e-4, at 30-step solves.
* ``TracedFedAvg``: H distinct ids in [0, N), a lane's draws unchanged
  when the lanes around it change, marginals uniform: over 3 000 draws
  of 4 of 12 devices every device's share is within 0.045 of 1/3 (five
  standard deviations of a binomial share, sqrt(2/9/3000) = 0.0086).
* ``run(fused=True)`` against ``fused="oracle"`` (the same device step,
  read back after each round) for geo, drl, hfel and the traced
  scheduler: every record and the final params bitwise equal (the same
  operations in the same order); fused geo with host schedulers
  against the host loop: bitwise equal as well (the traced geo twin
  picks the host's edges on these worlds), with early stop too.
* the reference's rejected configurations, and ``shard=True``.

World: that of ``tests/test_torch_sweep.py`` (S=2, N=12, M=3, L=Q=2,
H=6, 30-step allocations), R=3 rounds.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core.cost_model as jcm
import repro_torch.core.cost_model as tcm
import repro_torch.data as tdata
from repro.core.assignment import drl as jdrl
from repro.core.assignment import geo as jgeo
from repro.core.assignment import hfel as jhfel
from repro_torch.convert import params_from_numpy
from repro_torch.core import sweep as tsw
from repro_torch.core.assignment import drl as tdrl
from repro_torch.core.assignment import geo as tgeo
from repro_torch.core.assignment import hfel as thfel
from repro_torch.core.scheduling.schedulers import TracedFedAvg
from repro_torch.parallel.sharding import AbstractMesh
from test_torch_framework import one_torch_thread  # noqa: F401 (autouse)
from test_torch_sweep import H, KW, M, N, S, _drl_params, _worlds

R = 3


def _pops(seeds):
    sp = jcm.SystemParams(n_devices=N, n_edges=M)
    tsp = tcm.SystemParams(n_devices=N, n_edges=M)
    return (sp, [jcm.sample_population(sp, seed=s) for s in seeds],
            tsp, [tcm.sample_population(tsp, seed=s, device="cpu")
                  for s in seeds])


def _stack(pops, name):
    return torch.stack([torch.as_tensor(np.asarray(getattr(p, name)),
                                        dtype=torch.float32) for p in pops])


def _cohorts(seed, n):
    rng = np.random.default_rng(seed)
    return np.stack([rng.permutation(N)[:H] for _ in range(n)])


# ------------------------------------------------------- traced twins

def test_traced_geo_matches_reference():
    seeds = range(5)
    _, jpops, _, tpops = _pops(seeds)
    sched = _cohorts(0, len(seeds))
    got = tgeo.geo_assign_traced(_stack(tpops, "dev_pos"),
                                 _stack(tpops, "edge_pos"),
                                 torch.from_numpy(sched))
    assert got.dtype == torch.int64 and tuple(got.shape) == sched.shape
    for s, jp in enumerate(jpops):
        want = jgeo.geo_assign_traced(jnp.asarray(jp.dev_pos),
                                      jnp.asarray(jp.edge_pos),
                                      jnp.asarray(sched[s]))
        np.testing.assert_array_equal(got[s].numpy(), np.asarray(want))
        host, _ = jgeo.GeoAssigner(None).assign(jp, sched[s])
        np.testing.assert_array_equal(got[s].numpy(), host)


def test_traced_drl_matches_reference():
    seeds = range(3)
    _, jpops, tsp, tpops = _pops(seeds)
    sched = torch.from_numpy(_cohorts(1, len(seeds)))
    params = _drl_params()
    tparams = params_from_numpy(params, "cpu")
    args = [_stack(tpops, k) for k in ("u", "D", "p", "g")]
    feats = tdrl.drl_features_traced(*args, sched)
    got = tdrl.drl_assign_traced(tparams, *args, sched)
    assert feats.dtype == torch.float32 and got.dtype == torch.int64
    for s, jp in enumerate(jpops):
        jargs = (jp.u, jp.D, jp.p, jp.g, jnp.asarray(sched[s].numpy()))
        np.testing.assert_allclose(
            feats[s].numpy(), np.asarray(jdrl.drl_features_traced(*jargs)),
            atol=1e-6)
        np.testing.assert_array_equal(
            got[s].numpy(), np.asarray(jdrl.drl_assign_traced(params,
                                                               *jargs)))
        host, _ = tdrl.DRLAssigner(tsp, tparams).assign(tpops[s],
                                                       sched[s].numpy())
        np.testing.assert_array_equal(got[s].numpy(), host)


@pytest.mark.parametrize("n_transfer,n_exchange,K", [
    (40, 80, 16), (5, 7, 4), (0, 9, 3), (16, 0, 16), (1, 1, 8)])
def test_round_plan_matches_reference(n_transfer, n_exchange, K):
    for a, b in zip(thfel._round_plan(n_transfer, n_exchange, K),
                    jhfel._round_plan(n_transfer, n_exchange, K)):
        np.testing.assert_array_equal(a, b)
        assert a.dtype == b.dtype


def _reference_draws(key, n_transfer, n_exchange, K):
    """The reference's per-round permutation prefixes for one lane."""
    kinds, _ = jhfel._round_plan(n_transfer, n_exchange, K)
    raw_t, raw_e = [], []
    for _ in kinds:
        key, k_t, k_e = jax.random.split(key, 3)
        raw_t.append(np.asarray(jax.random.permutation(k_t, H * M)[:K]))
        raw_e.append(np.asarray(jax.random.permutation(k_e, H * H)[:K]))
    return np.stack(raw_t), np.stack(raw_e)


def test_hfel_search_traced_matches_reference():
    seeds = (0, 1)
    sp, jpops, tsp, tpops = _pops(seeds)
    sched = _cohorts(2, len(seeds))
    opts = dict(n_transfer=12, n_exchange=20, n_candidates=4,
                alloc_steps=30)
    want, draws = [], []
    for s, jp in enumerate(jpops):
        c = sched[s]
        key = jax.random.PRNGKey(10 + s)
        a, J = jhfel.hfel_search_traced(
            sp, jp.u[c], jp.D[c], jp.p[c], jp.g[c], jp.B_m, jp.g_cloud, key,
            **opts)
        want.append((np.asarray(a), float(J)))
        draws.append(_reference_draws(key, 12, 20, 4))
    ix = torch.from_numpy(sched)

    def take(name):
        x = torch.stack([getattr(p, name) for p in tpops])
        return x[torch.arange(len(seeds))[:, None], ix]

    cohort = [take(k) for k in ("u", "D", "p", "g")]
    rest = [torch.stack([getattr(p, k) for p in tpops])
            for k in ("B_m", "g_cloud")]
    raw = tuple(torch.from_numpy(np.stack([d[i] for d in draws])).long()
                for i in (0, 1))
    got, J = thfel.hfel_search_traced(tsp, *cohort, *rest, draws=raw, **opts)
    for s, (a, j) in enumerate(want):
        np.testing.assert_array_equal(got[s].numpy(), a)
        np.testing.assert_allclose(float(J[s]), j, rtol=1e-4)
    # the port's own stream: a valid assignment that beats the start
    words = torch.tensor([[0, 0], [0, 1]])
    own, J_own = thfel.hfel_search_traced(tsp, *cohort, *rest, words,
                                          **opts)
    assert own.dtype == torch.int64 and int(own.min()) >= 0
    assert int(own.max()) < M
    start, J0 = thfel.hfel_search_traced(
        tsp, *cohort, *rest, words, **{**opts, "n_transfer": 0,
                                        "n_exchange": 0})
    assert torch.equal(start, cohort[3].argmax(-1))
    assert bool((J_own <= J0).all())
    with pytest.raises(ValueError, match="n_candidates"):
        thfel.hfel_search_traced(tsp, *cohort, *rest, words,
                                 n_candidates=H * M + 1)


# ------------------------------------------------------- TracedFedAvg

def test_traced_fedavg():
    ts = TracedFedAvg(N, 4)
    st = ts.init_state([3, 0, 7], "cpu")
    assert tuple(st.shape) == (3, 2) and st.dtype == torch.int64
    draws = []
    for _ in range(3):
        st, sched = ts.step(st)
        assert tuple(sched.shape) == (3, 4) and sched.dtype == torch.int64
        for row in sched.numpy():
            assert len(set(row.tolist())) == 4
            assert row.min() >= 0 and row.max() < N
        draws.append(sched)
    assert not torch.equal(draws[0], draws[1])
    # lane 0 (seed 3) draws the same cohorts alone
    st1 = ts.init_state(3, "cpu")
    for d in draws:
        st1, alone = ts.step(st1)
        assert torch.equal(alone[0], d[0])
    # uniform marginals: 3 000 lanes' first rounds
    _, big = ts.step(ts.init_state(np.arange(3000), "cpu"))
    share = np.bincount(big.numpy().ravel(), minlength=N) / 3000
    assert np.abs(share - 4 / N).max() <= 0.045
    for bad in (0, N + 1):
        with pytest.raises(ValueError, match="0 < H <= N"):
            TracedFedAvg(N, bad)


# --------------------------------------------------------- fused runs

@pytest.fixture(scope="module")
def runner():
    sp, worlds = _worlds(tcm, tdata)
    return tsw.SweepRunner(sp, worlds, device="cpu", **KW)


def _fedavg(runner):
    return [tsw.build_scheduler("fedavg", runner.feds[s], runner.sp, H,
                                device="cpu") for s in range(S)]


def _equal(a, b):
    """The results' numbers equal; how the run was dispatched and what
    its tracer recorded (``n_dispatches``, ``trace``) may differ."""
    how = {"n_dispatches", "trace"}
    assert a.keys() - how == b.keys() - how
    for k in a.keys() - how:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


@pytest.mark.parametrize("assign,traced", [
    ("geo", False), ("drl", False), ("hfel", False), ("mod", True)])
def test_fused_matches_oracle(runner, assign, traced):
    kw = {}
    if assign == "drl":
        kw["drl_params"] = _drl_params()
    if assign == "hfel":
        kw["hfel_opts"] = dict(n_transfer=8, n_exchange=8, n_candidates=4)
    outs, params = [], []
    for mode in (True, "oracle"):
        scheds = ([TracedFedAvg(N, H)] * S if traced else _fedavg(runner))
        outs.append(runner.run(scheds, R, assign=assign, fused=mode, **kw))
        params.append(runner.params_b)
    assert outs[0]["n_dispatches"] == 1 and outs[1]["n_dispatches"] == R
    _equal(*outs)
    for k in params[0]:
        assert torch.equal(params[0][k], params[1][k]), k
    assert np.isfinite(outs[0]["acc"]).all() and outs[0]["H"] == H
    if assign != "mod":
        assert (outs[0]["T_i"] > 0).all()


def _early_stop_target(accs):
    """A target between two accuracies of a no-stop probe (pre-stop
    trajectories do not depend on the target) that stops some lane
    before the last round, lanes at different rounds if one can, and
    lies farthest from every accuracy."""
    vals = np.unique(accs)
    best = None
    for t in (vals[:-1] + vals[1:]) / 2:
        reached = accs >= t
        iters = np.where(reached.any(axis=1), reached.argmax(axis=1) + 1, R)
        if iters.min() < R:
            score = (len(set(iters.tolist())) > 1,
                     float(np.abs(accs - t).min()))
            if best is None or score > best[0]:
                best = (score, float(t))
    assert best is not None, f"no early-stop target in {accs}"
    return best[1]


@pytest.mark.parametrize("early_stop", [False, True])
def test_fused_geo_matches_host_loop(runner, early_stop):
    """Host schedulers precomputed for the fused run: the host loop's
    cohorts, so the same records; with an early-stop target both stop
    the same lanes at the same rounds (the fused run's trailing all-done
    rounds trimmed)."""
    kw = {}
    if early_stop:
        kw["target_acc"] = _early_stop_target(
            runner.run(_fedavg(runner), R)["acc"])
    host = runner.run(_fedavg(runner), R, **kw)
    fused = runner.run(_fedavg(runner), R, fused=True, **kw)
    assert fused["n_dispatches"] == 1
    _equal(host, fused)
    if early_stop:
        assert host["iters"].min() < R


def test_fused_rejects_bad_configs(runner):
    scheds = _fedavg(runner)
    with pytest.raises(ValueError, match="fused must be"):
        runner.run(scheds, 1, fused="yes")
    with pytest.raises(ValueError, match="named assigner"):
        runner.run(scheds, 1, assign=lambda *a: None, fused=True)
    with pytest.raises(ValueError, match="unknown assign"):
        runner.run(scheds, 1, assign="nope", fused=True)
    with pytest.raises(ValueError, match="drl_params"):
        runner.run(scheds, 1, assign="drl", fused=True)
    with pytest.raises(ValueError, match="hfel_opts"):
        runner.run(scheds, 1, assign="geo", fused=True,
                   hfel_opts={"n_transfer": 4})
    with pytest.raises(ValueError, match="unknown hfel_opts"):
        runner.run(scheds, 1, assign="hfel", fused=True,
                   hfel_opts={"alloc_steps": 5})
    with pytest.raises(ValueError, match="cannot mix"):
        runner.run([scheds[0], TracedFedAvg(N, H)], 1, fused=True)
    with pytest.raises(ValueError, match="share one"):
        runner.run([TracedFedAvg(N, H), TracedFedAvg(N, H - 1)], 1,
                   fused=True)
    # the reference's mesh validation: a mesh that is not ("lane",) is
    # refused, and lane_chunk must divide the per-rank lane block (3
    # lanes over 2 ranks: blocks of 2), both before any process group is
    # needed
    worlds = list(zip(runner.pops, runner.feds))
    with pytest.raises(ValueError, match="lane"):
        tsw.SweepRunner(runner.sp, worlds, shard=True, device="cpu",
                        mesh=AbstractMesh({"data": 1, "model": 1}))
    with pytest.raises(ValueError, match="lane_chunk"):
        tsw.SweepRunner(runner.sp, worlds + worlds[:1], shard=True,
                        device="cpu", mesh=AbstractMesh({"lane": 2}),
                        lane_chunk=3)
