"""The multi-lane sweep (``repro_torch.core.sweep``) against
``repro.core.sweep``: one lane-batched ``sweep_round``, and
``SweepRunner.run``'s host loop with every named assigner and early
stop.

World: S=2 lanes of ``SystemParams(n_devices=12, n_edges=3, L=2, Q=2)``
(populations and non-IID partitions of seeds 0 and 1, 10-16 samples a
device, ``fmnist_syn`` 240/60), H=6, 30-step allocations (on the CPU an
allocator row depends on its batch after ~200 steps, ROADMAP Queue 3).
The port starts from the reference's initial weights; its host
schedulers, rngs and geo/hfel/drl host assigners give the reference's
cohorts and assignments exactly.

Tolerances:

- ``sweep_round`` (each of ``train_only`` x ``agg_kernel``; the
  reference's K1 in Pallas interpret mode): params atol 1e-6 / rtol
  1e-5, T_i/E_i rtol 1e-5 (measured: params 6e-8, costs 2.4e-7); a done
  lane's params bitwise unchanged and its costs exactly 0.
- ``lane_chunk`` and each lane against the single-world
  ``round_step_core``: params atol 1e-6, costs rtol 1e-6.
- ``SweepRunner.run``: ``iters``, ``H``, ``msg_bits_per_round`` exact,
  T_i/E_i/obj rtol 1e-5, ``acc`` within one test sample (1/60: a 1e-7
  training difference can flip one argmax). ``mod`` runs as the
  reference's Fig. 3/4 driver runs it (``train_only``, ``sizes="fed"``):
  its round-robin cohorts put devices on far edges, where the 30-step
  allocation is ill conditioned in both packages (1.06e-5 apart on
  seed 0, ROADMAP Queue 3).

The compressed sweeps are in ``tests/test_torch_sweep_codec.py``;
``pad_device_data``, ``build_scheduler`` and ``sweep_ratios`` in
``tests/test_torch_sweep_sched.py``.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core.cost_model as jcm
import repro.data as jdata
import repro_torch.core.cost_model as tcm
import repro_torch.data as tdata
from repro.core import compression as jcomp
from repro.core import sweep as jsw
from repro_torch.convert import params_to_numpy
from repro_torch.core import compression as tcomp
from repro_torch.core import sweep as tsw
from repro_torch.core.framework import round_step_core
from test_torch_compression import _reference_noise
from test_torch_framework import one_torch_thread  # noqa: F401 (autouse)

N, M, H, S = 12, 3, 6, 2
R = 2
KW = dict(lr=0.02, alloc_steps=30)


def _world(cm, data, seed):
    sp = cm.SystemParams(n_devices=N, n_edges=M, L=2, Q=2)
    pop = (cm.sample_population(sp, seed=seed) if cm is jcm
           else cm.sample_population(sp, seed=seed, device="cpu"))
    X, y, Xt, yt = data.make_dataset("fmnist_syn", n_train=240, n_test=60,
                                     seed=0)
    fed = data.partition_noniid(X, y, Xt, yt, n_devices=N,
                                size_range=(10, 16), seed=seed)
    return sp, pop, fed


def _worlds(cm, data):
    ws = [_world(cm, data, s) for s in range(S)]
    return ws[0][0], [(w[1], w[2]) for w in ws]


def _runners(compression=None, **kw):
    """The reference's runner and the port's from its initial weights."""
    jsp, jworlds = _worlds(jcm, jdata)
    tsp, tworlds = _worlds(tcm, tdata)
    jc = tc = None
    if compression is not None:
        jc = jcomp.CompressionConfig(codec=compression)
        tc = tcomp.CompressionConfig(codec=compression)
    jr = jsw.SweepRunner(jsp, jworlds, compression=jc, **KW, **kw)
    init = [{k: np.asarray(v[s]) for k, v in jr.params0.items()}
            for s in range(S)]
    noise = None
    if compression == "int8":
        names = sorted(init[0])
        noise = (lambda lane, r: _reference_noise(jc, lane, 2, names)(r))
    tr = tsw.SweepRunner(tsp, tworlds, compression=tc, init_params=init,
                         codec_noise=noise, device="cpu", **KW, **kw)
    return jr, tr


def _scheds(pkg, runner, name="fedavg"):
    return [pkg.build_scheduler(name, runner.feds[s], runner.sp, H, seed=s,
                                **({} if pkg is jsw else {"device": "cpu"}))
            for s in range(S)]


# ------------------------------------------------------- sweep_round

def _round_inputs(jr, tr, seed=1):
    """One round's (S, H) cohorts and geo assignments, numpy. Cohort
    seeds 1, 3 and 5 are free of Algorithm-1 kinks; on seeds 0, 2 and 4
    lane 1's params land up to 7.5e-6 apart on 12 of 21 000 conv2
    elements (BLAS vs XLA order, 3e-8 elsewhere)."""
    rng = np.random.default_rng(seed)
    sched = np.stack([rng.permutation(N)[:H] for _ in range(S)])
    assign = np.stack([jsw._geo_assign(tr.pops[s], sched[s], None)
                       for s in range(S)])
    return sched, assign


def _port_round(tr, sched, assign, **kw):
    sp = dataclasses.replace(tr.sp, model_bits=float(tr.uplink_bits))
    return tsw.sweep_round(
        tr.apply_fn, sp, tr.params0, tr.u_b, tr.D_b, tr.p_b, tr.g_b,
        tr.g_cloud_b, tr.B_m_b, tr.X_b, tr.y_b, tr.mask_b, tr.D_b,
        torch.from_numpy(sched), torch.from_numpy(assign), tr.lr, M=M,
        L=sp.L, Q=sp.Q, alloc_steps=tr.alloc_steps, **kw)


def _ref_round(jr, sched, assign, **kw):
    sp = dataclasses.replace(jr.sp, model_bits=float(jr.uplink_bits))
    return jsw.sweep_round(
        jr.apply_fn, sp, jr.params0, jr.u_b, jr.D_b, jr.p_b, jr.g_b,
        jr.g_cloud_b, jr.B_m_b, jr.X_b, jr.y_b, jr.mask_b, jr.D_b,
        jnp.asarray(sched), jnp.asarray(assign), jr.lr, M=M, L=sp.L,
        Q=sp.Q, alloc_steps=jr.alloc_steps, **kw)


@pytest.fixture(scope="module")
def runners():
    return _runners()


@pytest.mark.parametrize("agg_kernel", [False, True])
@pytest.mark.parametrize("train_only", [False, True])
def test_sweep_round_matches_reference(runners, train_only, agg_kernel):
    jr, tr = runners
    sched, assign = _round_inputs(jr, tr)
    jp, (jT, jE) = _ref_round(jr, sched, assign, train_only=train_only,
                              agg_kernel=agg_kernel)
    tp, (tT, tE) = _port_round(tr, sched, assign, train_only=train_only,
                               agg_kernel=agg_kernel)
    got = params_to_numpy(tp)
    for k, v in jp.items():
        np.testing.assert_allclose(got[k], np.asarray(v), rtol=1e-5,
                                   atol=1e-6, err_msg=k)
    for a, b in ((tT, jT), (tE, jE)):
        assert tuple(a.shape) == (S,)
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5)
    if train_only:
        assert not tT.any() and not tE.any()


def test_done_lane_is_frozen(runners):
    """A done lane passes its params through bitwise and costs 0; the
    other lane is the round without the mask."""
    _, tr = runners
    sched, assign = _round_inputs(None, tr)
    free, (T0, E0) = _port_round(tr, sched, assign)
    done = torch.tensor([False, True])
    held, (T1, E1) = _port_round(tr, sched, assign, done_b=done)
    for k, v in held.items():
        assert torch.equal(v[1], tr.params0[k][1]), k
        assert torch.equal(v[0], free[k][0]), k
    assert T1[1] == 0 and E1[1] == 0
    assert T1[0] == T0[0] and E1[0] == E0[0]


def test_lanes_match_chunks_and_single_world(runners):
    """``lane_chunk=1`` equals the whole-axis batch, and each lane equals
    the single-world ``round_step_core`` on its own cohort."""
    _, tr = runners
    sched, assign = _round_inputs(None, tr, seed=3)
    whole, (T, E) = _port_round(tr, sched, assign)
    chunked, (Tc, Ec) = _port_round(tr, sched, assign, lane_chunk=1)
    sp = dataclasses.replace(tr.sp, model_bits=float(tr.uplink_bits))
    for s in range(S):
        sc = torch.from_numpy(sched[s])
        one, aux = round_step_core(
            tr.apply_fn, sp, {k: v[s] for k, v in tr.params0.items()},
            tr.u_b[s][sc], tr.D_b[s][sc], tr.p_b[s][sc], tr.g_b[s][sc],
            tr.g_cloud_b[s], tr.B_m_b[s], tr.X_b[s][sc], tr.y_b[s][sc],
            tr.mask_b[s][sc], tr.D_b[s][sc], torch.from_numpy(assign[s]),
            tr.lr, M=M, L=sp.L, Q=sp.Q, alloc_steps=tr.alloc_steps)
        for k in whole:
            np.testing.assert_allclose(chunked[k][s].numpy(),
                                       whole[k][s].numpy(), atol=1e-6)
            np.testing.assert_allclose(one[k].numpy(), whole[k][s].numpy(),
                                       atol=1e-6)
        for a, b in ((aux[0], T[s]), (aux[1], E[s]), (Tc[s], T[s]),
                     (Ec[s], E[s])):
            np.testing.assert_allclose(float(a), float(b), rtol=1e-6)
    with pytest.raises(ValueError, match="lane_chunk"):
        _port_round(tr, sched, assign, lane_chunk=3)


# ------------------------------------------------------ SweepRunner.run

def _assert_run_matches(t, j, n_test=60):
    assert set(t) == set(j)
    np.testing.assert_array_equal(t["iters"], j["iters"])
    assert t["H"] == j["H"] and t["codec"] == j["codec"]
    for k in ("msg_bits_per_round", "uplink_bits_per_msg",
              "uplink_bytes_per_round"):
        assert t[k] == j[k], k
    assert t["acc"].shape == j["acc"].shape
    assert np.abs(t["acc"] - j["acc"]).max() <= 1.0 / n_test + 1e-6
    for k in ("T_i", "E_i", "obj"):
        np.testing.assert_allclose(t[k], np.asarray(j[k]), rtol=1e-5,
                                   err_msg=k)


def _drl_params():
    from repro.drl.d3qn import d3qn_init
    return jax.tree.map(np.asarray,
                        d3qn_init(jax.random.PRNGKey(0), M + 3, M, hidden=16))


@pytest.mark.parametrize("assign,kw", [
    ("geo", {}),
    ("hfel", {}),
    ("drl", {"drl": True}),
    ("mod", {"train_only": True, "sizes": "fed"}),
    ("geo", {"target": True, "rounds": 3}),
], ids=["geo", "hfel", "drl", "mod-train-only-fed", "geo-early-stop"])
def test_run_matches_reference(runners, assign, kw):
    jr, tr = runners
    kw = dict(kw)
    rounds = kw.pop("rounds", R)
    if kw.pop("drl", False):
        kw["drl_params"] = _drl_params()
    target = kw.pop("target", None)
    if target:
        # a target between lane 0's and lane 1's round-1 accuracy, half
        # a test sample from both: lane 0 stops there, lane 1 later
        probe = jr.run(_scheds(jsw, jr), 1, assign=assign)["acc"][:, 0]
        kw["target_acc"] = float(probe.min()) + 0.5 / 60
    j = jr.run(_scheds(jsw, jr), rounds, assign=assign, **kw)
    t = tr.run(_scheds(tsw, tr), rounds, assign=assign, **kw)
    _assert_run_matches(t, j)
    if target:
        assert 1 <= t["iters"].min() < rounds
        done_at = int(t["iters"].min())
        lane = int(t["iters"].argmin())
        assert not t["T_i"][lane, done_at:].any()


def test_run_validates():
    _, tr = _runners()
    with pytest.raises(ValueError, match="sizes"):
        tr.run(_scheds(tsw, tr), 1, sizes="both")
    with pytest.raises(ValueError, match="unknown assign"):
        tr.run(_scheds(tsw, tr), 1, assign="nearest")
    with pytest.raises(ValueError, match="drl_params"):
        tr.run(_scheds(tsw, tr), 1, assign="drl")
    # shard=True needs an initialised process group (here there is none)
    with pytest.raises(RuntimeError, match="process group"):
        tsw.SweepRunner(tr.sp, list(zip(tr.pops, tr.feds)), shard=True,
                        device="cpu")
    with pytest.raises(ValueError, match="lane_chunk"):
        tsw.SweepRunner(tr.sp, list(zip(tr.pops, tr.feds)), lane_chunk=3,
                        device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            tsw.SweepRunner(tr.sp, list(zip(tr.pops, tr.feds)))


