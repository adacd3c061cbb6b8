"""The event-driven async engine: ``repro_torch.core.async_engine`` against
``repro.core.async_engine`` on ``tests/test_async_engine.py``'s world
(N=10 devices, M=3 edges, H=6, L=2, Q=3, 60-step allocations), one case
per trace of that file.

Both engines get the same trace (a reference trace is host numpy and
passes unchanged), the same scheduler and assigner (numpy on both
sides: cohorts, assignments and the rng's jitter draws are equal) and
the reference's initial weights. The event sequence is then the
reference's: no two events of these worlds lie within 2e-5 (relative)
of each other (measured: 2.1e-5 at the closest, on the churny trace),
so the < 1e-6 relative difference of the f32 task prices cannot reorder
them. Records are held so:

- the accounting exactly: ``n_updates``, ``n_stale``,
  ``max_staleness``, ``n_aborted``, ``forced_flushes``, ``msg_bits``,
  ``uplink_bytes``, ``H``, ``round``, ``codec``;
- ``t``, ``T_i``, ``E_i``, ``obj_i``, ``wasted_j`` to rtol 1e-5 (the
  allocator's 60 Adam steps in XLA and in torch: measured at most
  6.6e-7 relative);
- ``acc`` within one test sample; b, f and the task prices tc, ec to
  rtol 1e-5. (On that file's staleness-decay world, seed 5, one
  device's f lies along a flat direction of its edge's objective after
  60 steps and ends 1.7e-4 apart, its tc 1.4e-4, while the records
  agree to 1e-5; the decay case here runs on the straggler world,
  seed 1, instead.)
- params to atol 1e-6 on these cohorts, which are free of Algorithm-1
  kinks (measured at most 1.2e-7; 6e-8 after the always-on case's 2
  rounds). The jitter case runs with ``seed=2``: with seeds 1 and 6 a
  ReLU kink takes the packages 7.4e-6 and 2.0e-6 apart.

Compressed rounds inject the reference's int8 draws (``round_key``
split into a dispatch and a cloud key, ``fold_in`` per dispatch,
``split`` per leaf) through ``codec_noise``, and hold params and both
error-feedback residuals by the share of elements that differ, with the
limits of ``tests/test_torch_sweep_codec.py``.
"""
import json

import jax
import numpy as np
import pytest
import torch

import repro_torch.data as tdata
from repro.core import compression as jcomp
from repro.core import cost_model as jcm
from repro.core.async_engine import AsyncConfig as JConfig
from repro.core.async_engine import AsyncHFLEngine as JEngine
from repro.core.traffic import TrafficGenerator as JTraffic
from repro.core.traffic import TrafficParams as JTrafficParams
from repro_torch.convert import params_to_numpy
from repro_torch.core import async_engine as tae
from repro_torch.core import compression as tcomp
from repro_torch.core import cost_model as tcm
from repro_torch.core.framework import round_step_core
from repro_torch.core.traffic import TrafficGenerator as TTraffic
from repro_torch.core.traffic import TrafficParams as TTrafficParams
from test_async_engine import (ALLOC_STEPS, H, N_DEV, _FixedSched,
                               _ModAssigner, _straggler_trace)
from test_async_engine import _world as _jworld
from test_torch_async_trace import assert_traces_equal, port_trace
from test_torch_compression import _assert_mostly_close, _quantum
from test_torch_framework import one_torch_thread  # noqa: F401 (autouse)

EXACT = ("round", "H", "n_updates", "n_stale", "max_staleness",
         "n_aborted", "forced_flushes", "msg_bits", "uplink_bytes", "codec")
CLOSE = ("t", "T_i", "E_i", "obj_i", "wasted_j")
PARAM_ATOL = 1e-6
CODEC_PARAM_ATOL, CODEC_PARAM_SHARE = 1e-5, 1e-3
RESID_ATOL, RESID_RTOL, RESID_SHARE = 1e-7, 1e-2, 5e-3


def _tworld(seed=0):
    """``test_async_engine._world`` built by the port."""
    sp = tcm.SystemParams(n_devices=N_DEV, n_edges=3, d_range=(30, 60),
                          L=2, Q=3)
    pop = tcm.sample_population(sp, seed=seed, device="cpu")
    X, y, Xt, yt = tdata.make_dataset("fmnist_syn", n_train=300,
                                      n_test=120, seed=seed)
    fed = tdata.partition_noniid(X, y, Xt, yt, n_devices=N_DEV,
                                 size_range=(15, 25), seed=seed)
    return sp, pop, fed


def _reference_noise(jcfg, seed, names):
    """The reference's int8 draws as the port's ``codec_noise``: round r's
    ``round_key`` splits into (dispatch, cloud) keys; dispatch n (hop
    1 + n) folds n into the first, the cloud hop takes the second, and
    each splits into one key a leaf (sorted names)."""
    def factory(r):
        k_disp, k_cloud = jax.random.split(jcomp.round_key(jcfg, seed, r))

        def draw(hop, name, shape):
            key = (k_cloud if hop == tae.CLOUD_HOP
                   else jax.random.fold_in(k_disp, hop - 1))
            ks = jax.random.split(key, len(names))
            return torch.from_numpy(np.array(
                jax.random.uniform(ks[names.index(name)], shape)))
        return draw
    return factory


def _engines(world_seed, trace=None, fixed=False, codec="none", **kw):
    """The reference's engine and the port's on the same world, trace,
    scheduler/assigner and initial weights."""
    jc = jcomp.CompressionConfig(codec=codec)
    tc = tcomp.CompressionConfig(codec=codec)
    kw = dict(H=H, alloc_steps=ALLOC_STEPS, **kw)
    pick = (lambda: dict(scheduler=_FixedSched(np.arange(H)),
                         assigner=_ModAssigner())) if fixed else dict
    je = JEngine(*_jworld(world_seed), JConfig(compression=jc, **kw),
                 trace=trace, **pick())
    init = {k: np.asarray(v) for k, v in je.model_params.items()}
    noise = (_reference_noise(jc, kw.get("seed", 0), sorted(init))
             if codec == "int8" else None)
    te = tae.AsyncHFLEngine(*_tworld(world_seed),
                            tae.AsyncConfig(compression=tc, device="cpu",
                                            **kw),
                            trace=trace, init_params=init,
                            codec_noise=noise, **pick())
    return je, te


def _assert_record(rt, rj, n_test=120):
    assert set(rt) == set(rj) | {"n_dispatches"}
    json.dumps(rt)                      # Python numbers only
    for k in EXACT:
        assert rt[k] == rj[k], (k, rt[k], rj[k])
    for k in CLOSE:
        np.testing.assert_allclose(rt[k], rj[k], rtol=1e-5, err_msg=k)
    if rj["acc"] is None:
        assert rt["acc"] is None
    else:
        assert abs(rt["acc"] - rj["acc"]) <= 1.0 / n_test + 1e-12
    assert rt["n_dispatches"] >= 1 or rt["n_updates"] == 0


def _assert_round(te, je, rt, rj, params=True):
    _assert_record(rt, rj)
    np.testing.assert_array_equal(te.last_sched, je.last_sched)
    np.testing.assert_array_equal(te.last_assign, je.last_assign)
    for a, b in zip(te.last_alloc, je.last_alloc):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5)
    assert te.t == pytest.approx(je.t, rel=1e-5)
    if params:
        _assert_params(te, je, PARAM_ATOL)


def _assert_params(te, je, atol):
    got = params_to_numpy(te.model_params)
    for k, v in je.model_params.items():
        np.testing.assert_allclose(got[k], np.asarray(v), rtol=0, atol=atol,
                                   err_msg=k)


def _step(te, je, **kw):
    return te.step_round(**kw), je.step_round(**kw)


# ----------------------------------------------------------- parity

def test_always_on_two_rounds_match_reference():
    """The degenerate trace (the sync-parity setting), fedavg and geo
    assignment, 2 rounds: 1 + M(Q-1) = 7 dispatches and Q·H = 18
    updates a round."""
    je, te = _engines(0, seed=3)
    for _ in range(2):
        rt, rj = _step(te, je)
        _assert_round(te, je, rt, rj)
        assert rt["n_updates"] == 18 and rt["n_dispatches"] == 7
        assert rt["n_stale"] == rt["n_aborted"] == rt["forced_flushes"] == 0
    st, sj = te.summary(), je.summary()
    assert st["rounds"] == sj["rounds"] == 2
    for k in ("n_updates", "n_stale", "n_aborted"):
        assert st[k] == sj[k]
    for k in ("T", "E", "objective", "t_virtual"):
        np.testing.assert_allclose(st[k], sj[k], rtol=1e-5)


@pytest.mark.parametrize("buffer_size", [1, 2, None])
def test_straggler_trace_matches_reference(buffer_size):
    """Slots 3-5 deliver at 1.5x their edge's fast member (each edge
    holds two slots): a 1-slot buffer flushes without them (stale
    updates, a shorter round); a 2-slot buffer waits for both, as
    wait-for-all does."""
    trace = _straggler_trace(*_jworld(1), seed=5)
    je, te = _engines(1, trace=trace, fixed=True, seed=5,
                      buffer_size=buffer_size, staleness_exp=0.5)
    rt, rj = _step(te, je, collect_eval=False)
    _assert_round(te, je, rt, rj)
    if buffer_size == 1:
        assert rt["n_stale"] > 0 and rt["max_staleness"] >= 1
    else:
        assert rt["n_stale"] == 0 and rt["n_updates"] == 18


def test_all_offline_keeps_model():
    trace = jcm.AvailabilityTrace(init_up=np.zeros(N_DEV, bool),
                                  toggles=np.full((N_DEV, 1), np.inf),
                                  latency_scale=np.ones(N_DEV))
    je, te = _engines(2, trace=trace)
    before = {k: v.clone() for k, v in te.model_params.items()}
    rt, rj = _step(te, je, collect_eval=False)
    _assert_round(te, je, rt, rj)
    assert rt["n_updates"] == rt["n_dispatches"] == 0
    n_edges = len(np.unique(te.last_assign))     # empty edges are done
    assert rt["forced_flushes"] == te.sp.Q * n_edges > 0
    for k, v in before.items():
        np.testing.assert_allclose(te.model_params[k].numpy(), v.numpy(),
                                   rtol=1e-6, atol=1e-7)


def test_late_arrivals_deliver_seventeen():
    """The whole fleet offline at t=0, Exp(1 s) arrivals that then stay.
    The round delivers Q·H - 1 = 17 updates, not 18, in both packages:
    ``should_flush`` flushes an edge as soon as it has a delivery and
    nothing in flight, without waiting for members still offline. Edge
    1 holds devices 1 and 4; device 1 arrives at 0.071 s and delivers at
    1.129 s, device 4 arrives only at 1.981 s, so edge 1's first flush
    holds one update. No update is stale or aborted and no flush is
    forced."""
    sp = _jworld(3)[0]
    ap = jcm.AvailabilityParams(p_offline0=1.0, mean_down_s=1.0,
                                mean_up_s=float("inf"))
    trace = jcm.sample_availability(ap, N_DEV, seed=11)
    assert_traces_equal(port_trace(ap, N_DEV, 11), trace)
    np.testing.assert_allclose(trace.toggles[[1, 4], 0], [0.071, 1.981],
                               atol=5e-4)
    je, te = _engines(3, trace=trace, fixed=True, seed=4)
    rt, rj = _step(te, je, collect_eval=False)
    _assert_round(te, je, rt, rj)
    assert rt["n_updates"] == sp.Q * H - 1 == 17
    assert rt["n_stale"] == rt["n_aborted"] == rt["forced_flushes"] == 0
    assert rt["T_i"] == pytest.approx(46.46, abs=0.01)


def _degenerate_T(world_seed, seed):
    probe = JEngine(*_jworld(world_seed),
                    JConfig(H=H, alloc_steps=ALLOC_STEPS, seed=seed))
    return probe.step_round(collect_eval=False)["T_i"]


def test_churny_trace_matches_reference():
    """20 % offline at t=0, sessions of T/5 and gaps of T/10 (T the
    degenerate round), 1-slot buffers, 2 rounds with an eval on the
    second: dropouts abort tasks and waste energy."""
    T_deg = _degenerate_T(4, 6)
    ap = jcm.AvailabilityParams(p_offline0=0.2, mean_up_s=T_deg / 5,
                                mean_down_s=T_deg / 10)
    trace = jcm.sample_availability(ap, N_DEV, seed=13, max_toggles=256)
    assert_traces_equal(port_trace(ap, N_DEV, 13, 256), trace)
    je, te = _engines(4, trace=trace, seed=6, buffer_size=1)
    recs = [_step(te, je, collect_eval=r == 2) for r in (1, 2)]
    for rt, rj in recs:
        _assert_round(te, je, rt, rj, params=False)
    _assert_params(te, je, PARAM_ATOL)
    assert sum(rt["n_aborted"] for rt, _ in recs) > 0
    assert sum(rt["wasted_j"] for rt, _ in recs) > 0
    assert recs[1][0]["acc"] is not None


def test_staleness_decay_matches_reference():
    """A stale delivery moves the edge model less as ``a`` grows; each
    exponent's round matches the reference's."""
    trace = _straggler_trace(*_jworld(1), seed=5)
    out = {}
    for a in (0.0, 4.0):
        je, te = _engines(1, trace=trace, fixed=True, seed=5, buffer_size=1,
                          staleness_exp=a)
        rt, rj = _step(te, je, collect_eval=False)
        _assert_round(te, je, rt, rj)
        assert rt["n_stale"] > 0
        out[a] = params_to_numpy(te.model_params)
    assert sum(float(np.abs(out[0.0][k] - out[4.0][k]).sum())
               for k in out[0.0]) > 1e-3


def test_traffic_driven_round_matches_reference():
    T_deg = _degenerate_T(6, 0)
    kw = dict(join_rate=2.0 / T_deg, mean_session_s=T_deg, p_online0=0.5)
    trace = JTraffic(JTrafficParams(**kw), N_DEV, seed=3).make_trace(
        5 * T_deg)
    assert_traces_equal(
        TTraffic(TTrafficParams(**kw), N_DEV, seed=3).make_trace(5 * T_deg),
        trace)
    je, te = _engines(6, trace=trace, buffer_size=2)
    rt, rj = _step(te, je, collect_eval=False)
    _assert_round(te, je, rt, rj)
    assert rt["round"] == 1 and rt["T_i"] > 0.0


def test_jitter_matches_reference():
    """Log-normal task jitter: one host-rng draw per dispatched task, in
    the reference's order."""
    trace = jcm.sample_availability(
        jcm.AvailabilityParams(straggler_frac=0.3, straggler_scale=3.0),
        N_DEV, seed=2)
    je, te = _engines(0, trace=trace, seed=2, jitter_sigma=0.5,
                      buffer_size=2)
    for r in (1, 2):
        rt, rj = _step(te, je, collect_eval=r == 2)
        _assert_round(te, je, rt, rj)
    assert te.rng.bit_generator.state == je.rng.bit_generator.state


@pytest.mark.parametrize("codec", ["int8", "bf16_delta", "topk"])
def test_compressed_round_matches_reference(monkeypatch, codec):
    """One compressed round on the straggler trace with 2-slot buffers
    (stale deliveries): records as above; params and both residuals by
    the share of elements that differ (at most 1e-3 of the params by
    more than 1e-5; at most 5e-3 of the residuals by more than 1e-7 +
    1e-2·|reference|), none by two codec quanta at the largest message
    the port sent. The device residuals are live on the cohort only."""
    largest = [0.0]
    real = tcomp.encode_leaf

    def spy(cfg, delta, resid, u=None):
        out = real(cfg, delta, resid, u)
        largest[0] = max(largest[0], _quantum(cfg, delta + resid, out[1]))
        return out
    monkeypatch.setattr(tcomp, "encode_leaf", spy)
    trace = _straggler_trace(*_jworld(1), seed=5)
    je, te = _engines(1, trace=trace, seed=5, buffer_size=2, codec=codec)
    assert te.uplink_bits == je.uplink_bits < te.sp.model_bits / 1.9
    rt, rj = _step(te, je)
    _assert_round(te, je, rt, rj, params=False)
    cap = 2.0 * largest[0]
    assert 0.0 < cap < 0.05
    for got, want, atol, rtol, share, what in (
            (te.model_params, je.model_params, CODEC_PARAM_ATOL, 0.0,
             CODEC_PARAM_SHARE, "params"),
            (te.dev_resid, je.dev_resid, RESID_ATOL, RESID_RTOL,
             RESID_SHARE, "device residuals"),
            (te.edge_resid, je.edge_resid, RESID_ATOL, RESID_RTOL,
             RESID_SHARE, "edge residuals")):
        got = params_to_numpy(got)
        want = {k: np.asarray(v) for k, v in want.items()}
        for k, v in want.items():
            assert got[k].shape == v.shape, k
        _assert_mostly_close(got, want, atol, rtol, share, cap, what)
    rows = np.stack([np.abs(v.numpy()).reshape(N_DEV, -1).max(1)
                     for v in te.dev_resid.values()]).max(0)
    cohort = te.last_sched
    assert (rows[cohort] > 0).all()
    assert (np.delete(rows, cohort) == 0).all()


def test_codec_none_is_the_uncompressed_path(monkeypatch):
    """``codec="none"``: no residuals, no encode call, the same round as
    the default config bit for bit."""
    def boom(*a, **kw):
        raise AssertionError("encode_decode called with codec none")
    _, te = _engines(0, seed=3)
    monkeypatch.setattr(tcomp, "encode_decode", boom)
    _, none = _engines(0, seed=3, codec="none")
    assert none.dev_resid is None and none.edge_resid is None
    a = te.step_round(collect_eval=False)
    b = none.step_round(collect_eval=False)
    assert a == b
    for k in te.model_params:
        assert torch.equal(te.model_params[k], none.model_params[k])


# ------------------------------------------------- against the sync round

def test_always_on_round_matches_round_step_core():
    """The port's async round on the degenerate trace against the port's
    synchronous ``round_step_core`` on the same cohort and assignment:
    b and f bit for bit, T_i/E_i to rtol 1e-5, the update count Q·H.
    The params could differ by the order of the sums (a flush computes
    ``wn @ flat + wa * edge`` over the cohort, the sync round a masked
    product over the edges; the reference's two rounds end 6.3e-7
    apart): measured 0 here after 2 rounds on the CPU, T_i/E_i 4.3e-8
    and 3.5e-8 relative; held to 1e-6."""
    _, te = _engines(0, seed=3)
    pop = te.pop
    params = {k: v.clone() for k, v in te.model_params.items()}
    for _ in range(2):
        rec = te.step_round(collect_eval=False)
        s = torch.from_numpy(te.last_sched.astype(np.int64))
        a = torch.from_numpy(te.last_assign.astype(np.int64))
        params, (T, E, _, _, b, f) = round_step_core(
            te.apply_fn, te.sp, params, pop.u[s], pop.D[s], pop.p[s],
            pop.g[s], pop.g_cloud, pop.B_m, te.X[s], te.y[s], te.mask[s],
            pop.D[s], a, te.cfg.lr, M=pop.n_edges, L=te.sp.L, Q=te.sp.Q,
            alloc_steps=te.cfg.alloc_steps)
        assert torch.equal(te.last_alloc[0], b)
        assert torch.equal(te.last_alloc[1], f)
        assert rec["T_i"] == pytest.approx(float(T), rel=1e-5)
        assert rec["E_i"] == pytest.approx(float(E), rel=1e-5)
        assert rec["n_updates"] == te.sp.Q * H
        gap = max(float((te.model_params[k] - params[k]).abs().max())
                  for k in params)
        assert gap <= 1e-6, gap


def test_config_needs_cpu_asked_for():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the cuda default is valid here")
    with pytest.raises(RuntimeError, match="CUDA"):
        tae.AsyncConfig()
    assert tae.AsyncConfig(device="cpu").device == "cpu"


def test_trace_size_must_match():
    with pytest.raises(ValueError, match="mismatch"):
        tae.AsyncHFLEngine(*_tworld(0), tae.AsyncConfig(H=H, device="cpu"),
                           trace=tcm.AvailabilityTrace.always_on(N_DEV + 1))


def test_flush_writes_one_edge_row():
    """``_flush_edge`` moves edge m's row only, by the staleness-decayed
    weights plus the anchor: two members of sizes 30 and 10, the first
    delivered at staleness 3 with a = 0.5 (weight 30/2 = 15), the second
    absent (anchor 10)."""
    edge = {"w": torch.arange(6.0).reshape(3, 2)}
    cohort = {"w": torch.tensor([[10.0, 20.0], [-5.0, -5.0]])}
    flush_in = torch.tensor([[1.0, 0.0], [1.0, 1.0], [3.0, 0.0]])
    tae._flush_edge(edge, cohort, 1, flush_in, torch.tensor([30.0, 10.0]),
                    torch.tensor(0.5))
    want = (15.0 * torch.tensor([10.0, 20.0])
            + 10.0 * torch.tensor([2.0, 3.0])) / 25.0
    torch.testing.assert_close(edge["w"][1], want)
    torch.testing.assert_close(edge["w"][[0, 2]],
                               torch.tensor([[0.0, 1.0], [4.0, 5.0]]))
