"""Availability traces and fleet traffic: ``repro_torch.core.cost_model``'s
``AvailabilityTrace`` and samplers, ``repro_torch.core.traffic`` and
``repro_torch.launch.serve.build_trace`` against ``repro``.

Everything here is held bit for bit. The samplers draw on a
``torch.Generator``, which cannot replay ``jax.random``, so the
reference's uniforms, exponentials and Bernoulli outcomes are injected;
the port then computes in f32 in the reference's order (its f32 cumsum
included) and must give the reference's trace exactly. The traffic
thinning loop is numpy on both sides, so ``make_trace`` and ``rate`` are
equal from the seed alone; only the straggler draw is injected.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.core import cost_model as jcm
from repro.core import traffic as jtr
from repro.launch import serve as jserve
from repro_torch.core import cost_model as tcm
from repro_torch.core import traffic as ttr
from repro_torch.launch import serve as tserve
from test_torch_framework import one_torch_thread  # noqa: F401 (autouse)

STATIONARY = dict(p_offline0=0.1, mean_up_s=900.0, mean_down_s=120.0,
                  straggler_frac=0.2, straggler_scale=4.0)
# (params, n devices, seed, max_toggles): the defaults (always on), the
# serve CLI's stationary preset, late arrivals and a churny fleet whose
# 256 flips exercise the reference's blocked f32 cumsum
SAMPLER_CASES = [
    (dict(), 8, 1, 64),
    (STATIONARY, 40, 0, 64),
    (dict(p_offline0=1.0, mean_down_s=1.0, mean_up_s=float("inf")), 10,
     11, 64),
    (dict(p_offline0=0.2, mean_up_s=9.3, mean_down_s=4.6,
          straggler_frac=0.5, straggler_scale=7.0), 10, 13, 256),
    (dict(p_offline0=0.3, mean_up_s=50.0, mean_down_s=10.0), 64, 7, 16),
]
TRAFFIC_CASES = {
    "stationary": dict(join_rate=0.5, mean_session_s=20.0, p_online0=0.3),
    "diurnal": dict(join_rate=40 / 600.0, mean_session_s=600.0,
                    diurnal_amp=0.8, diurnal_period_s=3600.0,
                    p_online0=0.5),
    "bursty": dict(join_rate=40 / 600.0, mean_session_s=600.0,
                   diurnal_amp=0.8, diurnal_period_s=3600.0, p_online0=0.5,
                   burst_mult=5.0, burst_every_s=3600.0, burst_len_s=300.0),
}


def ref_draws(ap, n, seed, max_toggles=64):
    """The ``jax.random`` draws of ``repro``'s ``sample_availability(ap,
    n, seed, max_toggles)``, as the port's injection arguments."""
    k_t, k_s = jax.random.split(jax.random.PRNGKey(seed))
    k_init, k_dur = jax.random.split(k_t)
    return dict(
        uniforms=np.asarray(jax.random.uniform(k_init, (n,))),
        exponentials=np.asarray(jax.random.exponential(
            k_dur, (n, max_toggles))),
        slow=np.asarray(jax.random.bernoulli(k_s, ap.straggler_frac, (n,))))


def port_trace(ap, n, seed, max_toggles=64):
    """The port's ``sample_availability`` on the reference's draws."""
    tap = tcm.AvailabilityParams(**dataclasses.asdict(ap))
    return tcm.sample_availability(tap, n, seed=seed,
                                   max_toggles=max_toggles,
                                   **ref_draws(ap, n, seed, max_toggles))


def assert_traces_equal(t, j):
    for name in ("init_up", "toggles", "latency_scale"):
        a, b = getattr(t, name), getattr(j, name)
        assert a.dtype == b.dtype and a.shape == b.shape, name
        np.testing.assert_array_equal(a, b, err_msg=name)


def test_params_match_reference():
    assert (dataclasses.asdict(tcm.AvailabilityParams())
            == dataclasses.asdict(jcm.AvailabilityParams()))
    assert (dataclasses.asdict(ttr.TrafficParams())
            == dataclasses.asdict(jtr.TrafficParams()))
    assert dataclasses.asdict(tserve.STATIONARY) == STATIONARY | {
        "jitter_sigma": 0.0}


def test_trace_methods_match_reference():
    j = jcm.sample_availability(jcm.AvailabilityParams(**STATIONARY), 40,
                                seed=5)
    t = tcm.AvailabilityTrace(j.init_up, j.toggles, j.latency_scale)
    assert t.n_devices == j.n_devices == 40
    for time in (0.0, 1.0, 130.0, 900.0, 5e3, 1e9):
        np.testing.assert_array_equal(t.up_at(time), j.up_at(time))
        for n in (0, 7, 39):
            np.testing.assert_array_equal(t.toggles_after(n, time),
                                          j.toggles_after(n, time))
    assert_traces_equal(tcm.AvailabilityTrace.always_on(6),
                        jcm.AvailabilityTrace.always_on(6))


@pytest.mark.parametrize("kw,n,seed,max_toggles", SAMPLER_CASES)
def test_samplers_on_reference_draws_bitwise(kw, n, seed, max_toggles):
    ap = jcm.AvailabilityParams(**kw)
    tap = tcm.AvailabilityParams(**kw)
    d = ref_draws(ap, n, seed, max_toggles)
    k_t, k_s = jax.random.split(jax.random.PRNGKey(seed))
    j_up, j_tog = jcm.sample_toggle_times(k_t, ap, n, max_toggles)
    gen = torch.Generator().manual_seed(0)
    t_up, t_tog = tcm.sample_toggle_times(
        gen, tap, n, max_toggles, uniforms=d["uniforms"],
        exponentials=d["exponentials"])
    np.testing.assert_array_equal(t_up, np.asarray(j_up))
    assert t_tog.dtype == np.float32
    np.testing.assert_array_equal(t_tog, np.asarray(j_tog))
    t_sc = tcm.sample_straggler_scales(gen, tap, n, slow=d["slow"])
    j_sc = np.asarray(jcm.sample_straggler_scales(k_s, ap, n))
    assert t_sc.dtype == j_sc.dtype
    np.testing.assert_array_equal(t_sc, j_sc)
    assert_traces_equal(port_trace(ap, n, seed, max_toggles),
                        jcm.sample_availability(ap, n, seed=seed,
                                                max_toggles=max_toggles))


def test_cumsum_order_matters_past_16():
    """The blocked order is needed: a sequential f32 sum of the churny
    case's 256 holding times differs from the reference's trace."""
    ap = jcm.AvailabilityParams(**SAMPLER_CASES[3][0])
    d = ref_draws(ap, 10, 13, 256)
    up_during = (d["uniforms"] >= np.float32(ap.p_offline0))[:, None] ^ (
        np.arange(256)[None] % 2 == 1)
    dur = d["exponentials"] * np.where(up_during, np.float32(ap.mean_up_s),
                                       np.float32(ap.mean_down_s))
    ref = jcm.sample_availability(ap, 10, seed=13, max_toggles=256).toggles
    seq = np.cumsum(dur, axis=1, dtype=np.float32).astype(np.float64)
    assert not np.array_equal(seq, ref)
    np.testing.assert_array_equal(seq[:, :16], ref[:, :16])


def test_own_draws_replay_and_shape():
    ap = tcm.AvailabilityParams(**STATIONARY)
    a = tcm.sample_availability(ap, 200, seed=3)
    b = tcm.sample_availability(ap, 200, seed=3)
    assert_traces_equal(a, b)
    assert a.toggles.shape == (200, 64) and a.toggles.dtype == np.float64
    assert a.init_up.dtype == bool
    assert set(np.unique(a.latency_scale)) == {1.0, 4.0}
    assert 10 < int((a.latency_scale == 4.0).sum()) < 70     # ~40 of 200
    assert 5 < int((~a.init_up).sum()) < 40                  # ~20 of 200
    assert (np.diff(a.toggles, axis=1) >= 0).all()
    c = tcm.sample_availability(ap, 200, seed=4)
    assert not np.array_equal(a.toggles, c.toggles)
    d = tcm.sample_availability(tcm.AvailabilityParams(), 8, seed=1)
    assert d.init_up.all() and np.isinf(d.toggles).all()
    assert (d.latency_scale == 1.0).all()
    with pytest.raises(ValueError, match="shape"):
        tcm.sample_toggle_times(torch.Generator(), ap, 4,
                                uniforms=np.zeros(3, np.float32))


@pytest.mark.parametrize("shape", sorted(TRAFFIC_CASES))
@pytest.mark.parametrize("stragglers", [False, True])
def test_traffic_matches_reference_bitwise(shape, stragglers):
    kw = TRAFFIC_CASES[shape]
    jgen = jtr.TrafficGenerator(jtr.TrafficParams(**kw), 40, seed=9)
    tgen = ttr.TrafficGenerator(ttr.TrafficParams(**kw), 40, seed=9)
    for t in (0.0, 25.0, 299.9, 300.0, 900.0, 2700.0, 3650.0, 7300.0):
        assert tgen.rate(t) == jgen.rate(t)
    jap = tap = slow = None
    if stragglers:
        jap = jcm.AvailabilityParams(straggler_frac=0.3, straggler_scale=6.0)
        tap = tcm.AvailabilityParams(straggler_frac=0.3, straggler_scale=6.0)
        slow = np.asarray(jax.random.bernoulli(jax.random.PRNGKey(9), 0.3,
                                               (40,)))
    horizon = 200.0 if shape == "stationary" else 2e4
    j = jgen.make_trace(horizon, jap)
    t = tgen.make_trace(horizon, tap, slow=slow)
    assert_traces_equal(t, j)
    assert np.isfinite(t.toggles).sum() > 20
    if stragglers:
        assert set(np.unique(t.latency_scale)) == {1.0, 6.0}
        own = tgen.make_trace(horizon, tap)         # the port's own draw
        np.testing.assert_array_equal(own.toggles, j.toggles)
        assert set(np.unique(own.latency_scale)) <= {1.0, 6.0}


@pytest.mark.parametrize("traffic", ["always-on", "stationary", "diurnal",
                                     "bursty"])
def test_build_trace_presets(traffic):
    """Every preset equals the reference's; the stationary one (drawn by
    ``jax.random`` there) on the reference's injected draws."""
    j = jserve.build_trace(traffic, 40, seed=2)
    t = tserve.build_trace(traffic, 40, seed=2)
    if traffic == "stationary":
        assert_traces_equal(port_trace(jcm.AvailabilityParams(**STATIONARY),
                                       40, 2), j)
        assert t.toggles.shape == j.toggles.shape
        assert_traces_equal(t, tserve.build_trace(traffic, 40, seed=2))
    else:
        assert_traces_equal(t, j)
    assert t.n_devices == 40
    with pytest.raises(ValueError, match="unknown traffic"):
        tserve.build_trace("nope", 8, seed=0)
