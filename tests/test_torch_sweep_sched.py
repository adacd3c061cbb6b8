"""Setting up a sweep: ``pad_device_data`` with a common ``Dmax``,
``build_scheduler`` and ``SweepRunner.sweep_ratios`` of
``repro_torch.core.sweep`` against ``repro``, on the world of
``tests/test_torch_sweep.py``.

Tolerances: ``pad_device_data`` bitwise; ``build_scheduler`` with the
reference's clustering injected gives the reference's cohorts exactly,
ari and aux_bits exactly, the clustering's delay and energy to rtol 1e-6
(the cost model in f32 on both sides); ``sweep_ratios``' records as
``SweepRunner.run``'s in ``tests/test_torch_sweep.py``.
"""
import numpy as np
import pytest
import torch

import repro.core.cost_model as jcm
import repro.data as jdata
import repro_torch.core.cost_model as tcm
import repro_torch.data as tdata
from repro.core import hfl as jhfl
from repro.core import sweep as jsw
from repro_torch.core import hfl as thfl
from repro_torch.core import sweep as tsw
from test_torch_framework import one_torch_thread  # noqa: F401 (autouse)
from test_torch_sweep import H, N, _assert_run_matches, _runners, _world


# ----------------------------------------------------- pad_device_data

@pytest.mark.parametrize("Dmax", [None, 20, 12])
def test_pad_device_data_matches_reference(Dmax):
    """Padded to the largest dataset, to a larger common Dmax, and
    truncated to a smaller one."""
    _, _, fed = _world(tcm, tdata, 0)
    _, _, jfed = _world(jcm, jdata, 0)
    got = thfl.pad_device_data(fed, Dmax, device="cpu")
    want = jhfl.pad_device_data(jfed, Dmax)
    for g, w in zip(got, want):
        assert tuple(g.shape) == w.shape
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert got[1].dtype == torch.int64 and got[2].dtype == torch.float32


# ------------------------------------------- schedulers and ratio sweeps

@pytest.mark.parametrize("name", ["ikc", "vkc"])
def test_build_scheduler_matches_reference(name):
    """With the reference's clustering injected (torch cannot replay its
    ``jax.random`` draws), the same scheduler: the same cohorts from the
    same rng and the same Table-II statistics (ari and aux_bits exact,
    delay and energy rtol 1e-6). The port's own clustering runs too."""
    sp, pop, fed = _world(jcm, jdata, 0)
    tsp, tpop, tfed = _world(tcm, tdata, 0)
    js, jstats = jsw.build_scheduler(name, fed, sp, H, K=3, seed=0, pop=pop)
    labels = np.asarray(js.state.clusters)
    ts, tstats = tsw.build_scheduler(name, tfed, tsp, H, K=3, seed=0,
                                     pop=tpop, labels=labels, device="cpu")
    assert tstats["ari"] == jstats["ari"]
    assert tstats["aux_bits"] == jstats["aux_bits"]
    for k in ("delay_s", "energy_j"):
        np.testing.assert_allclose(tstats[k], jstats[k], rtol=1e-6)
    rj, rt = np.random.default_rng(5), np.random.default_rng(5)
    for _ in range(3):
        np.testing.assert_array_equal(ts.schedule(rt), js.schedule(rj))
    own = tsw.build_scheduler(name, tfed, tsp, H, K=3, seed=0, device="cpu",
                              use_kernel=True)
    assert sorted(set(own.state.clusters.tolist())) == [0, 1, 2]
    with pytest.raises(ValueError, match="labels"):
        tsw.build_scheduler(name, tfed, tsp, H, K=3, labels=labels[:-1],
                            device="cpu")


def test_sweep_ratios_match_reference():
    """H = ratio·N per ratio (the full ratio schedules FedAvg), one run
    each, against the reference's records."""
    jr, tr = _runners()
    kw = dict(scheduler="fedavg", n_rounds=1)
    j = jr.sweep_ratios([0.5, 1.0], **kw)
    t = tr.sweep_ratios([0.5, 1.0], **kw)
    assert t.keys() == j.keys()
    for r in j:
        _assert_run_matches(t[r], j[r])
    assert t[1.0]["H"] == N and t[0.5]["H"] == N // 2
