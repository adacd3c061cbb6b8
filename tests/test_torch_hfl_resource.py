"""Port Algorithm 1, evaluation and the problem-(27) allocator against
``repro``.

Allocation: the same Adam on the same f32 world; the summation order of
the softmax/logsumexp differs and each step carries it forward. At 30
steps the measured gap is below 2.3e-5 relative (b), so b, f, T_edge and
E_edge are held to rtol 1e-4. (At 200 steps some edges are ill
conditioned: the reference itself moves T_edge by 2% under a 1e-6
perturbation of u, so no test runs that long.) Algorithm 1: ``repro``
runs with ``agg_kernel=True`` (its Pallas kernel in interpret mode) and
the port with both backends; Q*L GD steps of a small CNN feed rounding
forward, so params are held to rtol 1e-4 / atol 1e-6.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core.cost_model as jcm
import repro.core.resource as jra
from repro.core.hfl import evaluate_in_batches as j_eval
from repro.core.hfl import hfl_global_iteration
from repro.core.hfl import pad_device_data as j_pad
from repro.data import partition_noniid as j_partition
from repro.models import cnn as jcnn
import repro_torch.core.cost_model as tcm
import repro_torch.core.resource as tra
from repro_torch.convert import params_from_numpy, params_to_numpy
from repro_torch.core.hfl import evaluate_in_batches as t_eval
from repro_torch.core.hfl import hfl_global_iteration_core
from repro_torch.core.hfl import pad_device_data as t_pad
from repro_torch.data import make_dataset
from repro_torch.data import partition_noniid as t_partition
from repro_torch.models import cnn as tcnn
from test_torch_framework import one_torch_thread  # noqa: F401 (autouse)


@pytest.mark.parametrize("seed", [1, 7])
def test_allocate_batch_matches(seed):
    """All M per-edge problems at once; edge 3 has no device."""
    kw = dict(n_devices=18, n_edges=4)
    sp_j, sp_t = jcm.SystemParams(**kw), tcm.SystemParams(**kw)
    pj = jcm.sample_population(sp_j, seed=seed)
    pt = tcm.sample_population(sp_t, seed=seed, device="cpu")
    assign = np.random.default_rng(seed).integers(0, 3, 18)
    mask = assign[None, :] == np.arange(4)[:, None]
    rj = jra.allocate_batch(
        sp_j, jnp.broadcast_to(pj.u, (4, 18)), jnp.broadcast_to(pj.D, (4, 18)),
        jnp.broadcast_to(pj.p, (4, 18)), pj.g.T, pj.B_m, jnp.asarray(mask),
        steps=30)
    rt = tra.allocate_batch(
        sp_t, pt.u.expand(4, 18), pt.D.expand(4, 18), pt.p.expand(4, 18),
        pt.g.T, pt.B_m, torch.from_numpy(mask), steps=30)
    for f in ("b", "f", "T_edge", "E_edge", "obj"):
        np.testing.assert_allclose(getattr(rt, f).numpy(),
                                   np.asarray(getattr(rj, f)), rtol=1e-4,
                                   atol=1e-3, err_msg=f)
    assert float(rt.T_edge[3]) == 0.0 and float(rt.obj[3]) == 0.0
    bj, fj = jra.select_device_allocation(rj, jnp.asarray(assign))
    bt, ft = tra.select_device_allocation(rt, torch.from_numpy(assign))
    np.testing.assert_allclose(bt.numpy(), np.asarray(bj), rtol=1e-4)
    np.testing.assert_allclose(ft.numpy(), np.asarray(fj), rtol=1e-4)
    one = tra.allocate(sp_t, pt.u, pt.D, pt.p, pt.g[:, 0], pt.B_m[0],
                       torch.from_numpy(mask[0]), steps=30)
    np.testing.assert_allclose(one.b.numpy(), rt.b[0].numpy(), rtol=1e-6)


@pytest.fixture(scope="module")
def fed():
    X, y, Xt, yt = make_dataset("fmnist_syn", n_train=300, n_test=70, seed=0)
    return X, y, Xt, yt


def test_pad_device_data_and_eval(fed):
    X, y, Xt, yt = fed
    fj = j_partition(X, y, Xt, yt, n_devices=5, size_range=(6, 12), seed=1)
    ft = t_partition(X, y, Xt, yt, n_devices=5, size_range=(6, 12), seed=1)
    for a, b in zip(j_pad(fj), t_pad(ft, device="cpu")):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
    p = params_to_numpy(tcnn.cnn_init(torch.Generator().manual_seed(0),
                                      (28, 28), 1, hidden=16, device="cpu"))
    tp = params_from_numpy(p, "cpu")
    for batch in (32, 70, 512):     # ragged tail, exact, one chunk
        acc_t = t_eval(tcnn.cnn_apply, tp, Xt, yt, batch=batch)
        acc_j = j_eval(jcnn.cnn_apply, p, Xt, yt, batch=batch)
        assert acc_t == acc_j
        assert acc_t * len(yt) == round(acc_t * len(yt))


def test_hfl_global_iteration_matches_reference(fed):
    """Both port backends against repro's Pallas-kernel backend; edge 2
    of M=4 is empty (keeps its model, zero cloud weight)."""
    X, y, Xt, yt = fed
    ft = t_partition(X, y, Xt, yt, n_devices=6, size_range=(5, 9), seed=2)
    Xp, yp, mp = t_pad(ft, device="cpu")
    sizes = torch.tensor(ft.sizes, dtype=torch.float32)
    assign = np.array([0, 1, 3, 0, 3, 1])
    p0 = params_to_numpy(tcnn.cnn_init(torch.Generator().manual_seed(1),
                                       (28, 28), 1, hidden=12, device="cpu"))
    kw = dict(M=4, L=2, Q=2, lr=0.05)
    ref = hfl_global_iteration(
        jcnn.cnn_apply, p0, jnp.asarray(Xp.numpy()),
        jnp.asarray(yp.numpy().astype(np.int32)), jnp.asarray(mp.numpy()),
        jnp.asarray(sizes.numpy()), jnp.asarray(assign), agg_kernel=True,
        **kw)
    for agg_kernel in (False, True):
        out = hfl_global_iteration_core(
            tcnn.cnn_apply, params_from_numpy(p0, "cpu"), Xp, yp, mp, sizes,
            torch.from_numpy(assign), agg_kernel=agg_kernel, **kw)
        for k in p0:
            np.testing.assert_allclose(out[k].numpy(), np.asarray(ref[k]),
                                       rtol=1e-4, atol=1e-6,
                                       err_msg=f"{k} agg_kernel={agg_kernel}")
