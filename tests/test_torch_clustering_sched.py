"""Port clustering (Algorithm 2), schedulers and geo assignment against
``repro``.

kmeans++ seeding draws from ``jax.random`` in the reference; the tests
recover the rows it picked and inject them into the port, so both run
Lloyd's steps from the same centres. Labels must then be equal and the
centres agree to rtol 1e-5 (f32 means summed in another order). The
schedulers and the geo assigner are numpy copies: identical cohorts and
assignments for the same rng and labels.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core.clustering as jcl
import repro.core.cost_model as jcm
import repro.core.scheduling.schedulers as jsch
from repro.core.assignment.geo import GeoAssigner as JGeo
from repro.core.scheduling.device_clustering import (
    auxiliary_weight_vectors as j_aux, clustering_cost as j_ccost,
    run_device_clustering as j_run)
from repro.models import cnn as jcnn
from repro.models.spec import _cnn_mini_preprocess
import repro_torch.core.clustering as tcl
import repro_torch.core.cost_model as tcm
import repro_torch.core.scheduling.schedulers as tsch
from repro_torch.convert import params_from_numpy, params_to_numpy
from repro_torch.core.assignment.geo import GeoAssigner as TGeo
from repro_torch.core.scheduling.device_clustering import (
    clustering_cost as t_ccost, run_device_clustering as t_run)
from repro_torch.data import make_dataset, partition_noniid
from repro_torch.core.hfl import pad_device_data
from repro_torch.models import cnn as tcnn


def _pp_rows(key, x, k):
    """Rows of ``x`` that repro's kmeans++ picks for ``key``."""
    cen = np.asarray(jcl._kmeans_pp_init(key, jnp.asarray(x), k))
    d = ((cen[:, None, :] - np.asarray(x)[None]) ** 2).sum(-1)
    assert np.allclose(d.min(1), 0.0)
    return d.argmin(1)


def _blobs(seed, n, dim, k, spread=0.6):
    rng = np.random.default_rng(seed)
    means = rng.normal(0, 3, (k, dim))
    lab = rng.integers(0, k, n)
    return (means[lab] + rng.normal(0, spread, (n, dim))).astype(np.float32)


@pytest.mark.parametrize("n,dim,k,spread", [(60, 8, 4, 0.6),
                                            (45, 30, 5, 3.0)])
def test_kmeans_from_injected_seeding(n, dim, k, spread):
    x = _blobs(n + k, n, dim, k, spread)
    key = jax.random.PRNGKey(n)
    idx = _pp_rows(key, x, k)
    lab_j, cen_j = jcl.kmeans(key, jnp.asarray(x), k, iters=20)
    for use_kernel in (False, True):
        lab_t, cen_t = tcl.kmeans(torch.from_numpy(x), k, iters=20,
                                  use_kernel=use_kernel, init_idx=idx)
        np.testing.assert_array_equal(lab_t.numpy(), np.asarray(lab_j))
        np.testing.assert_allclose(cen_t.numpy(), np.asarray(cen_j),
                                   rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("use_kernel", [False, True])
def test_pairwise_sq_dists_routes_match(use_kernel):
    """clustering.pairwise_sq_dists on both routes (repro's True is its
    Pallas kernel in interpret mode; the port's is the plain version on
    the CPU)."""
    x, c = _blobs(1, 50, 40, 3), _blobs(2, 7, 40, 2)
    got = tcl.pairwise_sq_dists(torch.from_numpy(x), torch.from_numpy(c),
                                use_kernel=use_kernel).numpy()
    want = np.asarray(jcl.pairwise_sq_dists(jnp.asarray(x), jnp.asarray(c),
                                            use_kernel=use_kernel))
    np.testing.assert_allclose(got, want, rtol=1e-5,
                               atol=1e-5 * float(want.max()))


def test_kmeans_torch_seeding_is_a_valid_start():
    x = torch.from_numpy(_blobs(3, 80, 6, 4, 0.3))
    g = torch.Generator().manual_seed(0)
    idx = tcl.kmeans_pp_indices(x, 4, g)
    assert len(set(idx.tolist())) == 4
    lab, _ = tcl.kmeans_best_of(x, 4, restarts=3, iters=10, generator=g)
    truth, _ = tcl.kmeans(x, 4, iters=30, init_idx=idx)
    assert tcl.adjusted_rand_index(lab.numpy(), truth.numpy()) > 0.9


def test_kmeans_more_centres_than_rows():
    """k above the number of distinct rows (the model-zoo launcher's smoke
    jobs cluster 8 devices into K=10): once every row is a centre the
    reference's ``jax.random.choice`` draws from an all-zero distribution
    and takes row 0; the port picks row 0 too, and kmeans runs on."""
    x = np.eye(8, dtype=np.float32) * 3.0
    ref = np.asarray(jcl._kmeans_pp_init(jax.random.PRNGKey(0),
                                         jnp.asarray(x), 10))
    g = torch.Generator().manual_seed(0)
    idx = tcl.kmeans_pp_indices(torch.from_numpy(x), 10, g)
    assert sorted(idx[:8].tolist()) == list(range(8))
    assert idx[8:].tolist() == [0, 0]
    np.testing.assert_array_equal(x[idx.numpy()][8:], ref[8:])
    lab, cen = tcl.kmeans_best_of(torch.from_numpy(x), 10, restarts=2,
                                  iters=3, generator=g)
    assert len(set(lab.tolist())) == 8 and cen.shape == (10, 8)


def test_adjusted_rand_index_matches():
    rng = np.random.default_rng(0)
    for n in (10, 300):
        a, b = rng.integers(0, 4, n), rng.integers(0, 5, n)
        assert tcl.adjusted_rand_index(a, b) == jcl.adjusted_rand_index(a, b)
        assert tcl.adjusted_rand_index(a, a) == 1.0


def test_run_device_clustering_with_injected_crops():
    """Algorithm 2 end to end (mini model on the reference's crops, the
    reference's kmeans++ rows per restart) against repro with its Pallas
    distance kernel in interpret mode."""
    X, y, Xt, yt = make_dataset("fmnist_syn", n_train=400, n_test=20, seed=0)
    fed = partition_noniid(X, y, Xt, yt, n_devices=12, size_range=(8, 14),
                           seed=0)
    Xp, yp, mp = pad_device_data(fed, device="cpu")
    crop = np.asarray(_cnn_mini_preprocess(jnp.asarray(Xp.numpy()),
                                           jax.random.PRNGKey(1)))
    mini = params_to_numpy(tcnn.mini_init(torch.Generator().manual_seed(2),
                                          device="cpu"))
    key = jax.random.PRNGKey(3)
    K, L, lr = 3, 5, 0.01
    yj, mj = jnp.asarray(yp.numpy().astype(np.int32)), jnp.asarray(mp.numpy())
    lab_j, vec_j = j_run(key, jcnn.mini_apply, mini, jnp.asarray(crop), yj,
                         mj, K, L, lr, use_kernel=True)
    vec_j = np.asarray(vec_j)
    z = (vec_j - vec_j.mean(0)) / (vec_j.std(0) + 1e-8)
    idx = [_pp_rows(kk, z.astype(np.float32), K)
           for kk in jax.random.split(key, 8)]
    lab_t, vec_t = t_run(tcnn.mini_apply, params_from_numpy(mini, "cpu"),
                         torch.from_numpy(crop), yp, mp, K, L, lr,
                         use_kernel=True, init_idx=idx)
    np.testing.assert_allclose(vec_t.numpy(), vec_j, rtol=1e-4, atol=1e-6)
    np.testing.assert_array_equal(lab_t, np.asarray(lab_j))
    aux = j_aux(jcnn.mini_apply, mini, jnp.asarray(crop), yj, mj, L, lr)
    np.testing.assert_array_equal(np.asarray(aux), vec_j)


def test_clustering_cost_matches():
    kw = dict(n_devices=40, n_edges=5)
    pj = jcm.sample_population(jcm.SystemParams(**kw), seed=2)
    pt = tcm.sample_population(tcm.SystemParams(**kw), seed=2, device="cpu")
    for bits, scale in ((52480.0, 0.0229), (3660256.0, 1.0)):
        got = t_ccost(tcm.SystemParams(**kw), pt, bits, compute_scale=scale)
        want = j_ccost(jcm.SystemParams(**kw), pj, bits, compute_scale=scale)
        np.testing.assert_allclose(got, want, rtol=1e-6)


def _skewed_labels(seed, n, k):
    """Cluster sizes from 1 to large, so rounds take the short-cluster,
    refill and top-up paths."""
    rng = np.random.default_rng(seed)
    p = rng.dirichlet(np.full(k, 0.5))
    lab = rng.choice(k, n, p=p)
    lab[:k] = np.arange(k)                         # every cluster exists
    return lab


@pytest.mark.parametrize("policy,n,k,h", [
    ("IKCScheduler", 30, 5, 3), ("IKCScheduler", 200, 10, 5),
    ("VKCScheduler", 30, 5, 3), ("VKCScheduler", 200, 10, 5),
    ("FedAvgScheduler", 50, None, 12)])
def test_schedulers_give_identical_cohorts(policy, n, k, h):
    if k is None:
        js, ts = jsch.FedAvgScheduler(n, h), tsch.FedAvgScheduler(n, h)
    else:
        lab = _skewed_labels(n, n, k)
        js = getattr(jsch, policy)(lab, h)
        ts = getattr(tsch, policy)(lab, h)
    rj, rt = np.random.default_rng(9), np.random.default_rng(9)
    for _ in range(12):
        np.testing.assert_array_equal(ts.schedule(rt), js.schedule(rj))
    np.testing.assert_array_equal(ts.topup_to(np.arange(3), 9, rt),
                                  js.topup_to(np.arange(3), 9, rj))


def test_geo_assigner_identical():
    kw = dict(n_devices=60, n_edges=6)
    pj = jcm.sample_population(jcm.SystemParams(**kw), seed=4)
    pt = tcm.sample_population(tcm.SystemParams(**kw), seed=4, device="cpu")
    sched = np.random.default_rng(0).choice(60, 25, replace=False)
    a_j, _ = JGeo(jcm.SystemParams(**kw)).assign(pj, sched)
    a_t, _ = TGeo(tcm.SystemParams(**kw)).assign(pt, sched)
    np.testing.assert_array_equal(a_t, a_j)
