"""Port cost model, data and utilities against ``repro``.

Population and data are drawn with numpy in the same order in both
packages, so they must be bitwise equal (after the f32 cast that JAX's
x64-off mode applies). The cost equations run in f32 on both sides with
the same operation order; rtol 1e-6 allows one or two ulps where XLA and
PyTorch evaluate log2/pow differently.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core.cost_model as jcm
import repro.data as jdata
import repro.utils as jutils
import repro_torch.core.cost_model as tcm
import repro_torch.data as tdata
import repro_torch.utils as tutils

RTOL = 1e-6


def _pops(seed=3, **kw):
    sp_j = jcm.SystemParams(**kw)
    sp_t = tcm.SystemParams(**kw)
    return (sp_j, jcm.sample_population(sp_j, seed=seed),
            sp_t, tcm.sample_population(sp_t, seed=seed, device="cpu"))


def test_system_params_match():
    assert (dataclasses.asdict(jcm.SystemParams())
            == dataclasses.asdict(tcm.SystemParams()))
    assert jcm.SystemParams().n0_w_hz == tcm.SystemParams().n0_w_hz


@pytest.mark.parametrize("seed,n,m", [(0, 100, 5), (3, 17, 4)])
def test_population_bitwise(seed, n, m):
    _, pj, _, pt = _pops(seed, n_devices=n, n_edges=m)
    for f in ("u", "D", "p", "f_max", "g", "g_cloud", "B_m"):
        a, b = np.asarray(getattr(pj, f)), getattr(pt, f).numpy()
        assert a.dtype == b.dtype == np.float32, f
        np.testing.assert_array_equal(a, b, err_msg=f)
    np.testing.assert_array_equal(pj.dev_pos, pt.dev_pos)
    np.testing.assert_array_equal(pj.edge_pos, pt.edge_pos)


def test_per_device_equations():
    sp_j, pj, sp_t, pt = _pops(5, n_devices=30, n_edges=3)
    rng = np.random.default_rng(0)
    b = rng.uniform(1e4, 1e6, 30).astype(np.float32)
    f = rng.uniform(1e8, 2e9, 30).astype(np.float32)
    g = np.array(pj.g)[:, 1]
    for name in ("t_cmp", "e_cmp"):
        np.testing.assert_allclose(
            getattr(tcm, name)(sp_t, pt.u, pt.D, torch.from_numpy(f)).numpy(),
            np.asarray(getattr(jcm, name)(sp_j, pj.u, pj.D, jnp.asarray(f))),
            rtol=RTOL, err_msg=name)
    for name in ("uplink_rate", "t_com", "e_com"):
        np.testing.assert_allclose(
            getattr(tcm, name)(sp_t, torch.from_numpy(b), torch.from_numpy(g),
                               pt.p).numpy(),
            np.asarray(getattr(jcm, name)(sp_j, jnp.asarray(b),
                                          jnp.asarray(g), pj.p)),
            rtol=RTOL, err_msg=name)
    for j, t in zip(jcm.cloud_cost(sp_j, pj.g_cloud),
                    tcm.cloud_cost(sp_t, pt.g_cloud)):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=RTOL)
    mask = rng.random(30) < 0.5
    for j, t in zip(
            jcm.edge_round_cost(sp_j, pj.u, pj.D, pj.p, jnp.asarray(g),
                                jnp.asarray(b), jnp.asarray(f),
                                jnp.asarray(mask)),
            tcm.edge_round_cost(sp_t, pt.u, pt.D, pt.p, torch.from_numpy(g),
                                torch.from_numpy(b), torch.from_numpy(f),
                                torch.from_numpy(mask))):
        np.testing.assert_allclose(float(t), float(j), rtol=RTOL)


def test_round_cost_with_empty_edge():
    """Edge 3 gets no device: its T_m/E_m reduce to the cloud terms only
    (the segment max/sum of an empty segment is 0 in both)."""
    sp_j, pj, sp_t, pt = _pops(7, n_devices=20, n_edges=4)
    rng = np.random.default_rng(1)
    sched = rng.choice(20, 9, replace=False)
    assign = rng.integers(0, 3, 9)
    b = rng.uniform(1e4, 1e6, 9).astype(np.float32)
    f = rng.uniform(1e8, 2e9, 9).astype(np.float32)
    out_j = jcm.round_cost(sp_j, pj, jnp.asarray(sched), jnp.asarray(assign),
                           jnp.asarray(b), jnp.asarray(f))
    s, a = torch.from_numpy(sched), torch.from_numpy(assign)
    out_t = tcm.round_cost_gathered(
        sp_t, pt.u[s], pt.D[s], pt.p[s], pt.g[s, a], pt.g_cloud, a,
        torch.from_numpy(b), torch.from_numpy(f), 4)
    for j, t in zip(out_j, out_t):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=RTOL)
    T_cl, E_cl = tcm.cloud_cost(sp_t, pt.g_cloud)
    assert float(out_t[2][3]) == float(T_cl[3])
    assert float(out_t[3][3]) == float(E_cl[3])
    assert tcm.objective(sp_t, 2.0, 3.0) == jcm.objective(sp_j, 2.0, 3.0)
    assert (tcm.round_msg_bits(sp_t, 25, 5)
            == jcm.round_msg_bits(sp_j, 25, 5))
    assert (tcm.round_msg_bits(sp_t, 25, 5, msg_bits=8.0)
            == jcm.round_msg_bits(sp_j, 25, 5, msg_bits=8.0))


def test_cuda_population_without_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the cuda path is valid here")
    with pytest.raises(RuntimeError, match="CUDA"):
        tcm.sample_population(tcm.SystemParams(), seed=0)


@pytest.mark.parametrize("name,n_train,n_test,seed", [
    ("fmnist_syn", 300, 50, 0), ("cifar_syn", 120, 30, 4)])
def test_make_dataset_bitwise(name, n_train, n_test, seed):
    for a, b in zip(jdata.make_dataset(name, n_train, n_test, seed),
                    tdata.make_dataset(name, n_train, n_test, seed)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


def test_partition_noniid_bitwise():
    X, y, Xt, yt = tdata.make_dataset("fmnist_syn", 400, 40, seed=1)
    fj = jdata.partition_noniid(X, y, Xt, yt, n_devices=9,
                                size_range=(10, 30), seed=2)
    ft = tdata.partition_noniid(X, y, Xt, yt, n_devices=9,
                                size_range=(10, 30), seed=2)
    assert fj.n_devices == ft.n_devices and fj.n_classes == ft.n_classes
    np.testing.assert_array_equal(fj.majority_class, ft.majority_class)
    np.testing.assert_array_equal(fj.sizes, ft.sizes)
    for a, b in zip(fj.X + fj.y, ft.X + ft.y):
        np.testing.assert_array_equal(a, b)


def test_utils_match():
    rng = np.random.default_rng(0)
    tree = {"b": rng.normal(size=(3, 2)).astype(np.float32),
            "a": rng.normal(size=(4,)).astype(np.float32)}
    tt = {k: torch.from_numpy(v) for k, v in tree.items()}
    jt = {k: jnp.asarray(v) for k, v in tree.items()}
    assert tutils.tree_bytes(tt) == jutils.tree_bytes(jt)
    np.testing.assert_array_equal(tutils.tree_flatten_to_vector(tt).numpy(),
                                  np.asarray(jutils.tree_flatten_to_vector(jt)))
    for v in (-174.0, 0.0, 23.0):
        assert tutils.dbm_to_watt(v) == jutils.dbm_to_watt(v)
        assert tutils.db_to_linear(v) == jutils.db_to_linear(v)
