"""Port kernels (``repro_torch.kernels``) against ``repro``'s kernels.

On the CPU the dispatchers take each kernel's plain PyTorch version;
these tests hold it against ``repro``'s ``ref.py`` oracles and its
Pallas kernels in interpret mode, on the same numpy inputs. Tolerance:
f32 products summed in another order (BLAS vs XLA vs the Pallas block
loop), so a few ulps of the sum: rtol/atol 1e-5 for aggregation, and for
distances atol 1e-5 of the largest distance (the ‖x‖²+‖c‖²−2x·c form
cancels). The CUDA kernels themselves are checked against their plain
versions in ``tests/test_torch_cuda.py``, which needs a card.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.hier_agg.hier_agg import masked_aggregate_batched_pallas
from repro.kernels.hier_agg.ref import masked_aggregate_ref
from repro.kernels.kmeans_dist.kmeans_dist import pairwise_sq_dists_pallas
from repro.kernels.kmeans_dist.ref import pairwise_sq_dists_ref
from repro_torch.kernels.hier_agg import ops as ha
from repro_torch.kernels.kmeans_dist import ops as kd


def _one_hot_mask(rng, M, H, empty=()):
    assign = rng.integers(0, M, H)
    for m in empty:
        assign[assign == m] = (m + 1) % M
    return (assign[None, :] == np.arange(M)[:, None]).astype(np.float32)


def _agg_inputs(seed, S, M, H, P, empty=()):
    rng = np.random.default_rng(seed)
    mask = np.stack([_one_hot_mask(rng, M, H, empty) for _ in range(S)])
    sizes = rng.uniform(10, 700, (S, H)).astype(np.float32)
    deltas = rng.normal(0, 1, (S, H, P)).astype(np.float32)
    return mask, sizes, deltas


# ------------------------------------------------------------ hier_agg

@pytest.mark.parametrize("S,M,H,P,empty", [
    (1, 5, 50, 2260, ()),       # fc2 leaf of the paper CNN, H=50, M=5
    (1, 3, 13, 257, ()),        # unaligned M, H, P
    (1, 1, 5, 375, ()),         # cloud layout: one row over M=5 edges
    (1, 6, 30, 1037, (2, 5)),   # empty edges -> zero rows
    (3, 5, 26, 700, ()),        # S lanes
    (2, 10, 9, 33, (0,)),       # M > the kernel's 8-row tile
])
def test_masked_aggregate_plain_matches_reference(S, M, H, P, empty):
    mask, sizes, deltas = _agg_inputs(S + M + H + P, S, M, H, P, empty)
    got = ha.masked_aggregate_batched(torch.from_numpy(mask),
                                      torch.from_numpy(sizes),
                                      torch.from_numpy(deltas)).numpy()
    ref = np.stack([np.asarray(masked_aggregate_ref(
        jnp.asarray(mask[s]), jnp.asarray(sizes[s]), jnp.asarray(deltas[s])))
        for s in range(S)])
    pallas = np.asarray(masked_aggregate_batched_pallas(
        jnp.asarray(mask), jnp.asarray(sizes), jnp.asarray(deltas),
        interpret=True))
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got, pallas, rtol=1e-5, atol=1e-5)
    for m in empty:
        assert np.all(got[:, m] == 0.0)


def test_masked_aggregate_unbatched_is_lane_zero():
    mask, sizes, deltas = _agg_inputs(0, 1, 4, 11, 50)
    one = ha.masked_aggregate(torch.from_numpy(mask[0]),
                              torch.from_numpy(sizes[0]),
                              torch.from_numpy(deltas[0]))
    lanes = ha.masked_aggregate_batched(torch.from_numpy(mask),
                                        torch.from_numpy(sizes),
                                        torch.from_numpy(deltas))
    assert torch.equal(one, lanes[0])


# --------------------------------------------------------- kmeans_dist

@pytest.mark.parametrize("N,P,K", [
    (100, 1640, 10),    # IKC mini-model weights, K=10 clusters
    (37, 130, 3),       # unaligned everything
    (5, 7, 2),          # tiny
    (64, 600, 200),     # K > 128
])
def test_pairwise_sq_dists_plain_matches_reference(N, P, K):
    rng = np.random.default_rng(N + P + K)
    x = rng.normal(0, 1, (N, P)).astype(np.float32)
    c = rng.normal(0, 1, (K, P)).astype(np.float32)
    got = kd.pairwise_sq_dists(torch.from_numpy(x), torch.from_numpy(c))
    got = got.numpy()
    ref = np.asarray(pairwise_sq_dists_ref(jnp.asarray(x), jnp.asarray(c)))
    pallas = np.asarray(pairwise_sq_dists_pallas(jnp.asarray(x),
                                                 jnp.asarray(c),
                                                 interpret=True))
    atol = 1e-5 * float(ref.max())
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=atol)
    np.testing.assert_allclose(got, pallas, rtol=1e-5, atol=atol)
    assert got.min() >= 0.0


# ----------------------------------------------- wrappers and dispatch

def test_cuda_wrappers_refuse_cpu_tensors():
    """A wrapper launches on CUDA tensors or raises; it never computes on
    the CPU itself (that is the dispatcher's plain path)."""
    mask, sizes, deltas = _agg_inputs(1, 1, 2, 3, 4)
    with pytest.raises(ValueError, match="CUDA"):
        ha.masked_aggregate_batched_cuda(torch.from_numpy(mask),
                                         torch.from_numpy(sizes),
                                         torch.from_numpy(deltas))
    with pytest.raises(ValueError, match="CUDA"):
        kd.pairwise_sq_dists_cuda(torch.zeros(3, 4), torch.zeros(2, 4))
    with pytest.raises(ValueError, match="shape"):
        ha.masked_aggregate_batched_cuda(torch.zeros(1, 2, 3),
                                         torch.zeros(1, 4),
                                         torch.zeros(1, 3, 5))


def test_cpu_dispatch_launches_nothing():
    before = (ha.masked_aggregate_batched_cuda.launches,
              kd.pairwise_sq_dists_cuda.launches)
    ha.masked_aggregate(torch.ones(2, 3), torch.ones(3), torch.ones(3, 4))
    kd.pairwise_sq_dists(torch.ones(3, 4), torch.ones(2, 4))
    assert (ha.masked_aggregate_batched_cuda.launches,
            kd.pairwise_sq_dists_cuda.launches) == before
