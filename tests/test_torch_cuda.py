"""The port's CUDA kernels against their plain PyTorch versions, on a
card. This file imports neither JAX nor ``repro``, so it also runs where
only torch is installed:

    PYTHONPATH=src python -m pytest -q --noconftest -m cuda tests/test_torch_cuda.py

Without a card every test skips (the kernels have no CPU mode).
Tolerance: the kernels sum f32 products with FMAs in another order than
cuBLAS, so rtol/atol 1e-5 (distances: atol 1e-5 of the largest). The
decode-aggregate kernel folds the scale into its panel, ``(w·sc)·q``,
where the plain version computes ``w·(sc·q)``; int8 and bf16 widen to
f32 exactly, so the same 1e-5 holds for every wire dtype.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels.hier_agg import ops as ha
from repro_torch.kernels.kmeans_dist import ops as kd


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the CUDA kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _agg_inputs(seed, S, M, H, P, empty, device):
    rng = np.random.default_rng(seed)
    assign = rng.integers(0, M, (S, H))
    for m in empty:
        assign[assign == m] = (m + 1) % M
    mask = (assign[:, None, :] == np.arange(M)[None, :, None])
    sizes = rng.uniform(400, 700, (S, H))
    deltas = rng.normal(0, 1, (S, H, P))
    return tuple(torch.tensor(a, dtype=torch.float32, device=device)
                 for a in (mask, sizes, deltas))


@pytest.mark.cuda
@pytest.mark.parametrize("S,M,H,P,empty", [
    (1, 5, 50, 101248, ()),     # fc1 leaf of the paper CNN
    (1, 1, 5, 375, ()),         # cloud aggregation
    (1, 6, 30, 1037, (2, 5)),   # empty edges
    (3, 5, 26, 700, ()),        # S lanes
    (1, 5, 4100, 999, ()),      # H beyond one shared-memory tile
    (2, 10, 9, 33, (0,)),       # M beyond one register tile
])
def test_masked_aggregate_kernel_matches_plain(cuda, S, M, H, P, empty):
    mask, sizes, deltas = _agg_inputs(S + H, S, M, H, P, empty, cuda)
    n0 = ha.masked_aggregate_batched_cuda.launches
    got = ha.masked_aggregate_batched(mask, sizes, deltas)
    torch.cuda.synchronize()
    assert ha.masked_aggregate_batched_cuda.launches == n0 + 1
    ref = ha.masked_aggregate_batched_ref(mask, sizes, deltas)
    torch.testing.assert_close(got, ref, rtol=1e-5, atol=1e-5)
    for m in empty:
        assert bool((got[:, m] == 0).all())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.int8, torch.bfloat16,
                                   torch.float32])
@pytest.mark.parametrize("S,M,H,P,empty", [
    (1, 5, 50, 101248, ()),     # fc1 leaf, edge hop
    (1, 1, 5, 2260, ()),        # cloud hop
    (1, 6, 30, 1037, (2, 5)),   # empty edges
    (3, 10, 9, 33, (0,)),       # S lanes, M beyond one register tile
    (1, 5, 4100, 999, ()),      # H beyond one shared-memory tile
])
def test_masked_decode_aggregate_kernel_matches_plain(cuda, dtype, S, M, H,
                                                      P, empty):
    mask, sizes, deltas = _agg_inputs(S + H, S, M, H, P, empty, cuda)
    scales = torch.rand(S, H, device=cuda) * 0.02
    q = ((deltas * 40).clamp(-127, 127).round().to(dtype)
         if dtype == torch.int8 else deltas.to(dtype))
    n0 = ha.masked_decode_aggregate_batched_cuda.launches
    got = ha.masked_decode_aggregate_batched(mask, sizes, scales, q)
    torch.cuda.synchronize()
    assert ha.masked_decode_aggregate_batched_cuda.launches == n0 + 1
    ref = ha.masked_decode_aggregate_batched_ref(mask, sizes, scales, q)
    torch.testing.assert_close(got, ref, rtol=1e-5, atol=1e-5)
    for m in empty:
        assert bool((got[:, m] == 0).all())


@pytest.mark.cuda
@pytest.mark.parametrize("S,M,H,P", [(1, 5, 50, 101248), (3, 10, 9, 33),
                                     (1, 5, 4100, 999)])
def test_weighted_aggregate_kernel_matches_plain(cuda, S, M, H, P):
    mask, sizes, deltas = _agg_inputs(S + H, S, M, H, P, (), cuda)
    w = mask * sizes[:, None, :]
    w = w / w.sum(2, keepdim=True).clamp_min(1.0)
    n0 = ha.weighted_aggregate_batched_cuda.launches
    got = ha.weighted_aggregate_batched(w, deltas)
    torch.cuda.synchronize()
    assert ha.weighted_aggregate_batched_cuda.launches == n0 + 1
    torch.testing.assert_close(got, ha.weighted_aggregate_batched_ref(
        w, deltas), rtol=1e-5, atol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("N,P,K", [(100, 1640, 10), (1000, 1000, 200),
                                   (37, 130, 3)])
def test_pairwise_sq_dists_kernel_matches_plain(cuda, N, P, K):
    g = torch.Generator().manual_seed(N + K)
    x = torch.randn(N, P, generator=g).to(cuda)
    c = torch.randn(K, P, generator=g).to(cuda)
    n0 = kd.pairwise_sq_dists_cuda.launches
    got = kd.pairwise_sq_dists(x, c)
    torch.cuda.synchronize()
    assert kd.pairwise_sq_dists_cuda.launches == n0 + 1
    ref = kd.pairwise_sq_dists_ref(x, c)
    torch.testing.assert_close(got, ref, rtol=1e-5,
                               atol=1e-5 * float(ref.max()))


@pytest.mark.cuda
def test_wrappers_refuse_what_the_kernels_do_not_take(cuda):
    x = torch.zeros(4, 3, device=cuda)
    with pytest.raises(ValueError, match="float32"):
        kd.pairwise_sq_dists_cuda(x.double(), x.double())
    with pytest.raises(ValueError, match="contiguous"):
        kd.pairwise_sq_dists_cuda(torch.zeros(3, 4, device=cuda).T, x)
    with pytest.raises(ValueError, match="shape"):
        ha.masked_aggregate_batched_cuda(torch.zeros(1, 2, 3, device=cuda),
                                         torch.zeros(1, 4, device=cuda),
                                         torch.zeros(1, 3, 5, device=cuda))
    ones = (torch.ones(1, 2, 3, device=cuda), torch.ones(1, 3, device=cuda),
            torch.ones(1, 3, device=cuda))
    with pytest.raises(ValueError, match="int8, bfloat16 or float32"):
        ha.masked_decode_aggregate_batched_cuda(
            *ones, torch.ones(1, 3, 5, dtype=torch.float16, device=cuda))
    with pytest.raises(ValueError, match="contiguous"):
        ha.masked_decode_aggregate_batched_cuda(
            *ones, torch.ones(1, 5, 3, dtype=torch.int8,
                              device=cuda).transpose(1, 2))
    with pytest.raises(ValueError, match="shape"):
        ha.weighted_aggregate_batched_cuda(torch.ones(1, 2, 3, device=cuda),
                                           torch.ones(1, 4, 5, device=cuda))
