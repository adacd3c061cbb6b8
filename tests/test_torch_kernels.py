"""Port kernels (``repro_torch.kernels``) against ``repro``'s kernels.

On the CPU the dispatchers take each kernel's plain PyTorch version;
these tests hold it against ``repro``'s ``ref.py`` oracles and its
Pallas kernels in interpret mode, on the same numpy inputs. Tolerance:
f32 products summed in another order (BLAS vs XLA vs the Pallas block
loop), so a few ulps of the sum: rtol/atol 1e-5 for aggregation, and for
distances atol 1e-5 of the largest distance (the ‖x‖²+‖c‖²−2x·c form
cancels). The decode-aggregate (K4) plain version decodes exactly as
``ref.py`` does and differs from it only by the matmul's summation
order: rtol/atol 1e-5 for every wire dtype. Against the Pallas kernel in
interpret mode K4 is held to the reference's own tolerance
(``tests/test_kernels.py``: 1e-4, and 0.05 for a bf16 operand). The CUDA
kernels themselves are checked against their plain versions in
``tests/test_torch_cuda.py``, which needs a card.

The f32 flash attention kernel computes with split TF32 products; its
arithmetic is rebuilt here in PyTorch (each operand split into a TF32
head hi and the remainder lo, three products a pair; the heads rounded
as the kernel rounds them, and all to nearest) and held against the
plain version to the card's f32 tolerance, rtol/atol 2e-5, at scores
reaching ~30; one TF32 product a pair must miss that tolerance.
"""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.hier_agg.hier_agg import (
    masked_aggregate_batched_pallas, masked_decode_aggregate_batched_pallas,
    weighted_aggregate_batched_pallas)
from repro.kernels.hier_agg.ops import aggregate_pytrees as j_aggregate_pytrees
from repro.kernels.hier_agg.ref import (masked_aggregate_ref,
                                        masked_decode_aggregate_ref,
                                        weighted_aggregate_ref)
from repro.kernels.kmeans_dist.kmeans_dist import pairwise_sq_dists_pallas
from repro.kernels.kmeans_dist.ref import pairwise_sq_dists_ref
from repro_torch.kernels import build
from repro_torch.kernels.flash_attention import ops as fa
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


def _wire_q(rng, S, H, P, dtype):
    """Wire-format rows as each codec emits them: int8 levels, bf16
    deltas, or dense-masked f32 (top-k). Returns (numpy f32 values, the
    torch tensor in the wire dtype, the jax array in the wire dtype)."""
    if dtype == "int8":
        v = rng.integers(-127, 128, (S, H, P)).astype(np.float32)
        return (v, torch.from_numpy(v).to(torch.int8),
                jnp.asarray(v, jnp.int8))
    v = rng.normal(0, 1, (S, H, P)).astype(np.float32)
    if dtype == "float32":
        v[rng.random(v.shape) > 0.05] = 0.0          # top-k keeps ~5%
        return v, torch.from_numpy(v), jnp.asarray(v)
    j = jnp.asarray(v, jnp.bfloat16)                 # round once, in jax
    v = np.array(j.astype(jnp.float32))
    return v, torch.from_numpy(v).to(torch.bfloat16), j


@pytest.mark.parametrize("dtype", ["int8", "bfloat16", "float32"])
@pytest.mark.parametrize("S,M,H,P,empty", [
    (1, 5, 50, 2260, ()),       # fc2 leaf, edge hop
    (1, 1, 5, 375, ()),         # cloud hop: one row over M=5 edges
    (1, 6, 30, 1037, (2, 5)),   # empty edges -> zero rows
    (3, 10, 9, 33, (0,)),       # S lanes, M > the kernel's 8-row tile
])
def test_masked_decode_aggregate_plain_matches_reference(dtype, S, M, H, P,
                                                         empty):
    mask, sizes, _ = _agg_inputs(S + M + H + P, S, M, H, 1, empty)
    rng = np.random.default_rng(S * M + H)
    scales = rng.uniform(1e-3, 2e-2, (S, H)).astype(np.float32)
    vals, q_t, q_j = _wire_q(rng, S, H, P, dtype)
    got = ha.masked_decode_aggregate_batched(
        torch.from_numpy(mask), torch.from_numpy(sizes),
        torch.from_numpy(scales), q_t).numpy()
    assert torch.equal(q_t.float(), torch.from_numpy(vals))
    ref = np.stack([np.asarray(masked_decode_aggregate_ref(
        jnp.asarray(mask[s]), jnp.asarray(sizes[s]), jnp.asarray(scales[s]),
        q_j[s])) for s in range(S)])
    pallas = np.asarray(masked_decode_aggregate_batched_pallas(
        jnp.asarray(mask), jnp.asarray(sizes), jnp.asarray(scales), q_j,
        interpret=True))
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)
    tol = 0.05 if dtype == "bfloat16" else 1e-4
    np.testing.assert_allclose(got, pallas, rtol=tol, atol=tol)
    for m in empty:
        assert np.all(got[:, m] == 0.0)


def test_masked_decode_aggregate_unbatched_is_lane_zero():
    mask, sizes, _ = _agg_inputs(2, 1, 4, 11, 1)
    rng = np.random.default_rng(2)
    scales = torch.from_numpy(rng.uniform(0, 1, (1, 11)).astype(np.float32))
    q = torch.from_numpy(rng.integers(-127, 128, (1, 11, 50)).astype(
        np.int8))
    one = ha.masked_decode_aggregate(torch.from_numpy(mask[0]),
                                     torch.from_numpy(sizes[0]), scales[0],
                                     q[0])
    lanes = ha.masked_decode_aggregate_batched(
        torch.from_numpy(mask), torch.from_numpy(sizes), scales, q)
    assert torch.equal(one, lanes[0])


@pytest.mark.parametrize("S,M,H,P", [
    (1, 5, 50, 2260),           # an edge hop's panel over a CNN leaf
    (1, 3, 13, 257),            # unaligned M, H, P
    (3, 10, 9, 33),             # S lanes, M > 8
])
def test_weighted_aggregate_plain_matches_reference(S, M, H, P):
    rng = np.random.default_rng(S + M + H + P)
    w = rng.uniform(0, 1, (S, M, H)).astype(np.float32)
    w /= w.sum(2, keepdims=True)
    deltas = rng.normal(0, 1, (S, H, P)).astype(np.float32)
    got = ha.weighted_aggregate_batched(torch.from_numpy(w),
                                        torch.from_numpy(deltas)).numpy()
    ref = np.stack([np.asarray(weighted_aggregate_ref(
        jnp.asarray(w[s]), jnp.asarray(deltas[s]))) for s in range(S)])
    pallas = np.asarray(weighted_aggregate_batched_pallas(
        jnp.asarray(w), jnp.asarray(deltas), interpret=True))
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got, pallas, rtol=1e-5, atol=1e-5)
    one = ha.weighted_aggregate(torch.from_numpy(w[0]),
                                torch.from_numpy(deltas[0]))
    np.testing.assert_array_equal(one.numpy(), got[0])


def test_aggregate_pytrees_matches_reference():
    """(M, H) panel over a dict of (H, ...) leaves -> (M, ...) leaves in
    the leaf dtype, leaf by leaf as the reference's ``aggregate_pytrees``."""
    rng = np.random.default_rng(5)
    M, H = 3, 7
    w = rng.uniform(0, 1, (M, H)).astype(np.float32)
    params = {"conv": rng.normal(0, 1, (H, 3, 3, 1, 4)).astype(np.float32),
              "b": rng.normal(0, 1, (H, 4)).astype(np.float32)}
    got = ha.aggregate_pytrees(torch.from_numpy(w),
                               {k: torch.from_numpy(v)
                                for k, v in params.items()})
    ref = j_aggregate_pytrees(jnp.asarray(w),
                              {k: jnp.asarray(v) for k, v in params.items()},
                              interpret=True)
    for k in params:
        assert got[k].shape == (M,) + params[k].shape[1:]
        assert got[k].dtype == torch.float32
        np.testing.assert_allclose(got[k].numpy(), np.asarray(ref[k]),
                                   rtol=1e-5, atol=1e-5)


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
    ones = (torch.ones(1, 2, 3), torch.ones(1, 3), torch.ones(1, 3))
    for q in (torch.ones(1, 3, 5, dtype=torch.int8),
              torch.ones(1, 3, 5, dtype=torch.bfloat16), torch.ones(1, 3, 5)):
        with pytest.raises(ValueError, match="CUDA"):
            ha.masked_decode_aggregate_batched_cuda(*ones, q)
    for dtype in (torch.float16, torch.int32, torch.float64):
        with pytest.raises(ValueError, match="int8, bfloat16 or float32"):
            ha.masked_decode_aggregate_batched_cuda(
                *ones, torch.ones(1, 3, 5, dtype=dtype))
    with pytest.raises(ValueError, match="CUDA"):
        ha.weighted_aggregate_batched_cuda(torch.ones(1, 2, 3),
                                           torch.ones(1, 3, 5))
    with pytest.raises(ValueError, match="shape"):
        ha.weighted_aggregate_batched_cuda(torch.ones(1, 2, 3),
                                           torch.ones(1, 4, 5))


def test_cpu_dispatch_launches_nothing():
    counters = (ha.masked_aggregate_leaves_batched_cuda,
                ha.masked_decode_aggregate_leaves_batched_cuda,
                ha.weighted_aggregate_leaves_batched_cuda,
                kd.pairwise_sq_dists_cuda)
    before = [c.launches for c in counters]
    ha.masked_aggregate(torch.ones(2, 3), torch.ones(3), torch.ones(3, 4))
    ha.masked_decode_aggregate(torch.ones(2, 3), torch.ones(3),
                               torch.ones(3),
                               torch.ones(3, 4, dtype=torch.int8))
    ha.weighted_aggregate(torch.ones(2, 3), torch.ones(3, 4))
    kd.pairwise_sq_dists(torch.ones(3, 4), torch.ones(2, 4))
    assert [c.launches for c in counters] == before


# ------------------------------------- launch choices the card would make

def _zeros(shape, dtype=torch.bfloat16):
    return torch.zeros(shape, dtype=dtype)


def _off(shape, n):
    """A bf16 zero tensor of ``shape`` whose base lies ``n`` elements past
    its storage's start (a view at an odd offset: 2n bytes off 16)."""
    return _zeros((math.prod(shape) + n,))[n:].view(shape)


_PATH_CASES = {
    # name: (q, k, v builder, the kernel flash_attention_cuda launches)
    "f32": (lambda: [_zeros((1, 8, 4, 64), torch.float32)] * 3, "tf32x3"),
    "bf16 contiguous d=128": (
        lambda: [_zeros((2, 8, 4, 128)), _zeros((2, 8, 2, 128)),
                 _zeros((2, 8, 2, 128))], "wgmma"),
    "bf16 d=48 slice of d=96": (
        lambda: [_zeros((2, 8, h, 96))[..., :48] for h in (4, 2, 2)],
        "wgmma"),
    "bf16 d=16": (lambda: [_zeros((2, 8, 4, 16))] * 3, "wgmma"),
    "bf16 d=20": (lambda: [_zeros((2, 8, 4, 20))] * 3, "wgmma_staged"),
    "bf16 base off by one element": (
        lambda: [_zeros((1, 8, 2, 64))] * 2
        + [_zeros((1 * 8 * 2 * 64 + 1,))[1:].view(1, 8, 2, 64)],
        "wgmma_staged"),
    "bf16 heads-major layout": (
        lambda: [_zeros((2, 4, 8, 64)).transpose(1, 2)] * 3, "wgmma"),
    "bf16 broadcast batch": (
        lambda: [_zeros((2, 8, 2, 64)), _zeros((1, 8, 2, 64)).expand(
            2, 8, 2, 64), _zeros((2, 8, 2, 64))], "wgmma_staged"),
    "bf16 size-1 dims at any stride": (
        lambda: [_zeros((64 * 8,)).as_strided((1, 8, 1, 64), (3, 64, 5, 1))]
        * 3, "wgmma"),
    "bf16 s stride of 8 bytes": (lambda: [_zeros((1, 8, 1, 4))] * 3,
                                 "wgmma_staged"),
    "bf16 d=128 slice of d=132": (
        lambda: [_zeros((2, 8, h, 132))[..., :128] for h in (4, 2, 2)],
        "wgmma_staged"),
    "bf16 base off and d=20": (
        lambda: [_off((1, 8, 2, 20), 3)] * 3, "wgmma_staged"),
}
# a base 1-7 elements off on q, k or v alone, or on all three, strides
# that TMA reads: TMA cannot start there, the staged path copies it
for _n in range(1, 8):
    for _i, _which in enumerate("qkv"):
        _PATH_CASES[f"bf16 {_which} base off by {_n}"] = (
            lambda n=_n, i=_i: [
                _off((1, 8, 2, 64), n) if j == i else _zeros((1, 8, 2, 64))
                for j in range(3)], "wgmma_staged")
    _PATH_CASES[f"bf16 q, k, v bases off by {_n}"] = (
        lambda n=_n: [_off((2, 8, h, 128), n) for h in (4, 2, 2)],
        "wgmma_staged")


@pytest.mark.parametrize("name", sorted(_PATH_CASES))
def test_flash_attention_path_choice(name):
    """Which kernel a CUDA input takes follows from its dtype, strides
    and base addresses alone, so it is decided here on CPU tensors."""
    make, want = _PATH_CASES[name]
    assert fa.kernel_path(*make()) == want


@pytest.mark.parametrize("name", sorted(
    n for n, (_, path) in _PATH_CASES.items() if path == "wgmma_staged"))
def test_flash_attention_staged_copies(name):
    """What the ``wgmma_staged`` path hands the wgmma kernel, built here
    on CPU tensors: :func:`tma_ready` copies exactly the tensors that TMA
    cannot read, each copy holds the same values, TMA can read every
    copy (so the launch is the TMA kernel's), and the tensor map over
    each, (d, H, S, B) at its strides, lies inside the copy's own
    buffer: the kernel reads no byte outside a tensor it is given."""
    qkv = _PATH_CASES[name][0]()
    gen = torch.Generator().manual_seed(7)
    for t in qkv:                       # random values, views kept
        flat = torch.empty(0, dtype=t.dtype).set_(t.untyped_storage())
        flat.copy_(torch.randn(flat.shape, generator=gen))
    ready = [fa.tma_ready(t) for t in qkv]
    assert fa.kernel_path(*ready) == "wgmma"
    for t, r in zip(qkv, ready):
        assert (r is t) == fa.tma_reads(t)
        assert fa.tma_reads(r) and torch.equal(r, t)
        last = r.storage_offset() + sum((n - 1) * st for n, st
                                        in zip(r.shape, r.stride()))
        assert last < r.untyped_storage().nbytes() // r.element_size()


@pytest.mark.parametrize("N,K,P,sms", [
    (100, 10, 1640, 132),     # the clustering: 4 tiles, 8 splits
    (1000, 200, 1000, 132),   # 224 tiles fill the card: 1 split
    (37, 3, 130, 132),
    (1, 1, 1, 132),
    (1, 1, 16385, 132),
    (5, 2, 7, 132),
    (1, 1, 0, 132),
    (64, 600, 200, 132),      # K > 128
    (4096, 10, 1640, 132),    # 128 tiles: 2 splits
    (100, 17, 5000, 16),      # a smaller card
])
def test_pairwise_sq_dists_launch_plan(N, K, P, sms):
    plan = kd.launch_plan(N, K, P, sms)
    assert plan.col_tile == (16 if K <= 16 else 32)
    assert plan.row_tiles * kd.ROW_TILE >= N > (plan.row_tiles - 1) \
        * kd.ROW_TILE
    assert plan.col_tiles * plan.col_tile >= K > (plan.col_tiles - 1) \
        * plan.col_tile
    # the grid's x is one cluster of `splits` blocks, at most the portable 8
    assert 1 <= plan.splits <= kd.MAX_SPLITS
    if plan.splits > 1:
        assert plan.chunk * (plan.splits - 1) < P <= plan.chunk * plan.splits
    # every column of P in exactly one split, no split empty
    cover = np.zeros(P, int)
    for s in range(plan.splits):
        lo, hi = s * plan.chunk, min(P, (s + 1) * plan.chunk)
        assert hi > lo or P == 0
        cover[lo:hi] += 1
    assert np.all(cover == 1)
    tiles = plan.row_tiles * plan.col_tiles
    if tiles >= sms:
        assert plan.splits == 1
    elif P >= 2 * kd.P_STEP:
        assert plan.splits > 1
    assert plan.chunk >= min(P, kd.P_STEP) or plan.splits == 1


def test_library_path_covers_every_header(tmp_path, monkeypatch):
    """A library is keyed by its source, every csrc header that it
    includes (directly or through another header) and the flags: editing
    such a header builds anew, editing one it does not include does not."""
    monkeypatch.setattr(build, "CSRC", tmp_path)
    (tmp_path / "k.cu").write_text('#include <stdint.h>\n#include "h.cuh"\n')
    (tmp_path / "h.cuh").write_text('#include "g.cuh"\n// one\n')
    (tmp_path / "g.cuh").write_text("// one\n")
    (tmp_path / "other.cuh").write_text("// one\n")
    first = build.library_path("k")
    assert build.library_path("k") == first
    (tmp_path / "h.cuh").write_text('#include "g.cuh"\n// two\n')
    second = build.library_path("k")
    assert second != first
    (tmp_path / "g.cuh").write_text("// two\n")
    third = build.library_path("k")
    assert third not in (first, second)
    (tmp_path / "other.cuh").write_text("// two\n")
    assert build.library_path("k") == third
    (tmp_path / "k.cu").write_text('#include "h.cuh"\n// edited\n')
    assert build.library_path("k") not in (first, second, third)

# ----------------------------- the f32 attention kernel's split TF32 sums

FA_F32_TOL = dict(rtol=2e-5, atol=2e-5)   # FA_TOL[float32] of the card


def _tf32(x: torch.Tensor) -> torch.Tensor:
    """f32 rounded to TF32 (10 explicit mantissa bits): to nearest, ties
    away from zero, on the 13 low bits (``cvt.rna.tf32.f32``)."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def _tf32_trunc(x: torch.Tensor) -> torch.Tensor:
    """f32 with its 13 low mantissa bits cleared: the TF32 value that the
    tensor core reads from an f32 register."""
    return (x.contiguous().view(torch.int32) & -0x2000).view(torch.float32)


def _mm_split(a, b, head_a, head_b, tail):
    """a @ b by three TF32 products summed in f32: each operand x splits
    into hi = head(x) and lo = tail(x - hi), and a product is lo*hi +
    hi*lo + hi*hi (lo*lo dropped)."""
    ah, bh = head_a(a), head_b(b)
    al, bl = tail(a - ah), tail(b - bh)
    return al @ bh + ah @ bl + ah @ bh


# how each split rounds (the heads of Q K^T's operands, P's head, V's
# head, every remainder): "kernel" as the CUDA kernel does (heads
# truncated but V's rounded to nearest; the tensor core truncates the
# remainders), "rna" everything rounded to nearest
_SPLITS = {"kernel": (_tf32_trunc, _tf32_trunc, _tf32, _tf32_trunc),
           "rna": (_tf32, _tf32, _tf32, _tf32)}


def _attention_tf32(q, k, v, causal, window, split):
    """The kernel's f32 attention on the CPU: q scaled to log2 units in
    f32 before the dot, S = Q K^T and O = P V by split TF32 products
    (``split`` a key of ``_SPLITS``, or "single": one TF32 product of
    rounded operands), softmax by exp2 with the finite -1e30 mask, O
    divided by the row sums last."""
    B, S, Hq, d = q.shape
    G = Hq // k.shape[2]
    if split == "single":
        qk = pv = (lambda a, b: _tf32(a) @ _tf32(b))
    else:
        h_qk, h_p, h_v, tail = _SPLITS[split]
        qk = (lambda a, b: _mm_split(a, b, h_qk, h_qk, tail))
        pv = (lambda a, b: _mm_split(a, b, h_p, h_v, tail))
    qs = q * np.float32(math.log2(math.e) / math.sqrt(d))
    kr, vr = (x.repeat_interleave(G, dim=2).transpose(1, 2) for x in (k, v))
    s = qk(qs.transpose(1, 2), kr.transpose(2, 3))
    qi = torch.arange(S)[:, None]
    ki = torch.arange(S)[None, :]
    ok = torch.ones(S, S, dtype=torch.bool)
    if causal:
        ok &= ki <= qi
    if window > 0:
        ok &= ki > qi - window
    s = s.masked_fill(~ok, fa.NEG_INF)
    p = torch.exp2(s - s.amax(-1, keepdim=True))
    o = pv(p, vr) / p.sum(-1, keepdim=True)
    return o.transpose(1, 2)


def _scaled_qkv(seed, B, S, Hq, Hkv, d):
    """q and k x 3 so that scores q.k / sqrt(d) reach ~30, as in the f32
    LM oracle; v unit normal."""
    rng = np.random.default_rng(seed)
    q, k, v = (torch.from_numpy(rng.standard_normal((B, S, h, d))
                                .astype(np.float32))
               for h in (Hq, Hkv, Hkv))
    return 3 * q, 3 * k, v


@pytest.mark.parametrize("split", sorted(_SPLITS))
@pytest.mark.parametrize("d", [16, 80, 128])
@pytest.mark.parametrize("causal,window", [(True, 0), (True, 50),
                                           (False, 50)])
def test_flash_attention_split_tf32_matches_plain(d, causal, window, split):
    q, k, v = _scaled_qkv(d + window, 1, 150, 4, 2, d)
    top = float(torch.einsum("bshd,bthd->bhst", q[:, :, ::2], k).abs()
                .max()) / math.sqrt(d)
    assert top > 25
    got = _attention_tf32(q, k, v, causal, window, split)
    ref = fa.flash_attention_ref(q, k, v, causal=causal, window=window)
    torch.testing.assert_close(got, ref, **FA_F32_TOL)


def test_flash_attention_single_tf32_product_misses_f32_tolerance():
    """What the split buys: one TF32 product a pair (2^-11 of each operand)
    misses the f32 tolerance by far, so the test above guards the split."""
    q, k, v = _scaled_qkv(1, 1, 150, 4, 2, 128)
    ref = fa.flash_attention_ref(q, k, v, causal=True)
    one = _attention_tf32(q, k, v, True, 0, "single")
    three = _attention_tf32(q, k, v, True, 0, "kernel")
    err1, err3 = (float((x - ref).abs().max()) for x in (one, three))
    assert err1 > 10 * FA_F32_TOL["atol"] and err1 > 30 * err3
    with pytest.raises(AssertionError):
        torch.testing.assert_close(one, ref, **FA_F32_TOL)


def test_tf32_roundings():
    """The helpers' roundings: to nearest with ties away from zero in
    either sign, and truncation; TF32 values stay as they are; each split
    leaves a remainder below its bound."""
    ulp = 2.0 ** -10
    x = torch.tensor([1 + ulp / 2, 1 + ulp / 2 - 2 ** -23, 1 + ulp,
                      -(1 + ulp / 2), 3.0, -0.0], dtype=torch.float32)
    assert torch.equal(_tf32(x), torch.tensor(
        [1 + ulp, 1.0, 1 + ulp, -(1 + ulp), 3.0, -0.0]))
    assert torch.equal(_tf32_trunc(x), torch.tensor(
        [1.0, 1.0, 1 + ulp, -1.0, 3.0, -0.0]))
    r = torch.randn(1000)
    for head, bound in ((_tf32, 2.0 ** -21), (_tf32_trunc, 2.0 ** -20)):
        hi = head(r)
        assert torch.all((r - hi - _tf32_trunc(r - hi)).abs()
                         < bound * r.abs())
