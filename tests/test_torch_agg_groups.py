"""The grouped aggregation entries (one call over every leaf of a hop)
against ``repro``'s per-leaf Pallas kernels in interpret mode, on the
same numpy inputs.

On the CPU each grouped dispatcher takes its plain version, a loop of
the per-leaf plain version; the CUDA kernel behind it is checked on a
card in ``tests/test_torch_cuda.py``. Tolerances as in
``tests/test_torch_kernels.py``: f32 products summed in another order
(BLAS vs the Pallas block loop), so rtol/atol 1e-5 for K1 and K3; K4
against the Pallas kernel at the reference's own tolerance
(``tests/test_kernels.py``: 1e-4, and 0.05 for a bf16 operand), and
against ``ref.py``'s oracle at 1e-5.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.hier_agg.hier_agg import (
    masked_aggregate_batched_pallas, masked_decode_aggregate_batched_pallas,
    weighted_aggregate_batched_pallas)
from repro.kernels.hier_agg.ref import masked_decode_aggregate_ref
from repro_torch.kernels.hier_agg import ops as ha

CNN_LEAVES = (375, 10500, 101248, 2260)      # conv1, conv2, fc1, fc2
# case -> (S, M, H, leaf widths, empty edges)
CASES = {
    "cnn leaves": (1, 5, 10, CNN_LEAVES, ()),
    "unaligned": (1, 3, 13, (257, 33), ()),
    "lanes": (3, 5, 26, (700, 64, 375), ()),
    "empty edges": (1, 6, 30, (1037, 375), (2, 5)),
}


def _group(case, seed=0):
    S, M, H, widths, empty = CASES[case]
    rng = np.random.default_rng(seed + S * M * H)
    assign = rng.integers(0, M, (S, H))
    for m in empty:
        assign[assign == m] = (m + 1) % M
    mask = (assign[:, None, :] == np.arange(M)[None, :, None]).astype(
        np.float32)
    sizes = rng.uniform(10, 700, (S, H)).astype(np.float32)
    return rng, mask, sizes, widths, empty


def _wire(rng, S, H, P, dtype):
    """Wire rows as each codec emits them (numpy f32 values, the torch
    tensor and the jax array in the wire dtype)."""
    if dtype == "int8":
        v = rng.integers(-127, 128, (S, H, P)).astype(np.float32)
        return v, torch.from_numpy(v).to(torch.int8), jnp.asarray(v, jnp.int8)
    v = rng.normal(0, 1, (S, H, P)).astype(np.float32)
    if dtype == "float32":
        v[rng.random(v.shape) > 0.05] = 0.0          # top-k keeps ~5%
        return v, torch.from_numpy(v), jnp.asarray(v)
    j = jnp.asarray(v, jnp.bfloat16)
    v = np.array(j.astype(jnp.float32))
    return v, torch.from_numpy(v).to(torch.bfloat16), j


@pytest.mark.parametrize("case", sorted(CASES))
def test_grouped_masked_aggregate_matches_pallas(case):
    rng, mask, sizes, widths, empty = _group(case)
    S, H = sizes.shape
    leaves = [rng.normal(0, 1, (S, H, P)).astype(np.float32)
              for P in widths]
    got = ha.masked_aggregate_leaves_batched(
        torch.from_numpy(mask), torch.from_numpy(sizes),
        [torch.from_numpy(x) for x in leaves])
    assert len(got) == len(leaves)
    for g, x in zip(got, leaves):
        want = np.asarray(masked_aggregate_batched_pallas(
            jnp.asarray(mask), jnp.asarray(sizes), jnp.asarray(x),
            interpret=True))
        assert g.shape == want.shape and g.dtype == torch.float32
        np.testing.assert_allclose(g.numpy(), want, rtol=1e-5, atol=1e-5)
        for m in empty:
            assert np.all(g[:, m].numpy() == 0.0)


@pytest.mark.parametrize("dtype", ["int8", "bfloat16", "float32"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_grouped_masked_decode_aggregate_matches_pallas(dtype, case):
    rng, mask, sizes, widths, empty = _group(case, seed=1)
    S, H = sizes.shape
    scales = [rng.uniform(1e-3, 2e-2, (S, H)).astype(np.float32)
              for _ in widths]
    wires = [_wire(rng, S, H, P, dtype) for P in widths]
    got = ha.masked_decode_aggregate_leaves_batched(
        torch.from_numpy(mask), torch.from_numpy(sizes),
        [torch.from_numpy(sc) for sc in scales], [w[1] for w in wires])
    tol = 0.05 if dtype == "bfloat16" else 1e-4
    for g, sc, (_, _, q_j) in zip(got, scales, wires):
        pallas = np.asarray(masked_decode_aggregate_batched_pallas(
            jnp.asarray(mask), jnp.asarray(sizes), jnp.asarray(sc), q_j,
            interpret=True))
        ref = np.stack([np.asarray(masked_decode_aggregate_ref(
            jnp.asarray(mask[s]), jnp.asarray(sizes[s]), jnp.asarray(sc[s]),
            q_j[s])) for s in range(S)])
        np.testing.assert_allclose(g.numpy(), ref, rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(g.numpy(), pallas, rtol=tol, atol=tol)
        for m in empty:
            assert np.all(g[:, m].numpy() == 0.0)


@pytest.mark.parametrize("case", ["cnn leaves", "lanes"])
def test_grouped_weighted_aggregate_matches_pallas(case):
    rng, mask, sizes, widths, _ = _group(case, seed=2)
    S, H = sizes.shape
    w = mask * sizes[:, None, :]
    w /= np.maximum(w.sum(2, keepdims=True), 1.0)
    leaves = [rng.normal(0, 1, (S, H, P)).astype(np.float32)
              for P in widths]
    got = ha.weighted_aggregate_leaves_batched(
        torch.from_numpy(w), [torch.from_numpy(x) for x in leaves])
    for g, x in zip(got, leaves):
        want = np.asarray(weighted_aggregate_batched_pallas(
            jnp.asarray(w), jnp.asarray(x), interpret=True))
        np.testing.assert_allclose(g.numpy(), want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("kernel", ["masked", "weighted", "decode"])
def test_grouped_one_leaf_is_the_per_leaf_entry(kernel):
    """The per-leaf entries are the one-leaf case of the grouped ones:
    bit for bit, batched and unbatched."""
    rng, mask, sizes, _, _ = _group("lanes", seed=3)
    S, H = sizes.shape
    mask, sizes = torch.from_numpy(mask), torch.from_numpy(sizes)
    x = torch.from_numpy(rng.normal(0, 1, (S, H, 91)).astype(np.float32))
    sc = torch.from_numpy(rng.uniform(0, 1, (S, H)).astype(np.float32))
    q = x.mul(40).round().clamp(-127, 127).to(torch.int8)
    if kernel == "masked":
        one = ha.masked_aggregate_leaves_batched(mask, sizes, [x])[0]
        per = ha.masked_aggregate_batched(mask, sizes, x)
        flat = ha.masked_aggregate_leaves(mask[1], sizes[1], [x[1]])[0]
    elif kernel == "weighted":
        one = ha.weighted_aggregate_leaves_batched(mask, [x])[0]
        per = ha.weighted_aggregate_batched(mask, x)
        flat = ha.weighted_aggregate_leaves(mask[1], [x[1]])[0]
    else:
        one = ha.masked_decode_aggregate_leaves_batched(mask, sizes, [sc],
                                                        [q])[0]
        per = ha.masked_decode_aggregate_batched(mask, sizes, sc, q)
        flat = ha.masked_decode_aggregate_leaves(mask[1], sizes[1], [sc[1]],
                                                 [q[1]])[0]
    assert torch.equal(one, per)
    assert torch.equal(flat, per[1])


def test_grouped_entries_take_empty_and_zero_width_leaves():
    mask, sizes = torch.ones(1, 2, 3), torch.ones(1, 3)
    assert ha.masked_aggregate_leaves_batched(mask, sizes, []) == []
    assert ha.masked_decode_aggregate_leaves_batched(mask, sizes, [],
                                                     []) == []
    out = ha.masked_aggregate_leaves_batched(
        mask, sizes, [torch.ones(1, 3, 0), torch.ones(1, 3, 4)])
    assert [tuple(o.shape) for o in out] == [(1, 2, 0), (1, 2, 4)]


def test_grouped_dispatchers_refuse_mixed_groups():
    mask, sizes = torch.ones(1, 2, 3), torch.ones(1, 3)
    x = torch.ones(1, 3, 4)
    with pytest.raises(ValueError, match="one device"):
        ha.masked_aggregate_leaves_batched(
            mask, sizes, [x, torch.ones(1, 3, 4, device="meta")])
    with pytest.raises(ValueError, match="scales"):
        ha.masked_decode_aggregate_leaves_batched(mask, sizes, [sizes],
                                                  [x, x])


def test_grouped_cuda_wrappers_refuse_cpu_tensors():
    """A grouped wrapper launches on CUDA tensors or raises; the shape
    and dtype checks come before the device check."""
    mask, sizes, x = torch.ones(1, 2, 3), torch.ones(1, 3), torch.ones(1, 3, 4)
    with pytest.raises(ValueError, match="CUDA"):
        ha.masked_aggregate_leaves_batched_cuda(mask, sizes, [x, x])
    with pytest.raises(ValueError, match="CUDA"):
        ha.weighted_aggregate_leaves_batched_cuda(mask, [x])
    with pytest.raises(ValueError, match="CUDA"):
        ha.masked_decode_aggregate_leaves_batched_cuda(
            mask, sizes, [sizes], [x.to(torch.int8)])
    with pytest.raises(ValueError, match="shape"):
        ha.masked_aggregate_leaves_batched_cuda(mask, sizes,
                                                [x, torch.ones(1, 4, 4)])
    with pytest.raises(ValueError, match="shape"):
        ha.masked_aggregate_leaves_batched_cuda(mask, sizes,
                                                [torch.ones(1, 3)])
    with pytest.raises(ValueError, match="int8, bfloat16 or float32"):
        ha.masked_decode_aggregate_leaves_batched_cuda(
            mask, sizes, [sizes], [x.half()])


def test_grouped_cpu_dispatch_launches_nothing():
    counters = (ha.masked_aggregate_leaves_batched_cuda,
                ha.masked_decode_aggregate_leaves_batched_cuda,
                ha.weighted_aggregate_leaves_batched_cuda)
    before = [c.launches for c in counters]
    mask, sizes, x = torch.ones(1, 2, 3), torch.ones(1, 3), torch.ones(1, 3, 4)
    ha.masked_aggregate_leaves_batched(mask, sizes, [x] * 70)
    ha.masked_decode_aggregate_leaves_batched(mask, sizes, [sizes] * 70,
                                              [x.to(torch.int8)] * 70)
    ha.weighted_aggregate_leaves_batched(mask, [x] * 70)
    assert [c.launches for c in counters] == before


@pytest.mark.parametrize("widths,S,H,sms,plan", [
    # the CNN edge hop: its strips fill the card, so 4 row groups over
    # 256-column tiles
    (CNN_LEAVES, 1, 50, 132, (4, 1, 2 + 42 + 396 + 9)),
    # the cloud hop, H = 5: each warp walks all of H over its own strip
    (CNN_LEAVES, 1, 5, 132, (1, 1, 1 + 11 + 99 + 3)),
    # conv1 alone: 8 row groups over one 128-column tile, no split
    ((375,), 1, 50, 132, (8, 1, 3)),
    # ... also at H = 5: a narrow launch keeps the fewest dependent steps
    ((375,), 1, 5, 132, (8, 1, 3)),
    # fc1 alone at H = 5 fills the card: one warp a strip
    ((101248,), 1, 5, 132, (1, 1, 99)),
    # large H over conv2: the tiles leave SMs idle, 7 blocks split H
    ((10500,), 1, 4096, 132, (8, 7, 83)),
    # ... but not on a card the tiles fill
    ((10500,), 1, 4096, 16, (4, 1, 42)),
    # never beyond the portable cluster size
    ((128,), 1, 100_000, 132, (8, 8, 1)),
    # at least MIN_ROWS rows a split
    ((300,), 3, 200, 132, (8, 3, 3)),
])
def test_launch_plan(widths, S, H, sms, plan):
    got = ha.launch_plan(widths, S, H, sms)
    assert tuple(got) == plan
    assert got.row_groups in (1, 4, ha.WARPS)
    assert 1 <= got.splits <= ha.MAX_SPLITS
    assert got.splits == 1 or (H // got.splits >= ha.MIN_ROWS
                               and got.row_groups == ha.WARPS)
