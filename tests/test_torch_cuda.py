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

The paper's assignment methods on the card against the port on the CPU
(no kernel of their own: the allocator, the accept pass and the D3QN
run as PyTorch ops): the warm allocator at 30 Adam steps to rtol 1e-4
(the CPU parity figure); HFEL ``assign_batch`` equal to per-population
``assign`` on the card (assignments equal, J to rel 1e-6, as the
reference holds it); one D3QN update wave (5 Adam steps, hidden 16) to
atol 1e-5 in the params.

The sweep: one lane-batched hop (4 lanes x the CNN's 4 leaves) against
the plain version at the 1e-5 above; ``TracedFedAvg`` and the traced
geo assignment equal to their CPU results (integer hashing and the same
f32 distances); a 2-round fused geo sweep whose device window raises on
any host synchronisation, equal to the per-round oracle; on a one-rank
NCCL group, ``SweepRunner(shard=True)`` (host loop and fused) and the
mesh train step and kernel prefill equal to their unsharded runs.

The async engine (no kernel of its own): an always-on round on the
card against the same round on the CPU from the same weights (records
to rtol 1e-5, params to atol 1e-4: the allocator and the training sum
in other orders); the event loop of a churny round, uncompressed and
int8, under ``torch.cuda.set_sync_debug_mode("error")`` between the
round's one price read and its cloud aggregation; a checkpoint round
trip of device params, bit for bit.

The model-zoo payloads and layers: K1 over every leaf of a sequence
payload's hop (the mamba2 smoke classifier: 17 leaves, widths from 16
to 65 536) against the plain version at the
1e-5 above, one launch a hop; the MoE layer (with capacity drops) and
the SSD forms on the card against the CPU, f32, atol 1e-5 (f32 sums in
another order; the routing itself must be equal; the SSD's outputs
reach ~30, so they are held to rtol 1e-5 as well); jamba-smoke's prefill
through K5 (one launch a hybrid super-block's attention layer, on the
tf32x3 path in f32) against its plain prefill, atol 1e-4 of the largest
logit.

K6, the CNN's fused conv -> ReLU -> max-pool, at the FashionMNIST and
CIFAR blocks for G = 1, 50 and 200 groups of 700 samples: y to rtol/atol
1e-5 (the kernel sums the 25*C taps in another order than cuBLAS) and
idx equal wherever a window has no near-tie (``TIE``); dW and dx from
the kernel's own idx against the plain backward from that idx, and
``vmap(grad(masked_loss))`` against the plain im2col path over samples
free of near-ties (also at fc1's ReLU), atol 1e-4 / rtol 1e-5 (the
MoE-gradient tolerance); five ``cohort_local_sgd`` steps, params atol
1e-5 (tests/test_torch_train.py's); dW the same bits on a second run;
the same comparison at G = 2 for B from 1 to 512, and the entries'
shape rule.

Flash attention: f32 to 2e-5 absolute and relative (the kernel scales q
before the dot, the plain version divides the scores: the reference's
own figure). bf16: both sides compute in f32 from the same bf16 inputs
(the kernel's tensor-core P.V takes P as two bf16 parts, ~2^-16 apart
from f32) and round the output once, so they differ by at most one
bf16 ulp of the value, 2^-7 relative, plus 1e-5 absolute for f32 noise
on outputs near zero. The kernel is forward only: under grad mode on
inputs that require grad it raises before launching, and runs under
``no_grad`` and ``inference_mode``.
"""
import numpy as np
import pytest
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core import cost_model as tcm
from repro_torch.core import resource as tra
from repro_torch.core.assignment.hfel import HFELAssigner
from repro_torch.drl.train import D3QNTrainer
from repro_torch.utils import tree_leaves, tree_map
from repro_torch.kernels.flash_attention import ops as fa
from repro_torch.kernels.hier_agg import ops as ha
from repro_torch.kernels.kmeans_dist import ops as kd
from repro_torch.models import attention as attn


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
    n0 = ha.masked_aggregate_leaves_batched_cuda.launches
    got = ha.masked_aggregate_batched(mask, sizes, deltas)
    torch.cuda.synchronize()
    assert ha.masked_aggregate_leaves_batched_cuda.launches == n0 + 1
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
    n0 = ha.masked_decode_aggregate_leaves_batched_cuda.launches
    got = ha.masked_decode_aggregate_batched(mask, sizes, scales, q)
    torch.cuda.synchronize()
    assert ha.masked_decode_aggregate_leaves_batched_cuda.launches == n0 + 1
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
    n0 = ha.weighted_aggregate_leaves_batched_cuda.launches
    got = ha.weighted_aggregate_batched(w, deltas)
    torch.cuda.synchronize()
    assert ha.weighted_aggregate_leaves_batched_cuda.launches == n0 + 1
    torch.testing.assert_close(got, ha.weighted_aggregate_batched_ref(
        w, deltas), rtol=1e-5, atol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("N,P,K", [(100, 1640, 10), (1000, 1000, 200),
                                   (37, 130, 3),
                                   (1, 1, 1),         # one of everything
                                   (3, 16385, 5)])    # many splits of P
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
def test_pairwise_sq_dists_cluster_sum_is_repeatable(cuda):
    """Rank 0 sums the cluster's partials in a fixed order: two launches
    on the same inputs give the same bits."""
    g = torch.Generator().manual_seed(5)
    x = torch.randn(100, 1640, generator=g).to(cuda)
    c = torch.randn(10, 1640, generator=g).to(cuda)
    assert kd.launch_plan(100, 10, 1640).splits > 1
    first = kd.pairwise_sq_dists(x, c)
    assert torch.equal(first, kd.pairwise_sq_dists(x, c))


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


def _wire(deltas, dtype):
    """Wire-format updates of a codec: int8 levels, bf16 or f32."""
    return ((deltas * 40).clamp(-127, 127).round().to(dtype)
            if dtype == torch.int8 else deltas.to(dtype))


def _misalign(t):
    """A copy of ``t`` whose data starts 4 bytes past an aligned address."""
    pad = 4 // t.element_size()
    return torch.cat([t.new_zeros(pad), t.flatten()])[pad:].view(t.shape)


# kernel -> (operand dtype, grouped dispatcher, plain version, counter)
GROUPED = {
    "masked": (torch.float32,
               lambda m, s, sc, x: ha.masked_aggregate_leaves_batched(m, s, x),
               lambda m, s, sc, x: ha.masked_aggregate_leaves_batched_ref(
                   m, s, x), "masked_aggregate_leaves_batched_cuda"),
    "weighted": (torch.float32,
                 lambda m, s, sc, x: ha.weighted_aggregate_leaves_batched(
                     m, x),
                 lambda m, s, sc, x: ha.weighted_aggregate_leaves_batched_ref(
                     m, x), "weighted_aggregate_leaves_batched_cuda"),
    **{f"decode-{name}": (
        dtype, ha.masked_decode_aggregate_leaves_batched,
        ha.masked_decode_aggregate_leaves_batched_ref,
        "masked_decode_aggregate_leaves_batched_cuda")
       for name, dtype in (("int8", torch.int8), ("bf16", torch.bfloat16),
                           ("f32", torch.float32))},
}
# case -> (S, M, H, leaf widths, leaves offset by 4 bytes, empty edges)
GROUP_CASES = {
    "cnn edge hop": (1, 5, 50, (375, 10500, 101248, 2260), (), ()),
    "cnn cloud hop": (1, 1, 5, (375, 10500, 101248, 2260), (), ()),
    "mixed alignment": (1, 5, 50, (256, 375, 1024, 33, 4096), (2, 4), (3,)),
    "lanes": (3, 5, 26, (700, 2260, 64), (1,), ()),
    "M=12": (1, 12, 50, (2260, 375), (), (4,)),
    "large-H": (1, 5, 4096, (10500,), (), ()),
    "beyond the table": (1, 3, 20, tuple(1 + 7 * i for i in range(70)),
                         (5,), ()),
}


def _group_inputs(kernel, case, device):
    S, M, H, widths, offset, empty = GROUP_CASES[case]
    dtype = GROUPED[kernel][0]
    mask, sizes, _ = _agg_inputs(H + len(widths), S, M, H, 1, empty, device)
    if kernel == "weighted":
        mask = mask * sizes[:, None, :]
        mask = mask / mask.sum(2, keepdim=True).clamp_min(1.0)
    g = torch.Generator().manual_seed(M + H)
    leaves = [_wire(torch.randn(S, H, P, generator=g).to(device), dtype)
              for P in widths]
    leaves = [_misalign(x) if i in offset else x
              for i, x in enumerate(leaves)]
    scales = [torch.rand(S, H, generator=g).to(device) * 0.02
              for _ in widths]
    return mask, sizes, scales, leaves


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(GROUP_CASES))
@pytest.mark.parametrize("kernel", sorted(GROUPED))
def test_grouped_kernel_matches_plain(cuda, kernel, case):
    """One launch over every leaf of a group (several past the table's
    capacity), each leaf against the per-leaf plain version."""
    mask, sizes, scales, leaves = _group_inputs(kernel, case, cuda)
    _, run, plain, counter = GROUPED[kernel]
    counter = getattr(ha, counter)
    n0 = counter.launches
    got = run(mask, sizes, scales, leaves)
    torch.cuda.synchronize()
    assert counter.launches == n0 + -(-len(leaves) // ha.LEAF_CAPACITY)
    want = plain(mask, sizes, scales, leaves)
    assert len(got) == len(leaves)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=1e-5, atol=1e-5)
        for m in GROUP_CASES[case][5]:
            assert bool((g[:, m] == 0).all())


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", ["masked", "decode-f32", "decode-int8"])
def test_grouped_cluster_split_is_repeatable(cuda, kernel):
    """At H=4096 the H split spans a thread-block cluster, summed in rank
    order: two launches on the same inputs give the same bits."""
    mask, sizes, scales, leaves = _group_inputs(kernel, "large-H", cuda)
    S, _, H, widths, _, _ = GROUP_CASES["large-H"]
    assert ha.launch_plan(widths, S, H, kd.sm_count(cuda)).splits > 1
    run = GROUPED[kernel][1]
    first = run(mask, sizes, scales, leaves)[0]
    assert torch.equal(first, run(mask, sizes, scales, leaves)[0])


@pytest.mark.cuda
def test_grouped_wrappers_refuse_mixed_groups(cuda):
    mask, sizes, scales, leaves = _group_inputs("decode-int8", "lanes", cuda)
    mixed = [leaves[0], leaves[1].to(torch.bfloat16)]
    with pytest.raises(ValueError, match="one dtype"):
        ha.masked_decode_aggregate_leaves_batched_cuda(mask, sizes,
                                                       scales[:2], mixed)
    with pytest.raises(ValueError, match="one dtype"):
        ha.masked_decode_aggregate_leaves_batched(mask, sizes, scales[:2],
                                                  mixed)
    with pytest.raises(ValueError, match="CUDA"):
        ha.masked_decode_aggregate_leaves_batched_cuda(
            mask, sizes, scales[:2], [leaves[0], leaves[1].cpu()])
    with pytest.raises(ValueError, match="one device"):
        ha.masked_decode_aggregate_leaves_batched(
            mask, sizes, scales[:2], [leaves[0], leaves[1].cpu()])
    f32 = [x.float() for x in leaves]
    with pytest.raises(ValueError, match="float32"):
        ha.masked_aggregate_leaves_batched_cuda(mask, sizes,
                                                [f32[0], leaves[1]])
    with pytest.raises(ValueError, match="CUDA"):
        ha.weighted_aggregate_leaves_batched_cuda(mask, [f32[0],
                                                         f32[1].cpu()])
    with pytest.raises(ValueError, match="scales"):
        ha.masked_decode_aggregate_leaves_batched_cuda(mask, sizes,
                                                       scales[:1], leaves)


FA_TOL = {torch.float32: dict(rtol=2e-5, atol=2e-5),
          torch.bfloat16: dict(rtol=2 ** -7, atol=1e-5)}


def _qkv(B, S, Hq, Hkv, d, dtype, device, seed=0):
    g = torch.Generator().manual_seed(seed)
    return tuple(torch.randn(B, S, h, d, generator=g).to(device, dtype)
                 for h in (Hq, Hkv, Hkv))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,S,Hq,Hkv,d,window,causal", [
    (2, 4096, 32, 2, 128, 0, True),    # chatglm3-6b prefill
    (1, 200, 4, 2, 64, 0, True),       # S not a multiple of a tile
    (1, 256, 8, 2, 64, 96, True),      # window 96, G = 4
    (1, 128, 2, 1, 80, 50, True),      # head dim 80, window 50
    (1, 200, 4, 2, 64, 8, True),       # window smaller than a key tile
    (2, 64, 8, 2, 16, 0, True),        # smoke widths: head dim 16
    (2, 64, 4, 2, 48, 0, True),        # and 48
    (2, 256, 4, 4, 32, 0, True),       # G = 1 (MHA)
    (1, 200, 4, 2, 64, 0, False),      # non-causal, ragged S
    (1, 16384, 2, 1, 128, 0, True),    # long sequence
])
def test_flash_attention_kernel_matches_plain(cuda, dtype, B, S, Hq, Hkv, d,
                                              window, causal):
    q, k, v = _qkv(B, S, Hq, Hkv, d, dtype, cuda, seed=S + d)
    path = "tf32x3" if dtype == torch.float32 else "wgmma"
    got = _launch_checked(q, k, v, path, causal=causal, window=window)
    assert got.dtype == dtype and got.shape == q.shape
    ref = fa.flash_attention_ref(q, k, v, causal=causal, window=window)
    torch.testing.assert_close(got.float(), ref.float(), **FA_TOL[dtype])


def _launch_checked(q, k, v, path, **kw):
    """One dispatcher call that must launch the kernel of ``path`` once."""
    n0 = fa.flash_attention_cuda.launches
    by0 = dict(fa.flash_attention_cuda.launches_by_path)
    got = fa.flash_attention(q, k, v, **kw)
    torch.cuda.synchronize()
    assert fa.kernel_path(q, k, v) == path
    assert fa.flash_attention_cuda.launches == n0 + 1
    by0[path] += 1
    assert fa.flash_attention_cuda.launches_by_path == by0
    return got


@pytest.mark.cuda
def test_flash_attention_kernel_refuses_grad(cuda):
    """The kernel is forward only (as the reference's is): under grad mode
    on inputs that require grad it raises before launching; under
    ``no_grad`` and ``inference_mode`` it runs."""
    q, k, v = _qkv(1, 128, 4, 2, 64, torch.bfloat16, cuda, seed=5)
    n0 = fa.flash_attention_cuda.launches
    for args in ((q.clone().requires_grad_(), k, v),
                 (q, k, v.clone().requires_grad_())):
        with pytest.raises(RuntimeError, match="no backward"):
            fa.flash_attention(*args)
        with pytest.raises(RuntimeError, match="no backward"):
            fa.flash_attention_cuda(*args)
    assert fa.flash_attention_cuda.launches == n0
    ref = fa.flash_attention_ref(q, k, v)
    with torch.no_grad():
        got = _launch_checked(q.clone().requires_grad_(), k, v, "wgmma")
    torch.testing.assert_close(got.float(), ref.float(),
                               **FA_TOL[torch.bfloat16])
    with torch.inference_mode():
        got = _launch_checked(q, k, v, "wgmma")
    torch.testing.assert_close(got.float(), ref.float(),
                               **FA_TOL[torch.bfloat16])


@pytest.mark.cuda
@pytest.mark.parametrize("B,S,Hq,Hkv,d,window,causal", [
    (1, 1, 4, 2, 128, 0, True),        # one token
    (2, 65, 8, 2, 128, 0, True),       # one past a consumer's 64 rows
    (1, 129, 4, 1, 64, 0, True),       # one past a 128-row tile
    (1, 129, 4, 2, 128, 0, False),     # and non-causal
    (1, 4095, 8, 2, 128, 0, True),     # one short of the prefill's S
    (1, 300, 4, 2, 128, 1, True),      # window 1: each row sees itself
    (1, 300, 4, 2, 80, 130, True),     # window across two key tiles
])
def test_flash_attention_wgmma_tile_edges(cuda, B, S, Hq, Hkv, d, window,
                                          causal):
    q, k, v = _qkv(B, S, Hq, Hkv, d, torch.bfloat16, cuda, seed=S + 7)
    got = _launch_checked(q, k, v, "wgmma", causal=causal, window=window)
    ref = fa.flash_attention_ref(q, k, v, causal=causal, window=window)
    torch.testing.assert_close(got.float(), ref.float(),
                               **FA_TOL[torch.bfloat16])


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["d=20", "offset"])
def test_flash_attention_unaligned_bf16_paths(cuda, layout):
    """Inputs TMA cannot read (a stride or base address off 16 bytes)
    take the wgmma kernel on copies that TMA can read, chosen by the
    layout alone."""
    if layout == "d=20":                # h stride of 40 bytes
        q, k, v = _qkv(1, 150, 4, 2, 20, torch.bfloat16, cuda, seed=11)
    else:                               # base 2 bytes past an alignment
        q, k, v = (_offset_view(t, 1) for t in _qkv(
            1, 150, 4, 2, 64, torch.bfloat16, cuda, seed=12))
    got = _launch_checked(q, k, v, "wgmma_staged", window=40)
    ref = fa.flash_attention_ref(q, k, v, window=40)
    torch.testing.assert_close(got.float(), ref.float(),
                               **FA_TOL[torch.bfloat16])


def _offset_view(t, n):
    """A copy of ``t`` whose base lies ``n`` elements past its own
    allocation's start (2n bytes past a 16-byte boundary in bf16)."""
    flat = torch.cat([t.new_zeros(n), t.flatten()])
    return flat[n:].view(t.shape)


@pytest.mark.cuda
@pytest.mark.parametrize("off", [1, 2, 3, 4, 7])
@pytest.mark.parametrize("which", ["q", "k", "v", "qkv"])
def test_flash_attention_offset_bases(cuda, which, off):
    """A base 1-7 elements past a 16-byte boundary, on q, k or v alone or
    on all three, takes the staged path, which copies only the tensors
    moved and runs the wgmma kernel on the copies: the output is bit for
    bit that of the same values at aligned bases, and within FA_TOL of
    the plain version."""
    qkv = _qkv(2, 200, 8, 2, 128, torch.bfloat16, cuda, seed=30 + off)
    moved = [_offset_view(t, off) if name in which else t
             for name, t in zip("qkv", qkv)]
    for name, t in zip("qkv", moved):
        assert t.data_ptr() % 16 == (2 * off if name in which else 0)
    got = _launch_checked(*moved, "wgmma_staged", window=130)
    want = _launch_checked(*qkv, "wgmma", window=130)
    assert torch.equal(got, want)
    ref = fa.flash_attention_ref(*qkv, window=130)
    torch.testing.assert_close(got.float(), ref.float(),
                               **FA_TOL[torch.bfloat16])


def _staged_qkv(B, S, Hq, Hkv, d, pad, seed):
    """q, k, v as the first d columns of (B, S, H, d + pad) buffers. For
    even d, pad 2 gives rows on every 4-byte boundary mod 16, pad 3 rows
    on every 2-byte one; the staged path copies them into rows padded to
    16 bytes, and TMA's zero fill then covers the pad columns."""
    return tuple(t[..., :d] for t in _qkv(B, S, Hq, Hkv, d + pad,
                                          torch.bfloat16, "cuda", seed))


@pytest.mark.cuda
@pytest.mark.parametrize("B,S,Hq,Hkv,d,window,causal", [
    (1, 1, 4, 2, 128, 0, True),        # one token
    (2, 65, 8, 2, 72, 0, True),        # one past a consumer's 64 rows
    (1, 129, 4, 1, 100, 0, True),      # one past a 128-row tile, G = 4
    (1, 129, 4, 4, 20, 0, False),      # non-causal, G = 1
    (1, 4095, 16, 1, 128, 0, True),    # one short of the prefill's S, G=16
    (1, 300, 4, 2, 128, 1, True),      # window 1: each row sees itself
    (1, 300, 4, 2, 72, 130, True),     # window across two key tiles
    (1, 300, 16, 1, 100, 130, False),  # the same, non-causal, G = 16
    (2, 129, 4, 4, 20, 1, False),      # window 1, non-causal
])
@pytest.mark.parametrize("pad", [2, 3])
def test_flash_attention_staged_tile_edges(cuda, B, S, Hq, Hkv, d, window,
                                           causal, pad):
    q, k, v = _staged_qkv(B, S, Hq, Hkv, d, pad, seed=S + d)
    got = _launch_checked(q, k, v, "wgmma_staged", causal=causal,
                          window=window)
    ref = fa.flash_attention_ref(q, k, v, causal=causal, window=window)
    torch.testing.assert_close(got.float(), ref.float(),
                               **FA_TOL[torch.bfloat16])


@pytest.mark.cuda
@pytest.mark.parametrize("d", [64, 128])
def test_flash_attention_staged_broadcast_batch(cuda, d):
    """k and v shared by the batch (b stride 0, as ``expand`` gives): the
    staged path's copies materialise the batch for TMA."""
    q, k, v = _qkv(3, 200, 8, 2, d, torch.bfloat16, cuda, seed=40 + d)
    k, v = (t[:1].expand_as(t) for t in (k, v))
    assert k.stride(0) == 0
    got = _launch_checked(q, k, v, "wgmma_staged", window=70)
    ref = fa.flash_attention_ref(q, k, v, window=70)
    torch.testing.assert_close(got.float(), ref.float(),
                               **FA_TOL[torch.bfloat16])


# the child of test_flash_attention_reads_no_byte_outside: each path on
# tensors whose first or last element is the first or last one of its own
# allocation (the caching allocator off, so an allocation is exactly its
# bytes), where a read rounded out to 16 bytes would reach past it
_MEMCHECK_CHILD = """
import torch
from repro_torch.kernels.flash_attention import ops as fa


def alloc(shape, dtype, lead=0):
    n = lead + torch.Size(shape).numel()
    return torch.randn(n, device="cuda").to(dtype)[lead:].view(shape)


bf = torch.bfloat16
cases = {
    "wgmma": [alloc((1, 130, 4, 64), bf)] + [alloc((1, 130, 2, 64), bf)] * 2,
    "wgmma_staged offsets": [alloc((1, 130, 4, 64), bf, 3),
                      alloc((1, 130, 2, 64), bf, 1),
                      alloc((1, 130, 2, 64), bf, 7)],
    "wgmma_staged": [alloc((1, 67, 3, 21), bf, 1), alloc((1, 67, 1, 21), bf),
                     alloc((1, 67, 1, 23), bf, 5)[..., :21]],
    "wgmma_staged d=128": [alloc((1, 130, 2, 131), bf)[..., 3:]]
    + [alloc((1, 130, 1, 128), bf, 1)] * 2,
    "wgmma_staged copies": [alloc((1, 67, 3, 22), bf, 2),
                            alloc((1, 67, 1, 22), bf),
                            alloc((1, 67, 1, 26), bf, 4)[..., :22]],
    "tf32x3": [alloc((1, 67, 3, 21), torch.float32, 1),
               alloc((1, 67, 1, 21), torch.float32),
               alloc((1, 67, 1, 21), torch.float32, 3)],
}
for name, (q, k, v) in cases.items():
    got = fa.flash_attention(q, k, v, window=40)
    ref = fa.flash_attention_ref(q, k, v, window=40)
    torch.cuda.synchronize()
    err = float((got.float() - ref.float()).abs().max())
    print(name, fa.kernel_path(q, k, v), err, flush=True)
    assert err < 0.05, (name, err)
print(fa.flash_attention_cuda.launches_by_path)
"""


@pytest.mark.cuda
def test_flash_attention_reads_no_byte_outside(cuda):
    """Every path under compute-sanitizer's memcheck, in a child process
    with PyTorch's caching allocator off: a read past a tensor's exact
    allocation (a load rounded out to 16 bytes across its first or last
    element) is an error there. Skips where compute-sanitizer cannot run on the card (it
    refuses some machines' devices as unsupported)."""
    import os
    import shutil
    import subprocess
    import sys
    from pathlib import Path

    from repro_torch.kernels import build
    tool = Path(build._nvcc()).with_name("compute-sanitizer")
    tool = str(tool) if tool.exists() else shutil.which("compute-sanitizer")
    assert tool, "compute-sanitizer not found beside nvcc or on PATH"
    env = dict(os.environ, PYTORCH_NO_CUDA_MEMORY_CACHING="1",
               PYTHONPATH=str(Path(__file__).resolve().parents[1] / "src"))
    memcheck = [tool, "--tool", "memcheck", "--error-exitcode", "1",
                sys.executable, "-c"]
    probe = subprocess.run(
        memcheck + ["import torch; torch.ones(1, device='cuda').sum()"],
        env=env, capture_output=True, text=True, timeout=300)
    refused = [line for line in (probe.stdout + probe.stderr).splitlines()
               if "Device not supported" in line]
    if refused:
        pytest.skip("compute-sanitizer cannot run on this machine's card: "
                    + refused[0].strip("= ")[:200])
    assert probe.returncode == 0, (probe.stdout + probe.stderr)[-3000:]
    build.build(["flash_attention"])   # the child only loads it
    run = subprocess.run(memcheck + [_MEMCHECK_CHILD], env=env,
                         capture_output=True, text=True, timeout=900)
    out = run.stdout + run.stderr
    assert run.returncode == 0, out[:3000] + out[-3000:]
    assert "ERROR SUMMARY: 0 errors" in out, out[-3000:]
    for path in fa.PATHS:
        assert f"'{path}': 0" not in out, out[-3000:]


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["d=20", "heads-major", "ragged",
                                    "offset", "s stride 18"])
def test_flash_attention_f32_layouts(cuda, layout):
    """The split-TF32 kernel on f32 layouts off its main path: d = 20 (not
    a multiple of 8: 16-byte copies zero-filled past d, the last columns
    stored one by one), a heads-major (B, H, S, d) tensor seen as
    (B, S, H, d), non-causal ragged S, and inputs that take the 4-byte
    copies (a base 4 bytes past an alignment; d = 18, an s stride of 18
    floats)."""
    kw = dict(causal=True, window=0)
    if layout == "d=20":
        q, k, v = _qkv(1, 150, 4, 2, 20, torch.float32, cuda, seed=21)
        kw["window"] = 40
    elif layout == "heads-major":
        q, k, v = (t.transpose(1, 2).contiguous().transpose(1, 2)
                   for t in _qkv(2, 130, 8, 2, 64, torch.float32, cuda,
                                 seed=22))
        assert q.stride(2) == 130 * 64
    elif layout == "ragged":
        q, k, v = _qkv(1, 131, 4, 2, 128, torch.float32, cuda, seed=23)
        kw["causal"] = False
    elif layout == "offset":
        q, k, v = (torch.cat([t.new_zeros(1), t.flatten()])[1:]
                   .view(t.shape) for t in _qkv(1, 150, 4, 2, 64,
                                                torch.float32, cuda,
                                                seed=24))
        assert k.data_ptr() % 16 == 4
    else:
        q, k, v = _qkv(1, 100, 3, 1, 18, torch.float32, cuda, seed=25)
        assert k.stride(1) == 18
    got = _launch_checked(q, k, v, "tf32x3", **kw)
    ref = fa.flash_attention_ref(q, k, v, **kw)
    torch.testing.assert_close(got, ref, **FA_TOL[torch.float32])


@pytest.mark.cuda
def test_flash_attention_reads_strided_inputs(cuda):
    """Slices of wider (B, S, H, 2d) tensors: the kernel reads the b, s and
    h strides it is given."""
    q, k, v = (t[..., :48] for t in _qkv(2, 96, 4, 2, 96, torch.bfloat16,
                                         cuda, seed=3))
    assert not q.is_contiguous() and q.stride(3) == 1
    got = _launch_checked(q, k, v, "wgmma", window=40)
    torch.testing.assert_close(
        got.float(), fa.flash_attention_ref(q, k, v, window=40).float(),
        **FA_TOL[torch.bfloat16])


@pytest.mark.cuda
def test_flash_attention_wrapper_refuses(cuda):
    q, k, v = _qkv(1, 32, 4, 2, 64, torch.float32, cuda)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        fa.flash_attention_cuda(q.half(), k.half(), v.half())
    with pytest.raises(ValueError, match="CUDA device"):
        fa.flash_attention_cuda(q, k.cpu(), v)
    with pytest.raises(ValueError, match="multiple"):
        fa.flash_attention_cuda(q[:, :, :3], k, v)
    big = _qkv(1, 32, 4, 2, 160, torch.float32, cuda)
    with pytest.raises(ValueError, match="head dim"):
        fa.flash_attention_cuda(*big)
    with pytest.raises(ValueError, match="unit stride"):
        fa.flash_attention_cuda(q, k.transpose(2, 3).contiguous()
                                .transpose(2, 3), v)
    with pytest.raises(ValueError, match="bfloat16"):
        fa.flash_attention_cuda(q, k.bfloat16(), v)


@pytest.mark.cuda
def test_attn_forward_kernel_launches_and_skips_plain(cuda, monkeypatch):
    cfg = ModelConfig("t", "dense", 2, 256, 4, 2, 512, 97, head_dim=64,
                      sliding_window=40, dtype="float32")
    g = torch.Generator(device=cuda).manual_seed(0)
    p = attn.attn_init(g, cfg, device=cuda)
    x = torch.randn(2, 128, 256, generator=g, device=cuda)
    want = attn.attn_forward(p, x, cfg, impl="plain")

    def refuse(*a, **kw):
        raise AssertionError("the plain attention ran on CUDA tensors")
    monkeypatch.setattr(fa, "flash_attention_ref", refuse)
    monkeypatch.setattr(attn, "_sdpa", refuse)
    n0 = fa.flash_attention_cuda.launches
    tf0 = fa.flash_attention_cuda.launches_by_path["tf32x3"]
    got = attn.attn_forward(p, x, cfg, impl="kernel")
    torch.cuda.synchronize()
    assert fa.flash_attention_cuda.launches == n0 + 1
    assert fa.flash_attention_cuda.launches_by_path["tf32x3"] == tf0 + 1
    torch.testing.assert_close(got, want, rtol=1e-4,
                               atol=1e-4 * float(want.abs().max()))


@pytest.mark.cuda
def test_allocate_batch_warm_card_matches_cpu(cuda):
    sp = tcm.SystemParams()
    pop = tcm.sample_population(sp, seed=0, device="cpu")
    rng = np.random.default_rng(0)
    H, M = 50, sp.n_edges
    sched = torch.from_numpy(rng.choice(sp.n_devices, H, replace=False))
    assign = torch.from_numpy(rng.integers(0, M, H))
    ins = tra.gather_edge_inputs(pop, sched, assign)
    warm = (torch.from_numpy(rng.normal(0, 1, (M, H)).astype(np.float32)),
            torch.from_numpy(rng.normal(1, 1, (M, H)).astype(np.float32)))
    for tb0, tf0 in ((torch.zeros(M, H), torch.ones(M, H)), warm):
        rc, (tbc, _) = tra.allocate_batch_warm(sp, *ins, tb0, tf0, steps=30)
        rg, (tbg, _) = tra.allocate_batch_warm(
            sp, *(x.to(cuda) for x in ins), tb0.to(cuda), tf0.to(cuda),
            steps=30)
        for f in ("b", "f", "T_edge", "E_edge", "obj"):
            torch.testing.assert_close(getattr(rg, f).cpu(), getattr(rc, f),
                                       rtol=1e-4, atol=1e-6)
        torch.testing.assert_close(tbg.cpu(), tbc, rtol=1e-4, atol=1e-4)


@pytest.mark.cuda
def test_hfel_assign_batch_matches_assign_on_card(cuda):
    sp = tcm.SystemParams(n_devices=10, n_edges=3)
    popb = tcm.sample_population_batch(sp, seeds=[11, 22, 33], device=cuda)
    sched = np.arange(1, 9)
    hfel = HFELAssigner(sp, n_transfer=12, n_exchange=16, alloc_steps=30,
                        n_candidates=4)
    A, J = hfel.assign_batch(popb, sched, [0, 1, 2])
    for e in range(3):
        a, j = hfel.assign(popb.pop(e), sched, np.random.default_rng(e))
        np.testing.assert_array_equal(A[e], a)
        assert J[e] == pytest.approx(j, rel=1e-6)


@pytest.mark.cuda
def test_d3qn_update_wave_card_matches_cpu(cuda):
    sp = tcm.SystemParams(n_devices=10, n_edges=3)
    tr = D3QNTrainer(sp, H=8, hidden=16, minibatch=16, target_sync=2,
                     seed=3, device=cuda)
    rng = np.random.default_rng(0)
    for _ in range(6):
        acts = rng.integers(0, 3, 8)
        tr.replay.push(rng.random((8, tr.feat_dim)).astype(np.float32), acts,
                       np.where(acts == 0, 1.0, -1.0))
    mbs = tr.replay.sample_updates(np.random.default_rng(7), 5, 16)

    def cpu(tree):
        return tree_map(lambda v: v.cpu() if torch.is_tensor(v) else v, tree)
    (pg, _, tg, _), lg = tr._update_wave(tr.params, tr.opt_state,
                                         tr.target_params, 0, *mbs)
    (pc, _, tc, _), lc = tr._update_wave(cpu(tr.params), cpu(tr.opt_state),
                                         cpu(tr.target_params), 0, *cpu(mbs))
    torch.testing.assert_close(lg.cpu(), lc, rtol=1e-5, atol=1e-6)
    for a, b in zip(tree_leaves(pg) + tree_leaves(tg),
                    tree_leaves(pc) + tree_leaves(tc)):
        torch.testing.assert_close(a.cpu(), b, rtol=0, atol=1e-5)


# ------------------------------------------------------------ the sweep

CNN_LEAVES = (375, 10500, 101248, 2260)


@pytest.mark.cuda
def test_lane_batched_hop_matches_plain(cuda):
    """One edge hop of a 4-lane sweep (M=5, H=50, the CNN's four leaves)
    in one launch, against the plain version."""
    mask, sizes, _ = _agg_inputs(0, 4, 5, 50, 1, (), cuda)
    leaves = [_agg_inputs(i + 1, 4, 5, 50, P, (), cuda)[2]
              for i, P in enumerate(CNN_LEAVES)]
    n0 = ha.masked_aggregate_leaves_batched_cuda.launches
    got = ha.masked_aggregate_leaves_batched(mask, sizes, leaves)
    torch.cuda.synchronize()
    assert ha.masked_aggregate_leaves_batched_cuda.launches == n0 + 1
    for g, x in zip(got, leaves):
        torch.testing.assert_close(
            g, ha.masked_aggregate_batched_ref(mask, sizes, x),
            rtol=1e-5, atol=1e-5)


@pytest.mark.cuda
def test_traced_schedule_and_geo_card_match_cpu(cuda):
    from repro_torch.core.assignment.geo import geo_assign_traced
    from repro_torch.core.scheduling import TracedFedAvg
    ts = TracedFedAvg(100, 50)
    stc, stg = ts.init_state([0, 1, 2, 3], "cpu"), ts.init_state(
        [0, 1, 2, 3], cuda)
    sp = tcm.SystemParams()
    pops = [tcm.sample_population(sp, seed=s, device="cpu")
            for s in range(4)]
    dev_pos = torch.tensor(np.stack([p.dev_pos for p in pops]),
                           dtype=torch.float32)
    edge_pos = torch.tensor(np.stack([p.edge_pos for p in pops]),
                            dtype=torch.float32)
    for _ in range(3):
        stc, sc = ts.step(stc)
        stg, sg = ts.step(stg)
        assert torch.equal(sg.cpu(), sc)
        assert torch.equal(
            geo_assign_traced(dev_pos.to(cuda), edge_pos.to(cuda), sg).cpu(),
            geo_assign_traced(dev_pos, edge_pos, sc))


@pytest.mark.cuda
def test_fused_sweep_runs_without_host_sync(cuda, monkeypatch):
    """A 2-round fused geo sweep on a small world: the whole device
    window under ``torch.cuda.set_sync_debug_mode("error")``, equal to
    the per-round oracle."""
    from repro_torch.core import sweep as tsw
    from repro_torch.data import make_dataset, partition_noniid
    sp = tcm.SystemParams(n_devices=12, n_edges=3, L=2, Q=2)
    X, y, Xt, yt = make_dataset("fmnist_syn", n_train=240, n_test=60,
                                seed=0)
    worlds = [(tcm.sample_population(sp, seed=s, device=cuda),
               partition_noniid(X, y, Xt, yt, n_devices=12,
                                size_range=(10, 16), seed=s))
              for s in range(2)]
    runner = tsw.SweepRunner(sp, worlds, lr=0.02, alloc_steps=30,
                             agg_kernel=True, device=cuda)
    real = tsw.sweep_scan
    windows = []

    def guarded(*a, **kw):
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            out = real(*a, **kw)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        windows.append(kw["n_rounds"])
        return out
    monkeypatch.setattr(tsw, "sweep_scan", guarded)

    def scheds():
        return [tsw.build_scheduler("fedavg", w[1], sp, 6, device=cuda)
                for w in worlds]
    fused = runner.run(scheds(), 2, fused=True)
    oracle = runner.run(scheds(), 2, fused="oracle")
    assert windows == [2, 1, 1]
    assert fused["n_dispatches"] == 1 and oracle["n_dispatches"] == 2
    for k in ("acc", "T_i", "E_i", "iters"):
        np.testing.assert_array_equal(fused[k], oracle[k], err_msg=k)
    assert np.isfinite(fused["acc"]).all() and (fused["T_i"] > 0).all()


@pytest.fixture
def nccl_rank(cuda, tmp_path):
    """A one-rank NCCL group (file store under tmp_path), destroyed after
    the test."""
    import torch.distributed as dist
    torch.cuda.set_device(0)
    dist.init_process_group("nccl", init_method=f"file://{tmp_path}/group",
                            rank=0, world_size=1)
    try:
        yield cuda
    finally:
        dist.destroy_process_group()


@pytest.mark.cuda
def test_lane_sharded_sweep_on_one_rank_matches_unsharded(nccl_rank):
    """``SweepRunner(shard=True)`` on a one-rank NCCL ``sweep_mesh()``:
    host loop and fused, records and params equal to ``shard=False``
    (one rank runs the same ops on the same lanes)."""
    from repro_torch.core import sweep as tsw
    from repro_torch.data import make_dataset, partition_noniid
    from repro_torch.launch.mesh import sweep_mesh
    sp = tcm.SystemParams(n_devices=12, n_edges=3, L=2, Q=2)
    X, y, Xt, yt = make_dataset("fmnist_syn", n_train=240, n_test=60,
                                seed=0)
    worlds = [(tcm.sample_population(sp, seed=s, device=nccl_rank),
               partition_noniid(X, y, Xt, yt, n_devices=12,
                                size_range=(10, 16), seed=s))
              for s in range(3)]
    kw = dict(lr=0.02, alloc_steps=30, agg_kernel=True, device=nccl_rank)
    mesh = sweep_mesh()
    for fused in (False, True):
        runs = []
        for shard in (False, True):
            runner = tsw.SweepRunner(sp, worlds, shard=shard,
                                     mesh=mesh if shard else None, **kw)
            scheds = [tsw.build_scheduler("fedavg", w[1], sp, 6, seed=s,
                                          device=nccl_rank)
                      for s, w in enumerate(worlds)]
            runs.append((runner.run(scheds, 2, fused=fused),
                         runner.params_b))
        (one, p1), (sharded, p2) = runs
        for k in ("acc", "T_i", "E_i", "iters"):
            np.testing.assert_array_equal(sharded[k], one[k], err_msg=k)
        for k in p1:
            assert torch.equal(p1[k], p2[k]), k


@pytest.mark.cuda
def test_mesh_steps_on_one_rank_match_unsharded(nccl_rank):
    """``make_train_step`` and the kernel prefill (K5 through
    ``local_map``) on a one-rank NCCL ``make_debug_mesh()`` against the
    unsharded steps, chatglm3's smoke config in f32: equal (every
    placement is ``Replicate()`` on one rank)."""
    from repro_torch.configs.registry import get_smoke_config
    from repro_torch.launch import steps as S
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.models import transformer as T
    from repro_torch.parallel import sharding as shd
    import dataclasses
    mesh = make_debug_mesh()
    cfg = dataclasses.replace(get_smoke_config("chatglm3-6b"),
                              microbatches=2)
    params = T.init(torch.Generator(device="cuda").manual_seed(0), cfg,
                    device=nccl_rank)
    tok = torch.randint(0, cfg.vocab_size, (4, 32), device=nccl_rank,
                        generator=torch.Generator(device="cuda")
                        .manual_seed(1))
    batch = {"tokens": tok, "labels": tok.roll(-1, 1)}
    step, opt = S.make_train_step(cfg, lr=1e-3)
    p1, _, m1 = step(params, opt.init(params), batch)
    mstep, mopt = S.make_train_step(cfg, mesh=mesh, lr=1e-3)
    dp = S.shard_tree(params, shd.param_shardings(params, cfg, mesh))
    p2, _, m2 = mstep(dp, mopt.init(dp), S.shard_tree(
        batch, S.input_shardings(batch, mesh)))
    assert torch.equal(m1["loss"], m2["loss"])
    for a, b in zip(tree_leaves(p1), tree_leaves(p2)):
        assert torch.equal(a, b.full_tensor())
    with torch.no_grad():
        n0 = fa.flash_attention_cuda.launches
        want = S.make_prefill_step(cfg, "kernel")(params, {"tokens": tok})
        got = S.make_prefill_step(cfg, "kernel", mesh=mesh)(
            dp, S.shard_tree({"tokens": tok}, S.input_shardings(
                {"tokens": tok}, mesh)))
        assert fa.flash_attention_cuda.launches == n0 + 2 * cfg.n_layers
    assert torch.equal(want, got.full_tensor())


# ------------------------------------------------------- the async engine

def _async_world(device):
    from repro_torch.data import make_dataset, partition_noniid
    sp = tcm.SystemParams(n_devices=10, n_edges=3, d_range=(30, 60), L=2,
                          Q=3)
    X, y, Xt, yt = make_dataset("fmnist_syn", n_train=300, n_test=120,
                                seed=0)
    return (sp, tcm.sample_population(sp, seed=0, device=device),
            partition_noniid(X, y, Xt, yt, n_devices=10,
                             size_range=(15, 25), seed=0))


@pytest.mark.cuda
def test_async_round_card_matches_cpu(cuda):
    from repro_torch.core.async_engine import AsyncConfig, AsyncHFLEngine
    kw = dict(H=6, alloc_steps=60, seed=3)
    cpu = AsyncHFLEngine(*_async_world("cpu"), AsyncConfig(device="cpu",
                                                           **kw))
    init = {k: v.numpy() for k, v in cpu.model_params.items()}
    card = AsyncHFLEngine(*_async_world(cuda), AsyncConfig(device="cuda",
                                                           **kw),
                          init_params=init)
    rc, rg = cpu.step_round(), card.step_round()
    for k in ("n_updates", "n_stale", "n_aborted", "forced_flushes",
              "msg_bits", "n_dispatches"):
        assert rg[k] == rc[k], k
    for k in ("T_i", "E_i", "t"):
        np.testing.assert_allclose(rg[k], rc[k], rtol=1e-5, err_msg=k)
    assert abs(rg["acc"] - rc["acc"]) <= 1 / 120 + 1e-12
    for k, v in cpu.model_params.items():
        np.testing.assert_allclose(card.model_params[k].cpu().numpy(),
                                   v.numpy(), rtol=0, atol=1e-4, err_msg=k)


@pytest.mark.cuda
@pytest.mark.parametrize("codec", ["none", "int8"])
def test_async_event_loop_runs_without_host_sync(cuda, monkeypatch, codec):
    """Every dispatch, toggle and flush of a churny round (stragglers,
    dropouts, 1-slot buffers) runs with host synchronisation an error:
    the mode is set once the round has read its prices and cleared
    before the cloud aggregation."""
    from repro_torch.core import async_engine as tae
    from repro_torch.core.compression import CompressionConfig
    ap = tcm.AvailabilityParams(p_offline0=0.2, mean_up_s=8.0,
                                mean_down_s=4.0, straggler_frac=0.3,
                                straggler_scale=3.0)
    trace = tcm.sample_availability(ap, 10, seed=13, max_toggles=256)
    eng = tae.AsyncHFLEngine(
        *_async_world(cuda),
        tae.AsyncConfig(H=6, alloc_steps=30, seed=6, buffer_size=1,
                        compression=CompressionConfig(codec=codec)),
        trace=trace)
    windows = []
    real_read = tae._read_prices

    def read_then_guard(*a):
        out = real_read(*a)
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        windows.append("open")
        return out

    def unguard(real):
        def call(*a, **kw):
            torch.cuda.set_sync_debug_mode(0)
            windows.append("closed")
            return real(*a, **kw)
        return call
    monkeypatch.setattr(tae, "_read_prices", read_then_guard)
    monkeypatch.setattr(tae, "_cloud_agg", unguard(tae._cloud_agg))
    monkeypatch.setattr(tae, "_cloud_agg_compressed",
                        unguard(tae._cloud_agg_compressed))
    try:
        recs = [eng.step_round(collect_eval=False) for _ in range(2)]
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert windows == ["open", "closed"] * 2
    assert sum(r["n_dispatches"] for r in recs) >= 4
    assert all(bool(torch.isfinite(v).all())
               for v in eng.model_params.values())


@pytest.mark.cuda
def test_checkpoint_round_trip_of_device_params(cuda, tmp_path):
    from repro_torch.checkpoint import ckpt
    from repro_torch.convert import params_from_numpy
    from repro_torch.models import cnn
    params = cnn.cnn_init(torch.Generator().manual_seed(0), (28, 28), 1, 10,
                          device=cuda)
    ckpt.save_pytree(params, str(tmp_path), step=5)
    back = params_from_numpy(ckpt.restore_pytree(params, str(tmp_path)),
                             cuda)
    assert ckpt.latest_step(str(tmp_path)) == 5
    for k, v in params.items():
        assert back[k].device == v.device and torch.equal(back[k], v), k


# ------------------------------------------------------- model-zoo paths

@pytest.mark.cuda
def test_seq_payload_hop_matches_plain(cuda):
    """One edge hop over every leaf of the mamba2 sequence payload (M=5,
    H=50): ceil(n/64) launches, each leaf against the plain version."""
    from repro_torch.configs.registry import get_hfl_spec
    from repro_torch.data.partition import FederatedData
    spec = get_hfl_spec("mamba2-2.7b")
    fed = FederatedData(X=[], y=[], X_test=np.zeros((1, 16), np.int32),
                        y_test=np.zeros(1, np.int32), n_classes=10,
                        majority_class=np.zeros(0, np.int64))
    params = spec.init_fn(torch.Generator().manual_seed(0), fed, cuda)
    widths = [v.numel() for v in params.values()]
    assert len(widths) == 17 and min(widths) == 16
    mask, sizes, _ = _agg_inputs(0, 1, 5, 50, 1, (), cuda)
    leaves = [_agg_inputs(i + 1, 1, 5, 50, P, (), cuda)[2]
              for i, P in enumerate(widths)]
    n0 = ha.masked_aggregate_leaves_batched_cuda.launches
    got = ha.masked_aggregate_leaves_batched(mask, sizes, leaves)
    torch.cuda.synchronize()
    assert ha.masked_aggregate_leaves_batched_cuda.launches == \
        n0 + -(-len(widths) // ha.LEAF_CAPACITY)
    for g, x in zip(got, leaves):
        torch.testing.assert_close(
            g, ha.masked_aggregate_batched_ref(mask, sizes, x),
            rtol=1e-5, atol=1e-5)


@pytest.mark.cuda
def test_moe_and_ssd_card_match_cpu(cuda):
    from repro_torch.configs.base import MoEConfig
    from repro_torch.models import mamba2 as m2
    from repro_torch.models import moe
    cfg = ModelConfig("m", "moe", 2, 64, 4, 2, 96, 97, dtype="float32",
                      moe=MoEConfig(num_experts=8, top_k=2))
    p = moe.moe_init(torch.Generator().manual_seed(0), cfg, device="cpu")
    g = torch.Generator().manual_seed(1)
    x = torch.randn(64) + 0.3 * torch.randn(2, 32, 64, generator=g)
    want, aux = moe.moe_apply(p, x, cfg)
    route = moe.moe_route(p, x.reshape(-1, 64), cfg)
    assert int((~route.keep).sum()) > 0           # capacity drops happen
    pc = tree_map(lambda v: v.to(cuda), p)
    got, aux_c = moe.moe_apply(pc, x.to(cuda), cfg)
    route_c = moe.moe_route(pc, x.to(cuda).reshape(-1, 64), cfg)
    assert torch.equal(route_c.top_idx.cpu(), route.top_idx)
    assert torch.equal(route_c.keep.cpu(), route.keep)
    torch.testing.assert_close(got.cpu(), want, rtol=0, atol=1e-5)
    torch.testing.assert_close(aux_c.cpu(), aux, rtol=1e-5, atol=0)
    B, S, H, P, G, N = 2, 64, 4, 16, 1, 8
    xs = torch.randn(B, S, H, P, generator=g)
    dt = torch.nn.functional.softplus(torch.randn(B, S, H, generator=g))
    A = -torch.rand(H, generator=g) - 0.5
    Bm, Cm = (torch.randn(B, S, G, N, generator=g) for _ in range(2))
    args = (xs, dt, A, Bm, Cm)
    card = tuple(a.to(cuda) for a in args)
    for fn in (lambda *a: m2.ssd_chunked(*a, 16), m2.ssd_reference):
        torch.testing.assert_close(fn(*card).cpu(), fn(*args), rtol=1e-5,
                                   atol=1e-5)


@pytest.mark.cuda
def test_jamba_smoke_kernel_prefill_matches_plain(cuda):
    from repro_torch.configs.registry import get_smoke_config
    from repro_torch.launch.steps import make_prefill_step
    from repro_torch.models import transformer as T
    cfg = get_smoke_config("jamba-1.5-large-398b")
    g = torch.Generator(device=cuda).manual_seed(0)
    params = T.init(g, cfg, device=cuda)
    tokens = torch.randint(0, cfg.vocab_size, (2, 64), generator=g,
                           device=cuda)
    n_attn = sum(cfg.layer_kind(i) == "attn" for i in range(cfg.n_layers))
    n0 = fa.flash_attention_cuda.launches
    got = make_prefill_step(cfg, "kernel")(params, {"tokens": tokens})
    torch.cuda.synchronize()
    assert fa.flash_attention_cuda.launches == n0 + n_attn == n0 + 2
    want = make_prefill_step(cfg, "plain")(params, {"tokens": tokens})
    torch.testing.assert_close(got, want, rtol=0,
                               atol=1e-4 * float(want.abs().max()))


# ------------------------------------------- K6 conv -> ReLU -> max-pool

# the CNN's conv blocks: (H, C, O) of the input each configuration feeds
CONV_BLOCKS = {"fmnist-conv1": (28, 1, 15), "fmnist-conv2": (12, 15, 28),
               "cifar-conv1": (32, 3, 15), "cifar-conv2": (14, 15, 28)}
CONV_B = 700                  # samples a device: the padded D_max
# a window whose top two conv outputs (or its max and 0) lie this close
# is a near-tie: the kernel's and cuBLAS's f32 sums of the 25*C taps
# differ by up to 4e-6 at outputs of ~4 (measured at the four blocks,
# G=50), so another summation order may pick another winner there
TIE = 5e-5


def _block_inputs(name, G, device, seed=0):
    H, C, O = CONV_BLOCKS[name]
    g = torch.Generator().manual_seed(seed)
    x = torch.rand((G, CONV_B, H, H, C), generator=g)
    w = torch.randn((G, 5, 5, C, O), generator=g) * (2.0 / (25 * C)) ** 0.5
    return x.to(device), w.to(device)


def _plain_groups(fn, *args, chunk=25):
    """``fn`` over the group axis in chunks of groups: the plain maths
    of 200 groups at once would hold the im2col patches of all."""
    outs = [fn(*(a[i:i + chunk] for a in args))
            for i in range(0, args[0].shape[0], chunk)]
    if isinstance(outs[0], tuple):
        return tuple(torch.cat(o) for o in zip(*outs))
    return torch.cat(outs)


def _near_ties(z):
    """(G, B, Hp, Wp, O) True at each pooling window of the conv outputs
    z (G, B, Ho, Wo, O) whose winner is within TIE of the runner-up or
    of 0."""
    G, B, Ho, Wo, O = z.shape
    win = z.reshape(G, B, Ho // 2, 2, Wo // 2, 2, O).permute(
        0, 1, 2, 4, 6, 3, 5).reshape(G, B, Ho // 2, Wo // 2, O, 4)
    top = win.topk(2, dim=-1).values
    return ((top[..., 0] - top[..., 1] < TIE) & (top[..., 0] > -TIE)) \
        | (top[..., 0].abs() < TIE)


@pytest.mark.cuda
@pytest.mark.parametrize("G", [1, 50, 200])
@pytest.mark.parametrize("name", sorted(CONV_BLOCKS))
def test_conv_pool_kernels_match_plain(cuda, name, G):
    """Forward y and idx (idx where no window has a near-tie) against the
    plain maths; dW and dx from the kernel's own idx against the plain
    backward from the same idx, at the main path's B and the round's and
    the sweep's G."""
    from repro_torch.kernels.conv_pool import ops as cp
    x, w = _block_inputs(name, G, cuda)
    n0 = (cp.conv_relu_pool_cuda.launches, cp.conv_pool_dw_cuda.launches,
          cp.conv_pool_dx_cuda.launches)
    y, idx = cp.conv_relu_pool_cuda(x, w)
    torch.cuda.synchronize()
    with torch.no_grad():
        y_ref, idx_ref = _plain_groups(cp.conv_relu_pool_groups_ref, x, w)
        z = _plain_groups(lambda a, b: torch.stack(
            [cp.im2col_conv(ag, bg) for ag, bg in zip(a, b)]), x, w)
    torch.testing.assert_close(y, y_ref, rtol=1e-5, atol=1e-5)
    clear = ~_near_ties(z)
    assert float(clear.float().mean()) > 0.99
    assert torch.equal(idx[clear], idx_ref[clear])
    dy = torch.randn(y.shape, generator=torch.Generator().manual_seed(1)
                     ).to(cuda) * 1e-3
    dw = cp.conv_pool_dw_cuda(x, dy, idx)
    dx = cp.conv_pool_dx_cuda(w, dy, idx)
    torch.cuda.synchronize()
    assert (cp.conv_relu_pool_cuda.launches, cp.conv_pool_dw_cuda.launches,
            cp.conv_pool_dx_cuda.launches) == tuple(n + 1 for n in n0)
    torch.testing.assert_close(
        dw, _plain_groups(cp.conv_pool_dw_ref, x, dy, idx), rtol=1e-5,
        atol=1e-4)
    torch.testing.assert_close(
        dx, _plain_groups(cp.conv_pool_dx_ref, w, dy, idx), rtol=1e-5,
        atol=1e-4)
    assert torch.equal(dw, cp.conv_pool_dw_cuda(x, dy, idx))  # same bits


def _cnn_cohort(which, G, device, seed=0):
    from repro_torch.models import cnn
    hw, c = {"fmnist": (28, 1), "cifar": (32, 3)}[which]
    g = torch.Generator().manual_seed(seed)
    p = cnn.cnn_init(g, (hw, hw), c, device="cpu")
    params = {k: torch.stack([v + 0.01 * torch.randn(v.shape, generator=g)
                              for _ in range(G)]).to(device)
              for k, v in p.items()}
    X = torch.rand((G, CONV_B, hw, hw, c), generator=g).to(device)
    y = torch.randint(0, 10, (G, CONV_B), generator=g).to(device)
    sizes = torch.randint(400, CONV_B + 1, (G,), generator=g)
    mask = (torch.arange(CONV_B)[None] < sizes[:, None]).float().to(device)
    return params, X, y, mask


def _untied_mask(params, X, mask):
    """``mask`` with every sample zeroed whose plain forward has a
    near-tie: in either conv block's pooling, or a pre-activation of fc1
    within TIE of ReLU's kink (an H100 run at G=50 found one there, that
    moved the device's fc1 and conv gradients by 1.4e-3 and 2e-4 while
    fc2's agreed to 4e-7; the plain path sided with float64 by chance).
    There the kernel's sums may rightly decide the other way."""
    from repro_torch.kernels.conv_pool import ops as cp
    keep = torch.ones_like(mask, dtype=torch.bool)
    with torch.no_grad():
        for i in range(0, X.shape[0], 25):
            h = X[i:i + 25]
            for name in ("conv1", "conv2"):
                w = params[name][i:i + 25]
                z = torch.stack([cp.im2col_conv(a, b)
                                 for a, b in zip(h, w)])
                keep[i:i + 25] &= ~_near_ties(z).flatten(2).any(-1)
                h = torch.stack([cp.maxpool2(torch.relu(zg)) for zg in z])
            pre = h.flatten(2) @ params["fc1"][i:i + 25]
            keep[i:i + 25] &= ~(pre.abs() < TIE).any(-1)
    return mask * keep


def _plain_path(monkeypatch):
    """The dispatcher's plain version on the card: no device is its
    kernel device."""
    from repro_torch.kernels.conv_pool import ops as cp
    monkeypatch.setattr(cp, "KERNEL_DEVICE", None)


@pytest.mark.cuda
@pytest.mark.parametrize("G", [1, 50])
@pytest.mark.parametrize("which", ["fmnist", "cifar"])
def test_conv_pool_vmap_grad_matches_plain(cuda, monkeypatch, which, G):
    """``vmap(grad(masked_loss))`` of the CNN through K6 (both blocks:
    dW of each, conv 2's dx into conv 1's dW) against the plain im2col
    path on the card, over samples free of near-ties: atol 1e-4, rtol
    1e-5."""
    from repro_torch.core.local_train import masked_loss
    from repro_torch.kernels.conv_pool import ops as cp
    from repro_torch.models import cnn
    import functools
    params, X, y, mask = _cnn_cohort(which, G, cuda)
    mask = _untied_mask(params, X, mask)
    step = torch.func.vmap(torch.func.grad(
        functools.partial(masked_loss, cnn.cnn_apply)))
    n0 = cp.conv_pool_dx_cuda.launches
    got = step(params, X, y, mask)
    torch.cuda.synchronize()
    assert cp.conv_pool_dx_cuda.launches == n0 + 1     # conv 2's input only
    _plain_path(monkeypatch)
    want = {k: torch.cat(v) for k, v in zip(params, zip(*(
        step({k: v[i:i + 25] for k, v in params.items()}, X[i:i + 25],
             y[i:i + 25], mask[i:i + 25]).values()
        for i in range(0, G, 25))))}
    for k in want:
        torch.testing.assert_close(got[k], want[k], rtol=1e-5, atol=1e-4)


@pytest.mark.cuda
def test_conv_pool_local_sgd_matches_plain(cuda, monkeypatch):
    """``cohort_local_sgd`` over L = 5 steps (H = 50 devices, D_max =
    700) through K6: in one call, every block on the kernel, none on the
    plain version, no host synchronisation; and step by step against the
    plain path, params atol 1e-5 (the tolerance of
    tests/test_torch_train.py) after the 5 steps. The steps run one call
    each because the near-tie screen (``_untied_mask``) has to read each
    step's params: a flip at a kink moves a device's params by ~1e-5."""
    from repro_torch import trace
    from repro_torch.core.local_train import cohort_local_sgd
    from repro_torch.kernels.conv_pool import ops as cp
    from repro_torch.models import cnn
    params, X, y, mask = _cnn_cohort("fmnist", 50, cuda)
    tracer = trace.Tracer(cuda)

    def refuse(*a):
        raise AssertionError("the kernel path ran the plain conv")
    monkeypatch.setattr(cp, "im2col_conv", refuse)
    torch.cuda.set_sync_debug_mode("error")
    try:
        with trace.use(tracer):
            whole = cohort_local_sgd(cnn.cnn_apply, params, X, y, mask, 5,
                                     0.01)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert tracer.counters["conv.kernel_blocks"] == 10
    assert "conv.plain_blocks" not in tracer.counters
    assert all(bool(torch.isfinite(v).all()) for v in whole.values())
    monkeypatch.undo()
    got = want = params
    for _ in range(5):
        untied = _untied_mask(want, X, mask)
        got = cohort_local_sgd(cnn.cnn_apply, got, X, y, untied, 1, 0.01)
        _plain_path(monkeypatch)
        want = cohort_local_sgd(cnn.cnn_apply, want, X, y, untied, 1, 0.01)
        monkeypatch.undo()
    for k in want:
        torch.testing.assert_close(got[k], want[k], rtol=0, atol=1e-5)


@pytest.mark.cuda
def test_conv_pool_wrappers_refuse_what_the_kernels_do_not_take(cuda):
    from repro_torch.kernels.conv_pool import ops as cp
    x, w = _block_inputs("fmnist-conv2", 1, cuda)
    y, idx = cp.conv_relu_pool_cuda(x, w)
    bad = [(cp.conv_relu_pool_cuda, (x.double(), w.double())),
           (cp.conv_relu_pool_cuda, (x.transpose(2, 3), w)),
           (cp.conv_relu_pool_cuda, (x, w.cpu())),
           (cp.conv_relu_pool_cuda, (x[..., :14], w[..., :14, :])),
           (cp.conv_pool_dw_cuda, (x, y, idx.float())),
           (cp.conv_pool_dw_cuda, (x, y.transpose(2, 3), idx)),
           (cp.conv_pool_dx_cuda, (w, y.cpu(), idx)),
           (cp.conv_pool_dx_cuda, (w, y[:, :, :3], idx[:, :, :3]))]
    for fn, args in bad:
        with pytest.raises(ValueError):
            fn(*args)


@pytest.mark.cuda
@pytest.mark.parametrize("H,W,C,w_shape,takes", [
    (28, 28, 1, (5, 5, 1, 15), True),      # fmnist conv 1
    (12, 12, 15, (5, 5, 15, 28), True),    # fmnist conv 2
    (32, 32, 3, (5, 5, 3, 15), True),      # cifar conv 1
    (14, 14, 15, (5, 5, 15, 28), True),    # cifar conv 2
    (10, 10, 1, (2, 2, 1, 10), False),     # the mini model's 2x2 conv
    (27, 27, 1, (5, 5, 1, 15), False),     # odd conv output
    (28, 27, 1, (5, 5, 1, 15), False),
    (28, 28, 2, (5, 5, 2, 15), False),     # a pair the library lacks
    (28, 28, 1, (5, 5, 1, 16), False),
    (28, 28, 1, (5, 5, 3, 15), False),     # weights of other channels
    (5, 5, 1, (5, 5, 1, 15), False),       # no conv output to pool
    (130, 130, 3, (5, 5, 3, 15), False),   # a stage beyond a block
])
def test_conv_pool_shape_rule(cuda, H, W, C, w_shape, takes):
    from repro_torch.kernels.conv_pool import ops as cp
    assert cp.kernel_takes_shapes(H, W, C, w_shape) is takes


@pytest.mark.cuda
@pytest.mark.parametrize("B", [1, 16, 33, 512])
@pytest.mark.parametrize("name", sorted(CONV_BLOCKS))
def test_conv_pool_kernels_take_any_batch(cuda, name, B):
    """The launch plan each entry makes covers any B: one sample, a
    partial stage and a partial block, against the plain maths (G = 2;
    y and idx where no window has a near-tie, dW and dx from the kernel's
    own idx), with the tolerances of ``test_conv_pool_kernels_match_plain``
    and the partial sums of dW in as many blocks as the library says."""
    from repro_torch.kernels.conv_pool import ops as cp
    x, w = _block_inputs(name, 2, cuda)
    x = x[:, :B].contiguous()
    H, C, O = CONV_BLOCKS[name]
    assert 1 <= cp._entry("conv_pool_dw_chunks")(B, H, H, C, O) <= B
    y, idx = cp.conv_relu_pool_cuda(x, w)
    y_ref, idx_ref = cp.conv_relu_pool_groups_ref(x, w)
    torch.testing.assert_close(y, y_ref, rtol=1e-5, atol=1e-5)
    z = torch.stack([cp.im2col_conv(a, b) for a, b in zip(x, w)])
    clear = ~_near_ties(z)
    assert torch.equal(idx[clear], idx_ref[clear])
    dy = torch.randn(y.shape, generator=torch.Generator().manual_seed(2)
                     ).to(cuda) * 1e-3
    torch.testing.assert_close(cp.conv_pool_dw_cuda(x, dy, idx),
                               cp.conv_pool_dw_ref(x, dy, idx), rtol=1e-5,
                               atol=1e-4)
    torch.testing.assert_close(cp.conv_pool_dx_cuda(w, dy, idx),
                               cp.conv_pool_dx_ref(w, dy, idx), rtol=1e-5,
                               atol=1e-4)


@pytest.mark.cuda
def test_conv_relu_pool_on_the_card_never_falls_back(cuda):
    """The dispatcher reads the device alone: a CUDA input the kernel
    does not take (another dtype, an odd conv output) raises instead of
    taking the plain version, and counts as a kernel block."""
    from repro_torch import trace
    from repro_torch.kernels.conv_pool import ops as cp
    x, w = _block_inputs("fmnist-conv1", 1, cuda)
    tracer = trace.Tracer(cuda)
    with trace.use(tracer):
        for args in ((x[0].double(), w[0].double()),
                     (x[0, :, :27, :27].contiguous(), w[0])):
            with pytest.raises(ValueError):
                cp.conv_relu_pool(*args)
    assert {k: v for k, v in tracer.counters.items()
            if k.startswith("conv.")} == {"conv.kernel_blocks": 2}
