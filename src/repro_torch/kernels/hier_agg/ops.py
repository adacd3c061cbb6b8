"""Hierarchical aggregation, eqs. (2)-(3): plain versions, CUDA kernel
wrappers and dispatchers for three kernels of ``repro.kernels.hier_agg``
(``src/repro/kernels/hier_agg/hier_agg.py``):

* K1 ``masked_aggregate`` replaces ``masked_aggregate_batched_pallas``.
  Row m is ``Σ_h mask[m,h]·sizes[h]·deltas[h] / max(Σ_h mask[m,h]·
  sizes[h], 1)``: eq. (2) per edge, and eq. (3) with ``mask=ones(1, M)``
  and ``sizes=D_{N_m}``. All-zero mask rows give zero rows.
* K3 ``weighted_aggregate`` replaces ``weighted_aggregate_batched_pallas``:
  a caller-supplied (M, H) panel times the (H, P) deltas.
  :func:`aggregate_pytrees` applies it to every leaf of a parameter dict.
* K4 ``masked_decode_aggregate`` replaces
  ``masked_decode_aggregate_batched_pallas``: K1 over the wire form of
  compressed updates, ``Σ_h mask·sizes·scales[h]·q[h] / max(Σ_h
  mask·sizes, 1)`` with q int8, bf16 or f32. The kernel folds the scales
  into its weight panel and widens q as it loads it, so the dense
  decoded matrix is never built; the dispatcher passes q in its own
  dtype for that reason.

The three are one kernel, ``csrc/hier_agg.cu`` (see its header for what
bounds it on the card and how the design answers that: H split across
the warps of a block and, for large H, across a thread-block cluster
(:func:`launch_plan`); vector loads of 4 columns a lane; the panel and
its row totals built in one pass; one launch over up to
:data:`LEAF_CAPACITY` leaves). The grouped entries
(``*_leaves_batched``) take one mask and sizes (or one weight panel) and
a list of leaves (S, H, P_i), K4 also a list of per-leaf scales (S, H),
and return the list of (S, M, P_i) outputs: one launch aggregates every
leaf of a hop, and a longer list goes out in several launches, each
counted. The per-leaf entries are the one-leaf case of the same kernel.
The lane-batched ``(S, ...)`` entries take the place of the reference's
``custom_vmap`` rules; the unbatched entries are their S=1 case. On CPU
tensors each dispatcher takes the plain version (for a group, a loop of
the per-leaf plain version); on CUDA tensors it launches the kernel or
raises.
"""
from __future__ import annotations

import ctypes
import functools
from typing import List, NamedTuple, Sequence

import torch

from repro_torch.kernels import build
from repro_torch.kernels.kmeans_dist.ops import sm_count
from repro_torch.utils import Params

LEAF_CAPACITY = 64   # leaves one launch takes (the kernel's leaf table)
WARPS = 8            # warps of a block
STRIP = 128          # operand columns of a warp: 32 lanes of 4
MAX_SPLITS = 8       # blocks of a cluster along H (the portable size)
MIN_ROWS = 64        # least rows of H a split takes: 8 for each warp
FILL_BLOCKS = 4      # blocks an SM that fill the card: about two waves

# K4's wire dtypes and the C entry of each
_DECODE_ENTRIES = {torch.float32: "masked_decode_aggregate_f32",
                   torch.bfloat16: "masked_decode_aggregate_bf16",
                   torch.int8: "masked_decode_aggregate_i8"}


class LaunchPlan(NamedTuple):
    row_groups: int  # warps of a block that split H: 1, 4 or 8
    splits: int      # blocks of a thread-block cluster that split H
    tiles: int       # column tiles of all leaves, WARPS // row_groups
    #                  strips of STRIP columns each


def launch_plan(widths: Sequence[int], S: int, H: int,
                sms: int = 132) -> LaunchPlan:
    """How one launch covers leaves of ``widths`` columns over ``S`` lanes
    and ``H`` rows on a card of ``sms`` SMs.

    The warps of a block split H into row groups: all 8 (each walks
    every 8th row of one 128-column strip, then the block sums their
    partials), which keeps the dependent steps of a narrow launch fewest.
    Where the strips alone fill the card (FILL_BLOCKS blocks an SM, as a
    wide leaf or a whole hop does), fewer partials pay better: 4 row
    groups over 2 strips a block, or, for H <= 8, where 8 would leave
    warps without a row, one warp a strip walking all of H with nothing
    to sum. Where the strips cannot fill the card, the blocks of a
    cluster split H further, into at most MAX_SPLITS ranges of at least
    MIN_ROWS rows."""
    def tiles(wh):
        cols = WARPS // wh * STRIP
        return sum(-(-P // cols) for P in widths)

    fill = FILL_BLOCKS * sms
    wh = WARPS
    if tiles(WARPS) * S >= fill:
        wh = 1 if H <= WARPS else 4
    blocks = tiles(wh) * S
    splits = 1
    if blocks < fill and wh == WARPS:
        splits = max(1, min(MAX_SPLITS, -(-fill // blocks), H // MIN_ROWS))
    return LaunchPlan(wh, splits, tiles(wh))


_PTRS = ctypes.POINTER(ctypes.c_void_p)
_INTS = ctypes.POINTER(ctypes.c_int)


@functools.lru_cache(maxsize=None)
def _entry(name: str):
    lib = build.library("hier_agg")
    if lib.hier_agg_leaf_capacity() != LEAF_CAPACITY:
        raise RuntimeError("hier_agg.cu's leaf table does not hold "
                           f"LEAF_CAPACITY={LEAF_CAPACITY} leaves")
    fn = getattr(lib, name)
    head = [ctypes.c_void_p] * (1 if name.startswith("weighted") else 2)
    arrays = [_PTRS] * (3 if name.startswith("masked_decode") else 2)
    fn.argtypes = (head + [ctypes.c_int] + arrays + [_INTS]
                   + [ctypes.c_int] * 5 + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def _launch(name: str, head, leaves: Sequence[torch.Tensor], scales,
            dtype: torch.dtype, counter) -> List[torch.Tensor]:
    """Check the f32 ``head`` tensors ((S, M, H) panel first, then sizes
    (S, H)), the (S, H, P_i) ``leaves`` of ``dtype`` and, for K4, their
    (S, H) ``scales``; allocate the (S, M, P_i) outputs and launch entry
    ``name`` on the current stream over LEAF_CAPACITY leaves at a time,
    adding each launch to ``counter.launches``. Raises on anything the
    kernel does not take and on a refused launch."""
    if not leaves:
        return []
    named = [*head.items(),
             *((f"leaf {i}", x) for i, x in enumerate(leaves)),
             *((f"scales {i}", t) for i, t in enumerate(scales or ()))]
    panel = named[0][1]
    if panel.dim() != 3:
        raise ValueError("expected an (S, M, H) panel")
    S, M, H = panel.shape
    for label, t in named[1:]:
        if (tuple(t.shape[:2]) != (S, H)
                or t.dim() != (3 if label.startswith("leaf") else 2)):
            raise ValueError(f"shape mismatch: {label} {tuple(t.shape)} "
                             f"against the panel's (S, M, H) = "
                             f"{(S, M, H)}")
    if scales is not None and len(scales) != len(leaves):
        raise ValueError(f"{len(scales)} scales for {len(leaves)} leaves")
    dev = leaves[0].device
    for label, t in named:
        if t.device.type != "cuda" or t.device != dev:
            raise ValueError(f"{label} must be a CUDA tensor on the leaves' "
                             f"device, got {t.device} (leaf 0: {dev})")
        if not t.is_contiguous():
            raise ValueError(f"{label} must be contiguous")
        want = dtype if label.startswith("leaf") else torch.float32
        if t.dtype != want:
            raise ValueError(f"{label} must be {want} (one dtype for every "
                             f"leaf of a group), got {t.dtype}")
    if S > 65535 or max(M, H, *(x.shape[2] for x in leaves)) >= 2 ** 31:
        raise ValueError(f"sizes beyond the kernel's grid: S={S}, M={M}, "
                         f"H={H}")
    outs = [torch.empty((S, M, x.shape[2]), dtype=torch.float32, device=dev)
            for x in leaves]
    live = [i for i, x in enumerate(leaves) if x.shape[2] > 0]
    if S == 0 or M == 0:
        return outs
    fn = _entry(name)
    stream = torch.cuda.current_stream(dev).cuda_stream
    for g in range(0, len(live), LEAF_CAPACITY):
        idx = live[g:g + LEAF_CAPACITY]
        n = len(idx)
        plan = launch_plan([leaves[i].shape[2] for i in idx], S, H,
                           sm_count(dev))
        if plan.tiles * plan.splits >= 2 ** 31:
            raise ValueError(f"{plan.tiles} column tiles beyond the "
                             f"kernel's grid")
        arrays = [(ctypes.c_void_p * n)(*(leaves[i].data_ptr() for i in idx)),
                  (ctypes.c_void_p * n)(*(outs[i].data_ptr() for i in idx))]
        if scales is not None:
            arrays.insert(0, (ctypes.c_void_p * n)(
                *(scales[i].data_ptr() for i in idx)))
        widths = (ctypes.c_int * n)(*(leaves[i].shape[2] for i in idx))
        with torch.cuda.device(dev):
            err = fn(*(t.data_ptr() for t in head.values()), n, *arrays,
                     widths, S, M, H, plan.splits, plan.row_groups, stream)
        if err:
            raise RuntimeError(f"{name} kernel launch failed: CUDA error "
                               f"{err}")
        counter.launches += 1
    return outs


def _one_device(leaves: Sequence[torch.Tensor]) -> torch.device:
    devices = {x.device for x in leaves}
    if len(devices) != 1:
        raise ValueError(f"the leaves of one group must share one device, "
                         f"got {sorted(map(str, devices))}")
    return devices.pop()


# ------------------------------------------------- K1 masked_aggregate

def masked_aggregate_batched_ref(mask: torch.Tensor, sizes: torch.Tensor,
                                 deltas: torch.Tensor) -> torch.Tensor:
    """Plain version. mask (S, M, H); sizes (S, H); deltas (S, H, P) ->
    (S, M, P) f32: build the normalised panel, then one batched matmul."""
    w = mask.float() * sizes.float()[:, None, :]
    w = w / torch.clamp_min(w.sum(dim=2, keepdim=True), 1.0)
    return torch.bmm(w, deltas.float())


def masked_aggregate_leaves_batched_ref(
        mask: torch.Tensor, sizes: torch.Tensor,
        leaves: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """Plain version of a group: the per-leaf plain version, leaf by
    leaf."""
    return [masked_aggregate_batched_ref(mask, sizes, x) for x in leaves]


def masked_aggregate_leaves_batched_cuda(
        mask: torch.Tensor, sizes: torch.Tensor,
        leaves: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """Launch the CUDA kernel on the current stream over every leaf.
    Takes contiguous f32 CUDA tensors of one device, mask (S, M, H),
    sizes (S, H) and leaves (S, H, P_i); raises on anything else and on
    a refused launch. One launch for up to LEAF_CAPACITY leaves."""
    return _launch("masked_aggregate_f32", {"mask": mask, "sizes": sizes},
                   leaves, None, torch.float32,
                   masked_aggregate_leaves_batched_cuda)


masked_aggregate_leaves_batched_cuda.launches = 0


def masked_aggregate_leaves_batched(
        mask: torch.Tensor, sizes: torch.Tensor,
        leaves: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """(S, M, H), (S, H), [(S, H, P_i)] -> [(S, M, P_i)] f32. CPU tensors
    take the plain version; CUDA tensors launch the kernel (inputs of any
    float type are cast to contiguous f32 first)."""
    if not leaves:
        return []
    if _one_device(leaves).type == "cpu":
        return masked_aggregate_leaves_batched_ref(mask, sizes, leaves)
    return masked_aggregate_leaves_batched_cuda(
        mask.float().contiguous(), sizes.float().contiguous(),
        [x.float().contiguous() for x in leaves])


def masked_aggregate_leaves(mask: torch.Tensor, sizes: torch.Tensor,
                            leaves: Sequence[torch.Tensor]
                            ) -> List[torch.Tensor]:
    """mask (M, H); sizes (H,); leaves [(H, P_i)] -> [(M, P_i)] f32: the
    S=1 lane of :func:`masked_aggregate_leaves_batched`."""
    return [o[0] for o in masked_aggregate_leaves_batched(
        mask[None], sizes[None], [x[None] for x in leaves])]


def masked_aggregate_batched_cuda(mask: torch.Tensor, sizes: torch.Tensor,
                                  deltas: torch.Tensor) -> torch.Tensor:
    """The one-leaf case of :func:`masked_aggregate_leaves_batched_cuda`."""
    return masked_aggregate_leaves_batched_cuda(mask, sizes, [deltas])[0]


def masked_aggregate_batched(mask: torch.Tensor, sizes: torch.Tensor,
                             deltas: torch.Tensor) -> torch.Tensor:
    """(S, M, H), (S, H), (S, H, P) -> (S, M, P) f32: the one-leaf case
    of :func:`masked_aggregate_leaves_batched`."""
    return masked_aggregate_leaves_batched(mask, sizes, [deltas])[0]


def masked_aggregate(mask: torch.Tensor, sizes: torch.Tensor,
                     deltas: torch.Tensor) -> torch.Tensor:
    """mask (M, H); sizes (H,); deltas (H, P) -> (M, P) f32: the S=1 lane
    of :func:`masked_aggregate_batched`."""
    return masked_aggregate_batched(mask[None], sizes[None], deltas[None])[0]


# ----------------------------------------- K4 masked_decode_aggregate

def masked_decode_aggregate_batched_ref(mask: torch.Tensor,
                                        sizes: torch.Tensor,
                                        scales: torch.Tensor,
                                        q: torch.Tensor) -> torch.Tensor:
    """Plain version, as the reference's oracle: decode densely
    (``q.float() * scales``), then K1's plain version. mask (S, M, H);
    sizes, scales (S, H); q (S, H, P) -> (S, M, P) f32."""
    dec = q.float() * scales.float()[..., None]
    return masked_aggregate_batched_ref(mask, sizes, dec)


def masked_decode_aggregate_leaves_batched_ref(
        mask: torch.Tensor, sizes: torch.Tensor,
        scales: Sequence[torch.Tensor],
        qs: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """Plain version of a group: the per-leaf plain version, leaf by
    leaf."""
    return [masked_decode_aggregate_batched_ref(mask, sizes, sc, q)
            for sc, q in zip(scales, qs)]


def masked_decode_aggregate_leaves_batched_cuda(
        mask: torch.Tensor, sizes: torch.Tensor,
        scales: Sequence[torch.Tensor],
        qs: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """Launch the CUDA kernel on the current stream over every leaf.
    mask (S, M, H), sizes and each leaf's scales (S, H) contiguous f32;
    the leaves q (S, H, P_i) contiguous and all of one dtype, int8,
    bfloat16 or float32, read in that dtype; all on one CUDA device.
    Raises on anything else and on a refused launch. One launch for up
    to LEAF_CAPACITY leaves."""
    if not qs:
        return []
    dtype = qs[0].dtype
    if dtype not in _DECODE_ENTRIES:
        raise ValueError(f"q must be int8, bfloat16 or float32, got {dtype}")
    return _launch(_DECODE_ENTRIES[dtype], {"mask": mask, "sizes": sizes},
                   qs, list(scales), dtype,
                   masked_decode_aggregate_leaves_batched_cuda)


masked_decode_aggregate_leaves_batched_cuda.launches = 0


def masked_decode_aggregate_leaves_batched(
        mask: torch.Tensor, sizes: torch.Tensor,
        scales: Sequence[torch.Tensor],
        qs: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """(S, M, H), (S, H), [(S, H)], [(S, H, P_i)] -> [(S, M, P_i)] f32.
    CPU tensors take the plain version; CUDA tensors launch the kernel
    (mask, sizes and scales cast to contiguous f32, q kept in its wire
    dtype)."""
    if not qs:
        return []
    if len(scales) != len(qs):
        raise ValueError(f"{len(scales)} scales for {len(qs)} leaves")
    if _one_device(qs).type == "cpu":
        return masked_decode_aggregate_leaves_batched_ref(mask, sizes,
                                                          scales, qs)
    return masked_decode_aggregate_leaves_batched_cuda(
        mask.float().contiguous(), sizes.float().contiguous(),
        [sc.float().contiguous() for sc in scales],
        [q.contiguous() for q in qs])


def masked_decode_aggregate_leaves(mask: torch.Tensor, sizes: torch.Tensor,
                                   scales: Sequence[torch.Tensor],
                                   qs: Sequence[torch.Tensor]
                                   ) -> List[torch.Tensor]:
    """mask (M, H); sizes (H,); scales [(H,)]; qs [(H, P_i)] ->
    [(M, P_i)] f32: the S=1 lane of
    :func:`masked_decode_aggregate_leaves_batched`."""
    return [o[0] for o in masked_decode_aggregate_leaves_batched(
        mask[None], sizes[None], [sc[None] for sc in scales],
        [q[None] for q in qs])]


def masked_decode_aggregate_batched_cuda(mask: torch.Tensor,
                                         sizes: torch.Tensor,
                                         scales: torch.Tensor,
                                         q: torch.Tensor) -> torch.Tensor:
    """The one-leaf case of
    :func:`masked_decode_aggregate_leaves_batched_cuda`."""
    return masked_decode_aggregate_leaves_batched_cuda(mask, sizes, [scales],
                                                       [q])[0]


def masked_decode_aggregate_batched(mask: torch.Tensor, sizes: torch.Tensor,
                                    scales: torch.Tensor,
                                    q: torch.Tensor) -> torch.Tensor:
    """(S, M, H), (S, H), (S, H), (S, H, P) -> (S, M, P) f32: the
    one-leaf case of :func:`masked_decode_aggregate_leaves_batched`."""
    return masked_decode_aggregate_leaves_batched(mask, sizes, [scales],
                                                  [q])[0]


def masked_decode_aggregate(mask: torch.Tensor, sizes: torch.Tensor,
                            scales: torch.Tensor,
                            q: torch.Tensor) -> torch.Tensor:
    """mask (M, H); sizes, scales (H,); q (H, P) -> (M, P) f32: the S=1
    lane of :func:`masked_decode_aggregate_batched`."""
    return masked_decode_aggregate_batched(mask[None], sizes[None],
                                           scales[None], q[None])[0]


# ----------------------------------------------- K3 weighted_aggregate

def weighted_aggregate_batched_ref(weights: torch.Tensor,
                                   deltas: torch.Tensor) -> torch.Tensor:
    """Plain version. weights (S, M, H) as given (rows already
    normalised by the caller); deltas (S, H, P) -> (S, M, P) f32."""
    return torch.bmm(weights.float(), deltas.float())


def weighted_aggregate_leaves_batched_ref(
        weights: torch.Tensor,
        leaves: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """Plain version of a group: the per-leaf plain version, leaf by
    leaf."""
    return [weighted_aggregate_batched_ref(weights, x) for x in leaves]


def weighted_aggregate_leaves_batched_cuda(
        weights: torch.Tensor,
        leaves: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """Launch the CUDA kernel on the current stream over every leaf.
    Takes contiguous f32 CUDA tensors of one device, weights (S, M, H)
    and leaves (S, H, P_i); raises on anything else and on a refused
    launch. One launch for up to LEAF_CAPACITY leaves."""
    return _launch("weighted_aggregate_f32", {"weights": weights}, leaves,
                   None, torch.float32, weighted_aggregate_leaves_batched_cuda)


weighted_aggregate_leaves_batched_cuda.launches = 0


def weighted_aggregate_leaves_batched(
        weights: torch.Tensor,
        leaves: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """(S, M, H), [(S, H, P_i)] -> [(S, M, P_i)] f32. CPU tensors take the
    plain version; CUDA tensors launch the kernel (inputs cast to
    contiguous f32 first)."""
    if not leaves:
        return []
    if _one_device(leaves).type == "cpu":
        return weighted_aggregate_leaves_batched_ref(weights, leaves)
    return weighted_aggregate_leaves_batched_cuda(
        weights.float().contiguous(), [x.float().contiguous() for x in leaves])


def weighted_aggregate_leaves(weights: torch.Tensor,
                              leaves: Sequence[torch.Tensor]
                              ) -> List[torch.Tensor]:
    """weights (M, H); leaves [(H, P_i)] -> [(M, P_i)] f32: the S=1 lane
    of :func:`weighted_aggregate_leaves_batched`."""
    return [o[0] for o in weighted_aggregate_leaves_batched(
        weights[None], [x[None] for x in leaves])]


def weighted_aggregate_batched_cuda(weights: torch.Tensor,
                                    deltas: torch.Tensor) -> torch.Tensor:
    """The one-leaf case of :func:`weighted_aggregate_leaves_batched_cuda`."""
    return weighted_aggregate_leaves_batched_cuda(weights, [deltas])[0]


def weighted_aggregate_batched(weights: torch.Tensor,
                               deltas: torch.Tensor) -> torch.Tensor:
    """(S, M, H), (S, H, P) -> (S, M, P) f32: the one-leaf case of
    :func:`weighted_aggregate_leaves_batched`."""
    return weighted_aggregate_leaves_batched(weights, [deltas])[0]


def weighted_aggregate(weights: torch.Tensor,
                       deltas: torch.Tensor) -> torch.Tensor:
    """weights (M, H); deltas (H, P) -> (M, P) f32: the S=1 lane of
    :func:`weighted_aggregate_batched`."""
    return weighted_aggregate_batched(weights[None], deltas[None])[0]


def aggregate_pytrees(weights: torch.Tensor, device_params: Params) -> Params:
    """weights (M, H); every leaf of ``device_params`` has a leading
    device axis H. Returns the M aggregated models, each leaf (M, ...)
    in the leaf's dtype: one grouped launch over every leaf on a card."""
    M = weights.shape[0]
    outs = weighted_aggregate_leaves(
        weights, [x.reshape(x.shape[0], -1) for x in device_params.values()])
    return {k: o.reshape((M,) + x.shape[1:]).to(x.dtype)
            for o, (k, x) in zip(outs, device_params.items())}
