"""The paper CNN's conv block, 5x5 VALID conv -> ReLU -> 2x2/2 max-pool:
plain version, CUDA kernel wrappers (K6, ``csrc/conv_pool.cu``) and the
dispatcher :func:`conv_relu_pool` that ``models.cnn.cnn_apply`` calls.

K6 replaces no TPU kernel: the reference computes the block as plain jnp
(``repro.models.cnn`` ``_conv``, an im2col stack and a matmul, and
``_maxpool2``), as :func:`im2col_conv` and :func:`maxpool2` still do
here for the plain version (``models.cnn`` takes them from here, for its
plain mini model too). The kernel never writes the im2col patches or the
pre-pool activation to device memory; see the source's header for what
bounds it and its design. The source makes each launch's plan from the
shapes alone; :func:`kernel_takes_shapes` asks it which shapes it takes.

The kernel path is three ``torch.autograd.Function``s, each on a group
axis G of independent (B, H, W, C) batches with their own weights (G is
the vmapped device axis): :class:`ConvReluPool` returns the pooled
output and ``idx``, the winning position 0..3 of each window (first
maximum in row-major order) or :data:`NONE` where the maximum is <= 0;
:class:`ConvPoolDw` and :class:`ConvPoolDx` are its backward, from the
pooled gradient and ``idx``. Its autograd rule saves only x, w and idx,
and each has a vmap rule that folds the vmapped dimension into G, so
``vmap(grad(...))`` over them is one launch a block and direction. (A
``torch.library.custom_op``'s ``register_autograd`` is refused under
``torch.func.grad``.) On the CPU the three run the plain maths (for
tests of the rules); on a CUDA tensor they launch the kernels or raise.

:func:`conv_relu_pool` dispatches on the input's device alone: a CUDA
tensor takes the kernel path (whose wrappers raise on a dtype, layout or
shape the kernels do not take), any other the plain version; it counts
each call in the current tracer's ``conv.kernel_blocks`` or
``conv.plain_blocks``.
"""
import ctypes
import functools
from typing import Tuple

import torch

from repro_torch import trace
from repro_torch.kernels import build

K = 5                                   # kernel side
NONE = 255                              # idx where the window's max <= 0
KERNEL_DEVICE = "cuda"                  # the device type that takes K6


# --------------------------------------------------------------- plain

def im2col_conv(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """VALID 2D conv via im2col + GEMM. x: (B, H, W, C), w: (kh, kw, C, O)."""
    kh, kw, ci, co = w.shape
    B, H, W, C = x.shape
    oh, ow = H - kh + 1, W - kw + 1
    patches = torch.stack([x[:, i:i + oh, j:j + ow, :]
                           for i in range(kh) for j in range(kw)], dim=3)
    return patches.reshape(B, oh, ow, kh * kw * C) @ w.reshape(kh * kw * ci,
                                                               co)


def maxpool2(x: torch.Tensor) -> torch.Tensor:
    """2x2/2 max pool via reshape (odd edges truncated, VALID)."""
    B, H, W, C = x.shape
    x = x[:, :H // 2 * 2, :W // 2 * 2, :]
    return x.reshape(B, H // 2, 2, W // 2, 2, C).amax(dim=(2, 4))


def conv_relu_pool_ref(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Plain version: x (B, H, W, C), w (k, k, C, O) -> (B, Ho//2, Wo//2,
    O), the model's im2col conv, ReLU and reshape max-pool."""
    return maxpool2(torch.relu(im2col_conv(x, w)))


def conv_relu_pool_groups_ref(x: torch.Tensor, w: torch.Tensor
                              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The forward operator's outputs by the plain maths: x (G, B, H, W,
    C), w (G, k, k, C, O) -> y (G, B, Hp, Wp, O), equal to
    :func:`conv_relu_pool_ref` of each group, and idx uint8."""
    z = torch.stack([im2col_conv(xg, wg) for xg, wg in zip(x, w)])
    G, B, Ho, Wo, O = z.shape
    win = z.reshape(G, B, Ho // 2, 2, Wo // 2, 2, O).permute(
        0, 1, 2, 4, 6, 3, 5).reshape(G, B, Ho // 2, Wo // 2, O, 4)
    best, k = win.max(dim=-1)            # the first maximum's position
    idx = torch.where(best > 0, k, NONE).to(torch.uint8)
    return torch.relu(best), idx


def dense_grad(dy: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """The conv output's gradient (G, B, 2Hp, 2Wp, O): each window's dy at
    its idx, 0 at the other three positions and wherever idx is NONE."""
    G, B, Hp, Wp, O = dy.shape
    hit = idx.long()[..., None] == torch.arange(4, device=dy.device)
    d = torch.where(hit, dy[..., None], torch.zeros((), dtype=dy.dtype,
                                                    device=dy.device))
    return d.reshape(G, B, Hp, Wp, O, 2, 2).permute(
        0, 1, 2, 5, 3, 6, 4).reshape(G, B, 2 * Hp, 2 * Wp, O)


def conv_pool_dw_ref(x: torch.Tensor, dy: torch.Tensor, idx: torch.Tensor
                     ) -> torch.Tensor:
    """The weights' gradient (G, k, k, C, O) by the plain maths: the
    vector-Jacobian product of the model's conv at the dense gradient."""
    d = dense_grad(dy, idx)
    w0 = x.new_zeros((K, K, x.shape[-1], dy.shape[-1]))
    return torch.stack([
        torch.func.vjp(functools.partial(im2col_conv, xg), w0)[1](dg)[0]
        for xg, dg in zip(x, d)])


def conv_pool_dx_ref(w: torch.Tensor, dy: torch.Tensor, idx: torch.Tensor
                     ) -> torch.Tensor:
    """The input's gradient (G, B, H, W, C) by the plain maths."""
    d = dense_grad(dy, idx)
    G, B, Ho, Wo, _ = d.shape
    x0 = w.new_zeros((B, Ho + K - 1, Wo + K - 1, w.shape[-2]))
    return torch.stack([
        torch.func.vjp(lambda xg: im2col_conv(xg, wg), x0)[1](dg)[0]
        for wg, dg in zip(w, d)])


# --------------------------------------------------------- CUDA wrappers

# pointer and int arguments of each entry before its stream
_ENTRIES = {"conv_pool_fwd_f32": (4, 6), "conv_pool_dw_f32": (5, 6),
            "conv_pool_dx_f32": (4, 6), "conv_pool_takes": (0, 4),
            "conv_pool_dw_chunks": (0, 5)}


@functools.lru_cache(maxsize=None)
def _entry(name: str):
    fn = getattr(build.library("conv_pool"), name)
    ptrs, ints = _ENTRIES[name]
    fn.argtypes = [ctypes.c_void_p] * ptrs + [ctypes.c_int] * ints + (
        [ctypes.c_void_p] if name.endswith("_f32") else [])
    fn.restype = ctypes.c_int
    return fn


def kernel_takes_shapes(H: int, W: int, C: int, w_shape) -> bool:
    """Whether the kernels take a (B, H, W, C) input and weights of
    ``w_shape``: 5x5 over C and what the library says it takes (a built
    (C, O) pair, even conv output sides, staging that fits a block)."""
    kh, kw, ci, O = w_shape
    return (kh, kw, ci) == (K, K, C) and bool(
        _entry("conv_pool_takes")(H, W, C, O))


def _check(named, dtypes, dim):
    """Raise unless every tensor of ``named`` lies on the first one's CUDA
    device, is contiguous, has its dtype of ``dtypes`` and ``dim``
    dimensions, and the grid and int sizes hold it."""
    dev = named[0][1].device
    for (label, t), dtype in zip(named, dtypes):
        if t.device.type != "cuda" or t.device != dev:
            raise ValueError(f"{label} must be on {named[0][0]}'s CUDA "
                             f"device, got {t.device}")
        if t.dtype != dtype:
            raise ValueError(f"{label} must be {dtype}, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{label} must be contiguous")
        if t.dim() != dim or t.numel() >= 2 ** 31:
            raise ValueError(f"{label}: expected {dim} dimensions below "
                             f"2**31 elements, got {tuple(t.shape)}")
    if named[0][1].shape[0] > 65535:
        raise ValueError(f"G = {named[0][1].shape[0]} groups exceed the "
                         f"grid's 65535")


def _pooled(G, B, H, W, O):
    return (G, B, (H - K + 1) // 2, (W - K + 1) // 2, O)


def _shapes_take(H, W, C, w_shape):
    if not kernel_takes_shapes(H, W, C, w_shape):
        raise ValueError(f"the kernel does not take (H, W, C) = "
                         f"{(H, W, C)} with weights {w_shape}")


def _launch(name: str, wrapper, device, *args) -> None:
    """Entry ``name`` on ``device``'s current stream; raise on a refused
    launch, else count it on ``wrapper.launches``."""
    with torch.cuda.device(device):
        err = _entry(name)(*args,
                           torch.cuda.current_stream(device).cuda_stream)
    if err:
        raise RuntimeError(f"{name} launch failed: CUDA error {err}")
    wrapper.launches += 1


def conv_relu_pool_cuda(x: torch.Tensor, w: torch.Tensor
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch the forward kernel on the current stream: contiguous f32
    CUDA x (G, B, H, W, C) and w (G, 5, 5, C, O) -> y f32 and idx uint8
    (G, B, Hp, Wp, O). Raises on anything else and on a refused launch."""
    _check((("x", x), ("w", w)), (torch.float32,) * 2, 5)
    G, B, H, W, C = x.shape
    O = w.shape[-1]
    if w.shape[0] != G:
        raise ValueError(f"w has {w.shape[0]} groups, x {G}")
    _shapes_take(H, W, C, tuple(w.shape[1:]))
    y = torch.empty(_pooled(G, B, H, W, O), dtype=torch.float32,
                    device=x.device)
    idx = torch.empty(y.shape, dtype=torch.uint8, device=x.device)
    if y.numel() == 0:
        return y, idx
    _launch("conv_pool_fwd_f32", conv_relu_pool_cuda, x.device,
            x.data_ptr(), w.data_ptr(), y.data_ptr(), idx.data_ptr(), G, B,
            H, W, C, O)
    return y, idx


conv_relu_pool_cuda.launches = 0


def _grad_inputs(dy, idx, G, B, H, W, O):
    if dy.shape != _pooled(G, B, H, W, O) or idx.shape != dy.shape:
        raise ValueError(f"dy {tuple(dy.shape)} and idx {tuple(idx.shape)} "
                         f"must be {_pooled(G, B, H, W, O)}")


def conv_pool_dw_cuda(x: torch.Tensor, dy: torch.Tensor,
                      idx: torch.Tensor) -> torch.Tensor:
    """Launch the weight-gradient kernels (per-block partials, then their
    sum in block order) on the current stream: x (G, B, H, W, C), dy f32
    and idx uint8 (G, B, Hp, Wp, O), contiguous on one CUDA device ->
    dW (G, 5, 5, C, O). Raises on anything else and on a refused
    launch."""
    _check((("x", x), ("dy", dy), ("idx", idx)),
           (torch.float32, torch.float32, torch.uint8), 5)
    G, B, H, W, C = x.shape
    O = dy.shape[-1]
    _shapes_take(H, W, C, (K, K, C, O))
    _grad_inputs(dy, idx, G, B, H, W, O)
    if G * B == 0:
        return torch.zeros((G, K, K, C, O), dtype=torch.float32,
                           device=x.device)
    dw = torch.empty((G, K, K, C, O), dtype=torch.float32, device=x.device)
    chunks = _entry("conv_pool_dw_chunks")(B, H, W, C, O)
    part = torch.empty((G, chunks, K * K * C * O), dtype=torch.float32,
                       device=x.device)
    _launch("conv_pool_dw_f32", conv_pool_dw_cuda, x.device,
            x.data_ptr(), dy.data_ptr(), idx.data_ptr(), part.data_ptr(),
            dw.data_ptr(), G, B, H, W, C, O)
    return dw


conv_pool_dw_cuda.launches = 0


def conv_pool_dx_cuda(w: torch.Tensor, dy: torch.Tensor,
                      idx: torch.Tensor) -> torch.Tensor:
    """Launch the input-gradient kernel on the current stream: w (G, 5,
    5, C, O), dy f32 and idx uint8 (G, B, Hp, Wp, O), contiguous on one
    CUDA device -> dx (G, B, 2Hp + 4, 2Wp + 4, C). Raises on anything
    else and on a refused launch."""
    _check((("w", w), ("dy", dy), ("idx", idx)),
           (torch.float32, torch.float32, torch.uint8), 5)
    G, B, Hp, Wp, O = dy.shape
    C = w.shape[3]
    H, W = 2 * Hp + K - 1, 2 * Wp + K - 1
    if w.shape[0] != G:
        raise ValueError(f"w has {w.shape[0]} groups, dy {G}")
    _shapes_take(H, W, C, tuple(w.shape[1:]))
    _grad_inputs(dy, idx, G, B, H, W, O)
    dx = torch.empty((G, B, H, W, C), dtype=torch.float32, device=w.device)
    if dx.numel() == 0:
        return dx
    _launch("conv_pool_dx_f32", conv_pool_dx_cuda, w.device,
            w.data_ptr(), dy.data_ptr(), idx.data_ptr(), dx.data_ptr(), G,
            B, H, W, C, O)
    return dx


conv_pool_dx_cuda.launches = 0


# ------------------------------------------------------------ operators

def _fold(t: torch.Tensor, dim, n: int) -> torch.Tensor:
    """The vmapped dimension ``dim`` of ``t`` (None: unbatched, so
    expanded to ``n``) moved to the front and folded into the group
    axis."""
    t = t.expand(n, *t.shape) if dim is None else t.movedim(dim, 0)
    return t.reshape(-1, *t.shape[2:])


def _unfold(t: torch.Tensor, n: int) -> torch.Tensor:
    return t.reshape(n, -1, *t.shape[1:])


class _GroupOp(torch.autograd.Function):
    """An operator over a group axis: ``impl`` (device type -> function)
    on the folded arguments; under ``vmap`` the vmapped dimension is
    folded into the group axis, so one call covers every vmapped group."""

    @classmethod
    def forward(cls, *args):
        impl = cls.impl.get(args[0].device.type, cls.impl["plain"])
        return impl(*args)

    @staticmethod
    def setup_context(ctx, inputs, output):
        pass

    @classmethod
    def vmap(cls, info, in_dims, *args):
        n = info.batch_size
        out = cls.apply(*(_fold(a, d, n) for a, d in zip(args, in_dims)))
        if isinstance(out, tuple):
            return tuple(_unfold(o, n) for o in out), (0,) * len(out)
        return _unfold(out, n), 0


def _contiguous(fn):
    return lambda *args: fn(*(a.contiguous() for a in args))


class ConvPoolDw(_GroupOp):
    """x (G, B, H, W, C), dy and idx (G, B, Hp, Wp, O) -> dW (G, 5, 5,
    C, O)."""
    impl = {"cuda": _contiguous(conv_pool_dw_cuda), "plain": conv_pool_dw_ref}


class ConvPoolDx(_GroupOp):
    """w (G, 5, 5, C, O), dy and idx (G, B, Hp, Wp, O) -> dx (G, B, H, W,
    C)."""
    impl = {"cuda": _contiguous(conv_pool_dx_cuda), "plain": conv_pool_dx_ref}


class ConvReluPool(_GroupOp):
    """x (G, B, H, W, C), w (G, 5, 5, C, O) -> (y, idx); its gradient
    saves x, w and idx and runs :class:`ConvPoolDx` (where x needs one)
    and :class:`ConvPoolDw` (where w does)."""
    impl = {"cuda": _contiguous(conv_relu_pool_cuda),
            "plain": conv_relu_pool_groups_ref}

    @staticmethod
    def setup_context(ctx, inputs, output):
        x, w = inputs
        ctx.save_for_backward(x, w, output[1])
        ctx.mark_non_differentiable(output[1])

    @staticmethod
    def backward(ctx, dy, _didx):
        x, w, idx = ctx.saved_tensors
        dx = ConvPoolDx.apply(w, dy, idx) if ctx.needs_input_grad[0] else None
        dw = ConvPoolDw.apply(x, dy, idx) if ctx.needs_input_grad[1] else None
        return dx, dw


# ----------------------------------------------------------- dispatcher

def conv_relu_pool(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x (B, H, W, C), w (k, k, C, O) -> (B, Ho//2, Wo//2, O): the
    kernel for a tensor on :data:`KERNEL_DEVICE`, the plain version
    otherwise, each call counted in the current tracer."""
    if x.device.type == KERNEL_DEVICE:
        trace.count("conv.kernel_blocks", 1)
        return ConvReluPool.apply(x[None], w[None])[0][0]
    trace.count("conv.plain_blocks", 1)
    return conv_relu_pool_ref(x, w)
