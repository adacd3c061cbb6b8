"""The fused conv -> ReLU -> max-pool block (``kernels/conv_pool``) on the
CPU: its operators' autograd and vmap rules run the plain maths here, so
``vmap(grad(...))`` over them is held to ``torch.func`` over the model's
plain composition; ``cnn_apply`` takes the plain path on the CPU and
counts each block, as does every CPU input the kernel would refuse;
``mini_apply`` never reaches the operators; the plain conv and pool
against ``torch.nn.functional``.

Tolerance: the operators' forward is the plain composition itself (y
bitwise); their backward is the vector-Jacobian product of the same
im2col conv, taken per group instead of batched, so gradients agree to
f32 rounding, rtol 1e-5 / atol 1e-6 (the port's gradient tolerance in
``tests/test_torch_models.py``).
"""
import functools

import numpy as np
import pytest
import torch
from torch.func import grad, vmap

from repro_torch import trace
from repro_torch.core import local_train as tlt
from repro_torch.kernels.conv_pool import ops
from repro_torch.models import cnn
from test_torch_framework import one_torch_thread  # noqa: F401 (autouse)

TOL = dict(rtol=1e-5, atol=1e-6)
# (image side, channels) of the two configurations' inputs
INPUTS = {"fmnist": (28, 1), "cifar": (32, 3)}


def _cohort(which, G=3, B=5, seed=0):
    """G devices' CNN params (the init plus noise), B images each, labels
    and a mask with one padded row."""
    hw, c = INPUTS[which]
    g = torch.Generator().manual_seed(seed)
    p = cnn.cnn_init(g, (hw, hw), c, device="cpu")
    params = {k: torch.stack([v + 0.01 * torch.randn(v.shape, generator=g)
                              for _ in range(G)]) for k, v in p.items()}
    X = torch.rand((G, B, hw, hw, c), generator=g)
    y = torch.randint(0, 10, (G, B), generator=g)
    mask = torch.ones(G, B)
    mask[:, -1] = 0.0
    return params, X, y, mask


def _op_apply(params, x):
    """``cnn_apply`` with both blocks on the operators."""
    for name in ("conv1", "conv2"):
        x = ops.ConvReluPool.apply(x[None], params[name][None])[0][0]
    x = x.reshape(x.shape[0], -1)
    return torch.relu(x @ params["fc1"]) @ params["fc2"]


def _grads(apply_fn, params, X, y, mask):
    return vmap(grad(functools.partial(tlt.masked_loss, apply_fn)))(
        params, X, y, mask)


@pytest.mark.parametrize("which", sorted(INPUTS))
def test_operators_under_vmap_grad_equal_the_plain_composition(which):
    params, X, y, mask = _cohort(which)
    got = _grads(_op_apply, params, X, y, mask)
    want = _grads(cnn.cnn_apply, params, X, y, mask)
    for k in want:
        torch.testing.assert_close(got[k], want[k], **TOL)


def _windows(z):
    """The pooling windows (G, B, Hp, Wp, O, 4) of conv outputs z (G, B,
    Ho, Wo, O), each in row-major order."""
    G, B, Ho, Wo, O = z.shape
    return z.reshape(G, B, Ho // 2, 2, Wo // 2, 2, O).permute(
        0, 1, 2, 4, 6, 3, 5).reshape(G, B, Ho // 2, Wo // 2, O, 4)


@pytest.mark.parametrize("which", sorted(INPUTS))
def test_forward_operator_pools_like_the_model(which):
    """y is the plain block's output bit for bit; idx is each window's
    first maximum in row-major order (numpy's argmax), or NONE where the
    maximum is <= 0."""
    params, X, _, _ = _cohort(which, G=2, B=3)
    w = params["conv1"]
    y, idx = ops.ConvReluPool.apply(X, w)
    for gi in range(2):
        assert torch.equal(y[gi], ops.conv_relu_pool_ref(X[gi], w[gi]))
    win = _windows(torch.stack([ops.im2col_conv(X[gi], w[gi])
                                for gi in range(2)])).numpy()
    np.testing.assert_array_equal(
        idx.numpy(), np.where(win.max(-1) > 0, win.argmax(-1), ops.NONE))


def test_ties_go_to_the_first_maximum_and_nonpositive_windows_to_none():
    """Four equal conv outputs of 25: idx 0; four of -25: NONE and 0."""
    w = torch.ones(1, 5, 5, 1, 15)
    for sign, want_idx, want_y in ((1, 0, 25.0), (-1, ops.NONE, 0.0)):
        y, idx = ops.ConvReluPool.apply(sign * torch.ones(1, 1, 6, 6, 1), w)
        assert y.shape == (1, 1, 1, 1, 15)
        assert bool((idx == want_idx).all()) and bool((y == want_y).all())


def test_dense_grad_is_the_pool_and_relu_gradient():
    """The gradient the backward operators rebuild from (dy, idx) equals
    autograd's through ReLU and the model's reshape max-pool."""
    g = torch.Generator().manual_seed(3)
    z = torch.randn((2, 3, 8, 6, 4), generator=g, requires_grad=True)
    dy = torch.randn((2, 3, 4, 3, 4), generator=g)
    pooled = torch.stack([ops.maxpool2(torch.relu(zg)) for zg in z])
    (want,) = torch.autograd.grad(pooled, z, dy)
    best, k = _windows(z.detach()).max(-1)
    idx = torch.where(best > 0, k, ops.NONE).to(torch.uint8)
    assert torch.equal(ops.dense_grad(dy, idx), want)


def test_nested_vmap_and_unbatched_weights_fold_into_groups():
    """The vmap rules fold every vmapped dimension into the group axis:
    two nested vmaps (lanes x devices, as the sweep's eval) and weights
    shared by the vmapped inputs give each group's own result."""
    params, X, _, _ = _cohort("fmnist", G=4, B=2)
    w = params["conv1"]
    S = X.reshape(2, 2, *X.shape[1:])
    Ws = w.reshape(2, 2, *w.shape[1:])

    def block(x, w_):
        return ops.ConvReluPool.apply(x[None], w_[None])[0][0]
    got = vmap(vmap(block))(S, Ws).reshape(4, *X.shape[1:2], 12, 12, 15)
    for gi in range(4):
        assert torch.equal(got[gi], ops.conv_relu_pool_ref(X[gi], w[gi]))
    shared = vmap(block, in_dims=(0, None))(X, w[0])
    for gi in range(4):
        assert torch.equal(shared[gi], ops.conv_relu_pool_ref(X[gi], w[0]))


def _counts(fn):
    tracer = trace.Tracer("cpu")
    with trace.use(tracer):
        out = fn()
    return out, {k: v for k, v in tracer.counters.items()
                 if k.startswith("conv.")}


@pytest.mark.parametrize("which", sorted(INPUTS))
def test_cnn_apply_on_the_cpu_takes_the_plain_path(which):
    """Every CPU call takes the plain composition, as the model wrote it
    before the kernel (so the parity tests against the reference read
    the same numbers), and counts one plain block a conv block."""
    params, X, _, _ = _cohort(which, G=1, B=4)
    p = {k: v[0] for k, v in params.items()}
    got, counts = _counts(lambda: cnn.cnn_apply(p, X[0]))
    assert counts == {"conv.plain_blocks": 2}
    x = X[0]
    for name in ("conv1", "conv2"):
        x = ops.maxpool2(torch.relu(ops.im2col_conv(x, p[name])))
    x = torch.relu(x.reshape(x.shape[0], -1) @ p["fc1"]) @ p["fc2"]
    assert torch.equal(got, x)


def test_mini_apply_never_reaches_the_block(monkeypatch):
    def refuse(*a, **kw):
        raise AssertionError("mini_apply reached the conv_pool block")
    monkeypatch.setattr(ops, "conv_relu_pool", refuse)
    monkeypatch.setattr(ops.ConvReluPool, "apply", refuse)
    mini = cnn.mini_init(torch.Generator().manual_seed(0), device="cpu")
    out, counts = _counts(lambda: cnn.mini_apply(mini, torch.rand(3, 10, 10,
                                                                  1)))
    assert out.shape == (3, 10) and counts == {}


def test_the_kernel_path_trains_like_the_plain_one(monkeypatch):
    """Where the dispatcher takes the operators (forced here by making
    the CPU its kernel device: on the CPU they run the plain maths), ``cohort_local_sgd`` over L steps counts
    one kernel block a conv block and step and ends where the plain path
    does."""
    params, X, y, mask = _cohort("fmnist", G=3, B=4)
    L = 2

    def train():
        return tlt.cohort_local_sgd(cnn.cnn_apply, params, X, y, mask, L,
                                    0.05)
    want, plain = _counts(train)
    monkeypatch.setattr(ops, "KERNEL_DEVICE", "cpu")
    got, kernel = _counts(train)
    assert plain == {"conv.plain_blocks": 2 * L}
    assert kernel == {"conv.kernel_blocks": 2 * L}
    for k in want:
        torch.testing.assert_close(got[k], want[k], **TOL)


@pytest.mark.parametrize("x_shape,w_shape,dtype", [
    ((2, 28, 28, 1), (5, 5, 1, 15), torch.float64),   # another dtype
    ((2, 27, 27, 1), (5, 5, 1, 15), torch.float32),   # odd conv output
    ((2, 28, 28, 2), (5, 5, 2, 15), torch.float32),   # a pair K6 lacks
    ((2, 10, 10, 1), (2, 2, 1, 10), torch.float32),   # the mini's 2x2 conv
])
def test_cpu_input_takes_the_plain_path_in_any_shape(x_shape, w_shape,
                                                     dtype):
    """The dispatcher reads the device alone: a CPU input of a shape or
    dtype the kernel would refuse takes the plain version too, and is
    counted as a plain block."""
    g = torch.Generator().manual_seed(4)
    x = torch.rand(x_shape, generator=g, dtype=dtype)
    w = torch.randn(w_shape, generator=g, dtype=dtype)
    got, counts = _counts(lambda: ops.conv_relu_pool(x, w))
    assert counts == {"conv.plain_blocks": 1}
    assert torch.equal(got, ops.conv_relu_pool_ref(x, w))


def test_cpu_tensors_never_take_the_kernel():
    x = torch.zeros(2, 28, 28, 1)
    w = torch.zeros(5, 5, 1, 15)
    dy = torch.zeros(1, 2, 12, 12, 15)
    idx = torch.zeros(1, 2, 12, 12, 15, dtype=torch.uint8)
    for call in (lambda: ops.conv_relu_pool_cuda(x[None], w[None]),
                 lambda: ops.conv_pool_dw_cuda(x[None], dy, idx),
                 lambda: ops.conv_pool_dx_cuda(w[None], dy, idx)):
        with pytest.raises(ValueError, match="CUDA"):
            call()


@pytest.mark.parametrize("B,H,W,C,O,k", [
    (3, 28, 28, 1, 15, 5),      # fmnist conv 1
    (3, 12, 12, 15, 28, 5),     # fmnist conv 2
    (2, 32, 32, 3, 15, 5),      # cifar conv 1
    (2, 14, 14, 15, 28, 5),     # cifar conv 2
    (4, 10, 10, 1, 10, 2),      # the mini model's conv
])
def test_plain_conv_is_a_valid_cross_correlation(B, H, W, C, O, k):
    """The im2col conv in NHWC/HWIO equals ``F.conv2d`` (VALID, no
    flip) in NCHW/OIHW, both in float64."""
    g = torch.Generator().manual_seed(5)
    x = torch.rand((B, H, W, C), generator=g, dtype=torch.float64)
    w = torch.randn((k, k, C, O), generator=g, dtype=torch.float64)
    want = torch.nn.functional.conv2d(x.permute(0, 3, 1, 2),
                                      w.permute(3, 2, 0, 1))
    torch.testing.assert_close(ops.im2col_conv(x, w),
                               want.permute(0, 2, 3, 1), rtol=1e-12,
                               atol=1e-12)


@pytest.mark.parametrize("H,W", [(24, 24), (9, 9), (8, 5)])
def test_plain_pool_keeps_each_windows_max(H, W):
    """The reshape max-pool equals ``F.max_pool2d(2)``, odd edges
    truncated, bit for bit."""
    x = torch.randn((2, H, W, 3), generator=torch.Generator().manual_seed(6))
    want = torch.nn.functional.max_pool2d(x.permute(0, 3, 1, 2), 2)
    assert torch.equal(ops.maxpool2(x), want.permute(0, 2, 3, 1))
