"""Port CNN, mini model and local training against ``repro``.

Both packages start from the same weights (``repro`` init, carried over
with ``convert.params_from_numpy``) and the same numpy inputs. The convs
are im2col matmuls on both sides; f32 sums in another order give a few
ulps per layer: logits (of order 1-5, a 448-term last sum) are held to
rtol 1e-5 / atol 1e-5, grads to rtol 1e-5 / atol 1e-6, and params after
L GD steps (the rounding of each step feeds the next) to rtol 1e-5 /
atol 1e-6 on weights of order 0.1.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import local_train as jlt
from repro.models import cnn as jcnn
from repro_torch.convert import params_from_numpy, params_to_numpy
from repro_torch.core import local_train as tlt
from repro_torch.models import cnn as tcnn
from repro_torch.models.layers import he_normal

TOL = dict(rtol=1e-5, atol=1e-6)
LOGIT_TOL = dict(rtol=1e-5, atol=1e-5)


def _np(tree):
    return {k: np.asarray(v) for k, v in tree.items()}


def _weights(init, seed, *args, **kw):
    """Weights of ``repro``'s layout drawn from a seed (the torch init,
    as numpy): the one set of weights both packages start from."""
    return params_to_numpy(init(torch.Generator().manual_seed(seed), *args,
                                device="cpu", **kw))


def _images(seed, n, hw=(28, 28), c=1):
    rng = np.random.default_rng(seed)
    return rng.random((n, *hw, c)).astype(np.float32), \
        rng.integers(0, 10, n).astype(np.int32)


def test_convert_round_trip_is_exact():
    jp = _np(jcnn.cnn_init(jax.random.PRNGKey(0), (28, 28), 1, hidden=16))
    back = params_to_numpy(params_from_numpy(jp, "cpu"))
    assert back.keys() == jp.keys()
    for k in jp:
        np.testing.assert_array_equal(back[k], jp[k])


@pytest.mark.parametrize("hw,c,hidden", [((28, 28), 1, 226),
                                         ((32, 32), 3, 20)])
def test_cnn_logits_and_grads(hw, c, hidden):
    jp = _weights(tcnn.cnn_init, 1, hw, c, hidden=hidden)
    tp = params_from_numpy(jp, "cpu")
    X, y = _images(2, 6, hw, c)
    np.testing.assert_allclose(
        tcnn.cnn_apply(tp, torch.from_numpy(X)).numpy(),
        np.asarray(jax.jit(jcnn.cnn_apply)(jp, jnp.asarray(X))), **LOGIT_TOL)

    def jloss(p):
        return jcnn.softmax_xent(jcnn.cnn_apply(p, jnp.asarray(X)),
                                 jnp.asarray(y))
    jl, jg = jax.jit(jax.value_and_grad(jloss))(jp)
    tp = {k: v.requires_grad_(True) for k, v in tp.items()}
    loss = tcnn.softmax_xent(tcnn.cnn_apply(tp, torch.from_numpy(X)),
                             torch.from_numpy(y))
    np.testing.assert_allclose(float(loss.detach()), float(jl), rtol=1e-6)
    tg = torch.autograd.grad(loss, list(tp.values()))
    for k, g in zip(tp, tg):
        np.testing.assert_allclose(g.numpy(), np.asarray(jg[k]), **TOL,
                                   err_msg=k)


def test_mini_model_and_crop():
    jp = _weights(tcnn.mini_init, 3)
    tp = params_from_numpy(jp, "cpu")
    X, _ = _images(4, 5, c=1)
    Xb = np.stack([X, X[::-1]])                       # (N=2, D=5, 28, 28, 1)
    offsets = np.array([[3, 11], [18, 0]])
    crop = tcnn.mini_preprocess(torch.from_numpy(Xb), offsets)
    for n, (ox, oy) in enumerate(offsets):
        want = jax.jit(jax.lax.dynamic_slice, static_argnums=2)(
            jnp.asarray(Xb[n]), (0, ox, oy, 0), (5, 10, 10, 1))
        np.testing.assert_array_equal(crop[n].numpy(), np.asarray(want))
    np.testing.assert_allclose(
        tcnn.mini_apply(tp, crop[0]).numpy(),
        np.asarray(jax.jit(jcnn.mini_apply)(jp, jnp.asarray(crop[0].numpy()))),
        **LOGIT_TOL)
    g = torch.Generator().manual_seed(0)
    off = tcnn.crop_offsets(g, 50, (28, 28))
    assert off.shape == (50, 2) and int(off.min()) >= 0
    assert int(off.max()) <= 18


def test_torch_init_shapes_and_scale():
    g = torch.Generator().manual_seed(0)
    tp = tcnn.cnn_init(g, (28, 28), 1, device="cpu")
    jp = jcnn.cnn_init(jax.random.PRNGKey(0), (28, 28), 1)
    assert {k: tuple(v.shape) for k, v in tp.items()} == \
        {k: tuple(v.shape) for k, v in jp.items()}
    assert sum(v.numel() * 4 for v in tp.values()) == 457532
    w = he_normal(g, (400, 300), fan_in=400, device="cpu")
    assert abs(float(w.std()) - np.sqrt(2 / 400)) < 0.01 * np.sqrt(2 / 400)


def _cohort(seed, H, D, hidden=12):
    rng = np.random.default_rng(seed)
    X = rng.random((H, D, 28, 28, 1)).astype(np.float32)
    y = rng.integers(0, 10, (H, D)).astype(np.int32)
    mask = (rng.random((H, D)) < 0.8).astype(np.float32)
    jp = _weights(tcnn.cnn_init, seed, (28, 28), 1, hidden=hidden)
    return X, y, mask, jp


def test_local_sgd_after_L_steps():
    X, y, mask, jp = _cohort(5, 1, 9)
    jout = jax.jit(jlt.local_sgd, static_argnums=(0, 5))(
        jcnn.cnn_apply, jp, jnp.asarray(X[0]), jnp.asarray(y[0]),
        jnp.asarray(mask[0]), 5, 0.05)
    tout = tlt.local_sgd(tcnn.cnn_apply, params_from_numpy(jp, "cpu"),
                         torch.from_numpy(X[0]),
                         torch.from_numpy(y[0]).long(),
                         torch.from_numpy(mask[0]), 5, 0.05)
    for k in jp:
        np.testing.assert_allclose(tout[k].numpy(), np.asarray(jout[k]),
                                   rtol=1e-5, atol=1e-6, err_msg=k)


def test_cohort_local_sgd_matches_vmap():
    H = 3
    X, y, mask, jp = _cohort(6, H, 7)
    mask[1] = 0.0                                 # a device with no data
    jdev = {k: (v[None] * (1.0 + 0.1 * np.arange(H, dtype=np.float32)
                           .reshape((H,) + (1,) * v.ndim)))
            for k, v in jp.items()}
    jout = jax.jit(jlt.cohort_local_sgd, static_argnums=(0, 5))(
        jcnn.cnn_apply, jdev, jnp.asarray(X), jnp.asarray(y),
        jnp.asarray(mask), 3, 0.05)
    tout = tlt.cohort_local_sgd(
        tcnn.cnn_apply, params_from_numpy(jdev, "cpu"),
        torch.from_numpy(X), torch.from_numpy(y).long(),
        torch.from_numpy(mask), 3, 0.05)
    for k in jp:
        np.testing.assert_allclose(tout[k].numpy(), np.asarray(jout[k]),
                                   rtol=1e-5, atol=1e-6, err_msg=k)
    np.testing.assert_array_equal(tout["fc1"][1].numpy(), jdev["fc1"][1])
