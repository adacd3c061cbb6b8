"""The port's batching pipeline against ``repro.data.pipeline``: bitwise.

``repro_torch.data.pipeline`` is a numpy copy of the reference's, so the
same seed must give the same arrays, bit for bit, from all three
functions: ``batch_iterator`` over several epochs (both ``drop_last``
values, a batch size that does not divide the data), ``sample_batch``
from one ``np.random.Generator`` state, and ``token_batch_iterator``
over several batches, for two seeds each.
"""
import numpy as np
import pytest

from repro.data import pipeline as jpipe
from repro_torch import data as tdata
from repro_torch.data import pipeline as tpipe


def _data(seed, n=23):
    rng = np.random.default_rng(seed + 100)
    return (rng.standard_normal((n, 3, 2)).astype(np.float32),
            rng.integers(0, 10, n).astype(np.int32))


def _equal(a, b):
    assert a.dtype == b.dtype and a.shape == b.shape
    np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("seed", [0, 7])
@pytest.mark.parametrize("drop_last", [False, True])
def test_batch_iterator_bitwise(seed, drop_last):
    X, y = _data(seed)
    want = jpipe.batch_iterator(X, y, 5, seed=seed, drop_last=drop_last)
    got = tpipe.batch_iterator(X, y, 5, seed=seed, drop_last=drop_last)
    sizes = []
    for _ in range(14):                 # > 2 epochs of 4-5 batches
        (wx, wy), (gx, gy) = next(want), next(got)
        _equal(gx, wx)
        _equal(gy, wy)
        sizes.append(len(gy))
    assert (3 in sizes) != drop_last    # the ragged last batch


@pytest.mark.parametrize("seed", [0, 7])
def test_sample_batch_bitwise(seed):
    X, y = _data(seed)
    jr, tr = np.random.default_rng(seed), np.random.default_rng(seed)
    for _ in range(3):
        (wx, wy), (gx, gy) = (jpipe.sample_batch(X, y, 8, jr),
                              tpipe.sample_batch(X, y, 8, tr))
        _equal(gx, wx)
        _equal(gy, wy)


@pytest.mark.parametrize("seed", [0, 7])
def test_token_batch_iterator_bitwise(seed):
    want = jpipe.token_batch_iterator(97, 4, 16, seed=seed)
    got = tdata.token_batch_iterator(97, 4, 16, seed=seed)
    for _ in range(3):
        w, g = next(want), next(got)
        assert sorted(g) == ["labels", "tokens"]
        for k in g:
            _equal(g[k], w[k])
        np.testing.assert_array_equal(g["tokens"][:, 1:], g["labels"][:, :-1])
