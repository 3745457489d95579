"""The PyTorch port's image ops (`mxtpu_torch/ops/image.py`) and
`_contrib_SparseEmbedding` against the JAX package's, beyond the op
sweep's cases (`test_torch_op_cases.py`):

* `_image_resize` and `_cvimresize` on uint8, growing and shrinking,
  HWC and NHWC: within one unit of the reference (both compute in
  float32 and truncate; the last bit of a float32 sum can cross an
  integer), and float32 within 1e-5 of its largest magnitude;
* `_cvcopyMakeBorder`'s four types against numpy's `np.pad` and the
  reference, pads wider than the image among them, equal;
* the random flips by rate: 200 draws, the count flipped within 5
  standard errors of 100 in both packages, one draw for the whole batch;
* `_contrib_SparseEmbedding`: the weight's recorded gradient row-sparse,
  its ids the reference's in-range set, and its values the reference's
  densified gradient (1e-6).
"""
import numpy as np
import pytest

import mxtpu as jmx
import mxtpu_torch as tmx
import torch

torch.set_num_threads(1)


def _u8(*shape, seed=0):
    return np.random.RandomState(seed).randint(0, 256, shape) \
        .astype(np.uint8)


def _call(mx, name, x, **attrs):
    return getattr(mx.nd, name)(mx.nd.array(x, ctx=mx.cpu(), dtype=x.dtype),
                                **attrs).asnumpy()


RESIZES = [((6, 7, 3), dict(size=(11, 9))), ((12, 10, 3), dict(size=(4, 5))),
           ((2, 9, 9, 3), dict(size=(5, 3))), ((2, 5, 4, 1), dict(size=8)),
           ((7, 6, 3), dict(size=(4, 10), interp=0))]


@pytest.mark.parametrize("shape,attrs", RESIZES)
@pytest.mark.parametrize("dtype", [np.uint8, np.float32])
def test_resize_matches_the_reference(shape, attrs, dtype):
    x = _u8(*shape) if dtype == np.uint8 else \
        np.random.RandomState(1).uniform(0, 255, shape).astype(np.float32)
    t = _call(tmx, "_image_resize", x, **attrs)
    j = _call(jmx, "_image_resize", x, **attrs)
    assert t.dtype == j.dtype == dtype and t.shape == j.shape
    diff = np.abs(t.astype(np.float64) - j.astype(np.float64))
    if dtype == np.uint8:
        assert diff.max() <= 1, diff.max()
        assert (diff > 0).mean() < 0.01
    else:
        assert diff.max() <= 1e-5 * np.abs(j).max(), diff.max()


@pytest.mark.parametrize("w,h", [(9, 4), (3, 5)])
def test_cvimresize_on_uint8_matches_the_reference(w, h):
    x = _u8(6, 5, 3, seed=2)
    t, j = (_call(mx, "_cvimresize", x, w=w, h=h) for mx in (tmx, jmx))
    assert t.shape == j.shape == (h, w, 3)
    assert np.abs(t.astype(int) - j.astype(int)).max() <= 1


BORDERS = [(0, "constant"), (1, "edge"), (2, "symmetric"), (4, "reflect")]


@pytest.mark.parametrize("pads", [(1, 2, 0, 3), (5, 7, 9, 4), (0, 0, 6, 0)])
@pytest.mark.parametrize("kind,mode", BORDERS)
@pytest.mark.parametrize("dtype", [np.uint8, np.float32])
def test_copy_make_border_is_numpy_pad(kind, mode, pads, dtype):
    x = _u8(3, 4, 2, seed=3).astype(dtype)
    top, bot, left, right = pads
    attrs = dict(top=top, bot=bot, left=left, right=right, type=kind)
    want = np.pad(x, [(top, bot), (left, right), (0, 0)], mode=mode)
    t = _call(tmx, "_cvcopyMakeBorder", x, **attrs)
    j = _call(jmx, "_cvcopyMakeBorder", x, **attrs)
    assert t.dtype == dtype
    np.testing.assert_array_equal(t, want)
    np.testing.assert_array_equal(t, j)


def test_copy_make_border_values_per_channel():
    x = _u8(2, 3, 3, seed=4)
    attrs = dict(top=1, bot=2, left=2, right=1, type=0, values=(9.0, 200.0))
    t = _call(tmx, "_cvcopyMakeBorder", x, **attrs)
    np.testing.assert_array_equal(t, _call(jmx, "_cvcopyMakeBorder", x,
                                           **attrs))
    np.testing.assert_array_equal(t[0, 0], [9, 200, 200])


@pytest.mark.parametrize("name,axis", [
    ("_image_random_flip_left_right", -2),
    ("_image_random_flip_top_bottom", -3)])
def test_random_flip_rate_and_one_draw_for_the_batch(name, axis):
    x = np.arange(2 * 3 * 4 * 2, dtype=np.float32).reshape(2, 3, 4, 2)
    flipped = np.flip(x, axis)
    for mx in (tmx, jmx):
        mx.random.seed(5)
        a = mx.nd.array(x, ctx=mx.cpu())
        n = 0
        for _ in range(200):
            y = getattr(mx.nd, name)(a).asnumpy()
            is_flipped = np.array_equal(y, flipped)
            assert is_flipped or np.array_equal(y, x)
            n += is_flipped
        assert abs(n - 100) < 5 * np.sqrt(200 * 0.25), (mx.__name__, n)


@pytest.mark.parametrize("ids", [[[0, 3, 3], [5, 1, 0]], [2, 9, -1, 2]])
def test_sparse_embedding_gradient_is_row_sparse(ids):
    ids = np.asarray(ids, np.float32)
    weight = np.random.RandomState(6).randn(6, 4).astype(np.float32)
    head = np.random.RandomState(7).randn(*(ids.shape + (4,))) \
        .astype(np.float32)
    grads = {}
    for mx in (tmx, jmx):
        w = mx.nd.array(weight, ctx=mx.cpu())
        w.attach_grad(stype="row_sparse")
        with mx.autograd.record():
            out = mx.nd.contrib.SparseEmbedding(
                mx.nd.array(ids, ctx=mx.cpu()), w, input_dim=6,
                output_dim=4)
        out.backward(mx.nd.array(head, ctx=mx.cpu()))
        grads[mx] = w.grad
    t, j = grads[tmx], grads[jmx]
    assert t.stype == j.stype == "row_sparse"
    t_ids = set(t.indices.asnumpy().tolist())
    j_ids = {int(i) for i in j.indices.asnumpy() if 0 <= i < 6}
    assert t_ids == j_ids == set(np.clip(ids, 0, 5).astype(int).ravel())
    np.testing.assert_allclose(t.tostype("default").asnumpy(),
                               j.tostype("default").asnumpy(), rtol=1e-6,
                               atol=1e-6)
