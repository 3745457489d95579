"""Arrays of the PyTorch port share no memory, as the JAX package's
immutable arrays share none, and negative-step subscripts read and
write; both held against `mxtpu` on the CPU.

* An op output that torch returns as a view of its input (`transpose`,
  `Flatten`, `SwapAxis`, `SliceChannel`, `Reshape`, `reshape_like`,
  `Cast` to the same dtype, inference-mode `Dropout`, `expand_dims`,
  `squeeze`, `moveaxis`, the `slice` family, the `broadcast_*`
  expansions, `diag`, `BlockGrad`, `make_loss`,
  `_identity_with_attr_like_rhs`, `Crop`, `T`), `reshape`,
  `detach` and the integer, axis-0, column and ellipsis subscripts are
  copies: a write through the result leaves the source as `mxtpu`
  leaves it.  `a[:]` is `a` itself in both packages.
* Reads and writes with negative steps (`a[::-1]`, `a[3:0:-2]`,
  `a[:, ::-2]`, with an integer or an index array beside them) give
  `mxtpu`'s values.
* Gradients still flow through a copied subscript and a copied
  reshape.

Exact comparisons: every case moves or writes values, no arithmetic.
"""
import numpy as np
import pytest

import mxtpu as jmx
import mxtpu_torch as tmx
import torch

torch.set_num_threads(1)

A0 = np.arange(24, dtype=np.float32).reshape(4, 6)

VIEWS = {
    "transpose": lambda M, a: M.nd.transpose(a),
    "Flatten": lambda M, a: M.nd.Flatten(a),
    "SwapAxis": lambda M, a: M.nd.SwapAxis(a, dim1=0, dim2=1),
    "SliceChannel": lambda M, a: M.nd.SliceChannel(a, num_outputs=2,
                                                   axis=0)[1],
    "Reshape": lambda M, a: M.nd.Reshape(a, shape=(6, 4)),
    "reshape_like": lambda M, a: M.nd.reshape_like(
        a, M.nd.zeros((3, 8), ctx=a.ctx)),
    "Cast": lambda M, a: M.nd.Cast(a, dtype="float32"),
    "Dropout": lambda M, a: M.nd.Dropout(a, p=0.3),
    "expand_dims": lambda M, a: M.nd.expand_dims(a, axis=0),
    "squeeze": lambda M, a: M.nd.squeeze(a),
    "moveaxis": lambda M, a: M.nd.moveaxis(a, source=0, destination=1),
    "reverse": lambda M, a: M.nd.reverse(a, axis=1),
    "slice": lambda M, a: M.nd.slice(a, begin=(1, 0), end=(3, 4)),
    "slice_axis": lambda M, a: M.nd.slice_axis(a, axis=1, begin=1, end=4),
    "slice_like": lambda M, a: M.nd.slice_like(
        a, M.nd.zeros((2, 3), ctx=a.ctx)),
    "broadcast_to": lambda M, a: M.nd.broadcast_to(a, shape=(4, 6)),
    "broadcast_axis": lambda M, a: M.nd.broadcast_axis(a, axis=0, size=4),
    "broadcast_like": lambda M, a: M.nd.broadcast_like(a, a),
    "diag": lambda M, a: M.nd.diag(a, k=1),
    "BlockGrad": lambda M, a: M.nd.BlockGrad(a),
    "make_loss": lambda M, a: M.nd.make_loss(a),
    "identity_like_rhs": lambda M, a: M.nd._identity_with_attr_like_rhs(
        a, a),
    "Crop": lambda M, a: M.nd.Crop(M.nd.reshape(a, shape=(1, 1, 4, 6)),
                                   h_w=(2, 3), offset=(1, 1)),
    "T": lambda M, a: a.T,
    "reshape": lambda M, a: a.reshape((2, 12)),
    "detach": lambda M, a: a.detach(),
    "int": lambda M, a: a[1],
    "axis0": lambda M, a: a[1:3],
    "column": lambda M, a: a[:, 2],
    "ellipsis": lambda M, a: a[..., 1],
    "full": lambda M, a: a[:],
}


def _array(M, x):
    return M.nd.array(x, ctx=M.cpu())


def _both(fn):
    """fn(M) for the reference and the port."""
    return fn(jmx), fn(tmx)


@pytest.mark.parametrize("form", sorted(VIEWS))
@pytest.mark.parametrize("write", ["setitem", "out"])
def test_a_write_through_a_result_leaves_the_source_as_mxtpu_does(form,
                                                                   write):
    def run(M):
        a = _array(M, A0)
        y = VIEWS[form](M, a)
        if write == "setitem":
            y[:] = -1
        else:
            M.nd.elemwise_add(y, y, out=y)
        return a.asnumpy(), y.asnumpy()

    (ja, jy), (ta, ty) = _both(run)
    np.testing.assert_array_equal(ta, ja)
    np.testing.assert_array_equal(ty, jy)
    if form == "full":
        assert not np.array_equal(ta, A0)
    else:
        np.testing.assert_array_equal(ta, A0)


def test_full_slice_is_the_array_itself():
    for M in (jmx, tmx):
        a = _array(M, A0)
        assert a[:] is a


def test_the_probes_of_the_issue():
    """Flatten then an in-place add; a column written through a
    subscript; a reversed read."""
    def run(M):
        a = _array(M, np.arange(24, dtype=np.float32).reshape(2, 3, 4))
        y = M.nd.Flatten(a)
        M.nd.elemwise_add(y, y, out=y)
        b = _array(M, A0)
        c = b[:, 2]
        c[:] = -1
        return float(a.asnumpy().sum()), b.asnumpy(), b[::-1].asnumpy()

    (js, jb, jr), (ts, tb, tr) = _both(run)
    assert ts == js == 276.0
    np.testing.assert_array_equal(tb, jb)
    np.testing.assert_array_equal(tb, A0)
    np.testing.assert_array_equal(tr, jr)


READS = {
    "reverse": lambda a: a[::-1],
    "stepped": lambda a: a[3:0:-2],
    "columns": lambda a: a[:, ::-2],
    "both_axes": lambda a: a[::-1, 5:1:-3],
    "int_and_reverse": lambda a: a[2, ::-1],
    "reverse_and_int": lambda a: a[::-1, 1],
    "ellipsis": lambda a: a[..., ::-1],
    "empty": lambda a: a[0:3:-1],
}


@pytest.mark.parametrize("form", sorted(READS))
def test_negative_step_reads_match_mxtpu(form):
    ja, ta = _both(lambda M: READS[form](_array(M, A0)).asnumpy())
    assert ta.shape == ja.shape
    np.testing.assert_array_equal(ta, ja)


def test_negative_step_read_beside_an_index_array_matches_mxtpu():
    def run(M):
        a = _array(M, A0)
        idx = M.nd.array(np.array([3, 0]), ctx=M.cpu(), dtype="int32")
        return a[idx, ::-1].asnumpy()

    ja, ta = _both(run)
    np.testing.assert_array_equal(ta, ja)


WRITES = {
    "reverse": (lambda a, v: a.__setitem__(slice(None, None, -1), v),
                np.arange(24, dtype=np.float32).reshape(4, 6) * 10),
    "stepped": (lambda a, v: a.__setitem__(slice(3, 0, -2), v),
                np.arange(12, dtype=np.float32).reshape(2, 6)),
    "columns_scalar": (lambda a, v: a.__setitem__(
        (slice(None), slice(None, None, -2)), v), 0.0),
    "int_and_reverse": (lambda a, v: a.__setitem__(
        (1, slice(None, None, -1)), v), np.arange(6, dtype=np.float32)),
    "broadcast_row": (lambda a, v: a.__setitem__(
        (slice(None, None, -1), slice(4, None, -2)), v),
        np.array([7, 8, 9], np.float32)),
}


@pytest.mark.parametrize("form", sorted(WRITES))
def test_negative_step_writes_match_mxtpu(form):
    write, value = WRITES[form]

    def run(M):
        a = _array(M, A0)
        write(a, _array(M, value) if isinstance(value, np.ndarray)
              else value)
        return a.asnumpy()

    ja, ta = _both(run)
    np.testing.assert_array_equal(ta, ja)
    assert not np.array_equal(ta, A0)


def test_gradients_flow_through_copied_subscripts_and_reshapes():
    def run(M):
        a = _array(M, A0)
        a.attach_grad()
        with M.autograd.record():
            loss = (a[1] * 2).sum() + a.reshape((6, 4))[0].sum() \
                + a[::-1][0].sum()
        loss.backward()
        return a.grad.asnumpy()

    jg, tg = _both(run)
    np.testing.assert_array_equal(tg, jg)
    assert tg.any()
