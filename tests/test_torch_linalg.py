"""The PyTorch port's linalg ops (`mxtpu_torch/ops/linalg.py`) against
the JAX package's (`mxtpu/ops/linalg.py`), with `test_torch_nn_ops.py`'s
harness: the same numpy inputs through the JAX function under `jax.vjp`
and the port's under torch autograd, the same head gradients, every
output and input gradient within 1e-5 of the reference's value plus
1e-6 of the result's largest magnitude (float32 arithmetic in other
orders, on well-conditioned matrices: symmetric positive definite, or
triangular with a heavy diagonal).

The factorizations whose signs are the library's own (`gelqf`'s L and
Q, `syevd`'s eigenvectors) are held by reconstruction (L Q = A,
Q Q^T = I; U^T diag(lambda) U = A, U U^T = I, within 1e-5) and through
sign-normalised factors (L's diagonal positive, each eigenvector signed
by its largest element), whose values and gradients must agree as
above.  `potrf` and `potri` are also held to L L^T = A and to the
inverse.  The 32 names resolve to the 17 ops, and `nd.linalg`/
`sym.linalg` name them without the prefix.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mxtpu_torch as tmx
from mxtpu.ops import registry as jreg
from mxtpu_torch.ops import registry as treg
from test_torch_nn_ops import check
from test_torch_op_cases import INVERTIBLE, _a, _spd, _tri, error_units

torch.set_num_threads(1)

RTOL, ATOL = 1e-5, 1e-6

CASES = {
    "gemm": ([_a(2, 3, 4), _a(2, 4, 5, seed=1), _a(2, 3, 5, seed=2)],
             dict(alpha=0.5, beta=2.0)),
    "gemm_transposed": ([_a(2, 4, 3), _a(2, 5, 4, seed=1),
                         _a(2, 3, 5, seed=2)],
                        dict(transpose_a=True, transpose_b=True, axis=-2)),
    "gemm2": ([_a(2, 3, 4), _a(2, 4, 5, seed=1)], dict(alpha=-1.5)),
    "gemm2_transpose_b": ([_a(3, 4), _a(5, 4, seed=1)],
                          dict(transpose_b=True)),
    "potrf": ([_spd(2, 4)], {}),
    "potri": ([np.linalg.cholesky(_spd(2, 4)).astype(np.float32)], {}),
    "trmm": ([_tri(2, 3), _a(2, 3, 4, seed=1)], dict(alpha=2.0)),
    "trmm_right_transposed": ([_tri(2, 3), _a(2, 4, 3, seed=1)],
                              dict(rightside=True, transpose=True)),
    "trsm": ([_tri(2, 3), _a(2, 3, 4, seed=1)], {}),
    "trsm_transposed": ([_tri(2, 3), _a(2, 3, 4, seed=1)],
                        dict(transpose=True, alpha=0.5)),
    "trsm_right": ([_tri(2, 3), _a(2, 4, 3, seed=1)], dict(rightside=True)),
    "trsm_upper": ([_tri(2, 3, lower=False), _a(2, 3, 4, seed=1)],
                   dict(lower=False)),
    "trsm_upper_right_transposed": (
        [_tri(2, 3, lower=False), _a(2, 4, 3, seed=1)],
        dict(lower=False, rightside=True, transpose=True, alpha=-2.0)),
    "sumlogdiag": ([_spd(2, 4)], {}),
    "syrk": ([_a(2, 3, 4)], {}),
    "syrk_transposed": ([_a(2, 3, 4)], dict(transpose=True, alpha=0.5)),
    "makediag": ([_a(2, 3)], dict(offset=1)),
    "makediag_below": ([_a(3)], dict(offset=-2)),
    "extractdiag": ([_a(2, 3, 4)], dict(offset=-1)),
    "inverse": ([INVERTIBLE], {}),
    "det": ([INVERTIBLE], {}),
    "slogdet": ([INVERTIBLE], {}),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_op(case):
    inputs, attrs = CASES[case]
    name = "_linalg_" + next(n for n in sorted(
        (c for c in CASES if "_" not in c), key=len, reverse=True)
        if case == n or case.startswith(n + "_"))
    check(name, inputs, attrs, grad=tuple(range(len(inputs))))


@pytest.mark.parametrize("name", ["_contrib_fft", "_contrib_ifft"])
def test_fft(name):
    out, _ = check(name, [_a(3, 8)], {})
    if name == "_contrib_fft":
        want = np.fft.fft(_a(3, 8).astype(np.float64), axis=-1)
        got = out[0].reshape(3, 8, 2)
        np.testing.assert_allclose(got[..., 0] + 1j * got[..., 1], want,
                                   rtol=1e-5, atol=1e-5)


def test_potrf_and_potri_reconstruct():
    a = _spd(2, 4)
    lo = treg.get_op("_linalg_potrf").fn(torch.tensor(a)).numpy()
    np.testing.assert_allclose(lo @ lo.transpose(0, 2, 1), a, rtol=1e-5,
                               atol=1e-5)
    inv = treg.get_op("_linalg_potri").fn(torch.tensor(lo)).numpy()
    np.testing.assert_allclose(inv @ a, np.broadcast_to(np.eye(4), a.shape),
                               atol=1e-5)


def _signed(name, outs, lib):
    """The factors with the library's signs taken out (``lib``: jnp or
    torch), as differentiable functions of the outputs."""
    if name == "_linalg_gelqf":
        lo, q = outs
        d = lib.sign(lib.diagonal(lo, 0, -2, -1) if lib is torch
                     else lib.diagonal(lo, axis1=-2, axis2=-1))[..., None]
        return [lo * d.swapaxes(-1, -2) if lib is jnp
                else lo * d.transpose(-1, -2), q * d]
    u, w = outs
    idx = lib.abs(u).argmax(-1)[..., None]
    big = lib.take_along_axis(u, idx, -1) if lib is jnp \
        else torch.gather(u, -1, idx)
    return [u * lib.sign(big), w]


FACTORS = {"_linalg_gelqf": _a(2, 3, 5), "_linalg_syevd": _spd(2, 4)}


@pytest.mark.parametrize("name", sorted(FACTORS))
def test_factorization_by_reconstruction_and_signed_factors(name):
    a = FACTORS[name]
    jfn, tfn = jreg.get_op(name).fn, treg.get_op(name).fn
    jo, vjp = jax.vjp(lambda x: _signed(name, jfn(x), jnp), jnp.asarray(a))
    heads = [np.random.RandomState(7 + k).normal(0, 1, o.shape).astype(
        np.float32) for k, o in enumerate(jo)]
    jg, = vjp([jnp.asarray(h) for h in heads])
    x = torch.tensor(a, requires_grad=True)
    raw = tfn(x)
    to = _signed(name, raw, torch)
    tg, = torch.autograd.grad(to, [x], [torch.tensor(h) for h in heads])
    for t, j in zip([o.detach().numpy() for o in to] + [tg.numpy()],
                    [np.asarray(o) for o in jo] + [np.asarray(jg)]):
        assert error_units(t, j, False, RTOL, ATOL) <= 1.0, name
    f, s = [o.detach().numpy().astype(np.float64) for o in raw]
    if name == "_linalg_gelqf":
        np.testing.assert_allclose(f @ s, a, atol=1e-5)
        np.testing.assert_allclose(s @ s.transpose(0, 2, 1),
                                   np.broadcast_to(np.eye(3), (2, 3, 3)),
                                   atol=1e-5)
    else:
        np.testing.assert_allclose(
            f.transpose(0, 2, 1) @ (s[..., None] * f), a, rtol=1e-5,
            atol=1e-5)
        assert (np.diff(s, axis=-1) > 0).all()


def test_the_names_and_namespaces():
    canonical = sorted(n for n in treg.list_ops()
                       if n.startswith("_linalg_"))
    assert len(canonical) == 15
    for n in canonical:
        short = n[len("_linalg_"):]
        assert treg.get_op("linalg_" + short) is treg.get_op(n)
        assert getattr(tmx.nd.linalg, short).__name__ == n
        assert hasattr(tmx.sym.linalg, short)
    assert tmx.nd.contrib.fft and tmx.nd.contrib.ifft
    x = tmx.nd.array(_a(2, 3, 4), ctx=tmx.cpu())
    np.testing.assert_allclose(
        tmx.nd.linalg.gemm2(x, x, transpose_b=True).asnumpy(),
        tmx.nd.linalg.syrk(x).asnumpy(), rtol=1e-6)
