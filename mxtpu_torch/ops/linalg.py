"""LAPACK-style linalg ops of the PyTorch port (counterpart of
``mxtpu/ops/linalg.py``): ``gemm``, ``gemm2``, ``potrf``, ``potri``,
``trmm``, ``trsm``, ``sumlogdiag``, ``syrk``, ``gelqf``, ``syevd``,
``makediag``, ``extractdiag``, ``inverse``, ``det``, ``slogdet`` (each
``_linalg_<name>`` and ``linalg_<name>``, also ``nd.linalg.<name>``),
``_contrib_fft`` and ``_contrib_ifft``, batched over the leading axes.

They are ``torch.linalg`` and ``torch.fft`` calls (cuBLAS and cuSOLVER
on the card, float32 with TF32 off: ``fp32_library``), as the JAX
package leaves them to XLA, with its formulas:

* ``gemm``/``gemm2`` ignore ``axis``; ``trmm`` multiplies by the whole of
  ``a`` (``lower`` is not read), as the reference's.
* ``gelqf`` is the QR of the transpose, returned as (L, Q); ``syevd``
  returns (U, lambda) with the eigenvectors as rows.  Their signs are
  the library's (LAPACK's or cuSOLVER's), as the reference's are its
  own.
* ``fft`` interleaves the real and imaginary parts along the last axis;
  ``ifft`` takes them so and scales by n.
"""
from __future__ import annotations

import torch

from .registry import register


def _t(a):
    return a.transpose(-1, -2)


def _linalg(name, **kwargs):
    return register("_linalg_" + name, aliases=("linalg_" + name,),
                    fp32_library=True, **kwargs)


@_linalg("gemm")
def _gemm(a, b, c, transpose_a=False, transpose_b=False, alpha=1.0, beta=1.0,
          axis=-3):
    at = _t(a) if transpose_a else a
    bt = _t(b) if transpose_b else b
    return alpha * torch.matmul(at, bt) + beta * c


@_linalg("gemm2")
def _gemm2(a, b, transpose_a=False, transpose_b=False, alpha=1.0, axis=-3):
    at = _t(a) if transpose_a else a
    bt = _t(b) if transpose_b else b
    return alpha * torch.matmul(at, bt)


@_linalg("potrf")
def _potrf(a):
    """The lower Cholesky factor."""
    return torch.linalg.cholesky(a)


@_linalg("potri")
def _potri(a):
    """inv(L L^T) from the Cholesky factor L."""
    eye = torch.eye(a.shape[-1], dtype=a.dtype, device=a.device).expand(
        a.shape)
    linv = torch.linalg.solve_triangular(a, eye, upper=False)
    return torch.matmul(_t(linv), linv)


@_linalg("trmm")
def _trmm(a, b, transpose=False, rightside=False, lower=True, alpha=1.0):
    at = _t(a) if transpose else a
    return alpha * (torch.matmul(b, at) if rightside
                    else torch.matmul(at, b))


@_linalg("trsm")
def _trsm(a, b, transpose=False, rightside=False, lower=True, alpha=1.0):
    """Solves op(A) X = alpha B (or X op(A) = alpha B, ``rightside``)
    for the triangle ``lower`` of A."""
    amat = _t(a) if transpose else a
    low = (not lower) if transpose else lower
    if rightside:
        # X A = alpha B  <=>  A^T X^T = alpha B^T
        xt = torch.linalg.solve_triangular(_t(amat), _t(alpha * b),
                                           upper=low)
        return _t(xt)
    return torch.linalg.solve_triangular(amat, alpha * b, upper=not low)


@_linalg("sumlogdiag")
def _sumlogdiag(a):
    return torch.log(torch.diagonal(a, dim1=-2, dim2=-1)).sum(dim=-1)


@_linalg("syrk")
def _syrk(a, transpose=False, alpha=1.0):
    return alpha * (torch.matmul(_t(a), a) if transpose
                    else torch.matmul(a, _t(a)))


@_linalg("gelqf", num_outputs=2)
def _gelqf(a):
    """(L, Q) with A = L Q, from the QR of A^T."""
    q, r = torch.linalg.qr(_t(a))
    return _t(r), _t(q)


@_linalg("syevd", num_outputs=2)
def _syevd(a):
    """(U, lambda): the eigenvectors as the rows of U, the eigenvalues
    ascending."""
    w, v = torch.linalg.eigh(a)
    return _t(v), w


@_linalg("makediag")
def _makediag(a, offset=0):
    return torch.diag_embed(a, offset=offset)


@_linalg("extractdiag")
def _extractdiag(a, offset=0):
    return torch.diagonal(a, offset=offset, dim1=-2, dim2=-1)


@_linalg("inverse")
def _inverse(a):
    return torch.linalg.inv(a)


@_linalg("det")
def _det(a):
    return torch.linalg.det(a)


@_linalg("slogdet", num_outputs=2)
def _slogdet(a):
    sign, logdet = torch.linalg.slogdet(a)
    return sign, logdet


@register("_contrib_fft", fp32_library=True)
def _fft(data, compute_size=128):
    out = torch.fft.fft(data.to(torch.complex64), dim=-1)
    return torch.view_as_real(out).reshape(
        data.shape[:-1] + (data.shape[-1] * 2,)).to(data.dtype)


@register("_contrib_ifft", fp32_library=True)
def _ifft(data, compute_size=128):
    n = data.shape[-1] // 2
    ri = data.reshape(data.shape[:-1] + (n, 2)).to(torch.float32)
    comp = torch.complex(ri[..., 0], ri[..., 1])
    return (torch.fft.ifft(comp, dim=-1) * n).real.to(data.dtype)
