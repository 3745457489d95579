"""Flash attention: hand-written CUDA kernels and their plain versions.

Counterpart of ``mxtpu/ops/pallas_attention.py``.  The three Pallas TPU
kernels become CUDA C++ for sm_90a (built by :mod:`.kernel_build`):

* ``_flash_kernel`` -> ``csrc/flash_fwd.cu`` (``FLASH_FWD``), launched by
  :func:`_flash_forward_cuda` (the analog of ``_flash_forward_pallas``);
* ``_flash_bwd_dq_kernel`` and ``_flash_bwd_dkv_kernel`` ->
  ``csrc/flash_bwd.cu`` (``FLASH_BWD_DQ``, ``FLASH_BWD_DKV``), launched
  by :func:`_flash_backward_cuda` (the analog of
  ``_flash_backward_pallas``).

Their plain PyTorch versions are :func:`_reference_attention_lse` (the
JAX function of that name) and :func:`_flash_bwd_reference` (the math of
``_bwd_p_ds`` and the two backward kernels).  ``_flash_impl`` routes the
forward; :class:`_FlashAttention` (the ``_flash`` custom_vjp) routes the
backward; :func:`flash_attention` keeps the 3-D/4-D public API, and
the registered op ``_contrib_flash_attention`` (``nd.contrib`` and
``sym.contrib.flash_attention``) takes it over (batch, heads, seq,
head_dim) inputs, as the JAX package registers it.

Routing: a tensor on the CPU takes the plain version; a CUDA tensor
launches the kernel or raises.  There is no fallback from a kernel to
its plain version and no switch that turns a kernel off.

Numerics, in the kernels and the plain versions alike (as in the JAX
package): operands enter every product in their own dtype with f32
accumulation, ``sm_scale`` multiplies the f32 scores, masked scores are
-1e30, and the causal mask is top-left aligned (``q_idx >= k_idx``).
Forward: the probabilities are rounded to V's dtype before P.V, the
final divide clamps the row sum at 1e-30, and O comes back in Q's dtype.
Backward: P = exp(S - lse) against the forward's LSE, dP = G.V^T,
dS = P * (dP - delta) * sm_scale in f32 with delta = rowsum(O * G) in
f32, and P and dS are rounded to the operands' dtype before
dv += P^T.G, dk += dS^T.Q and dq += dS.K.
"""
from __future__ import annotations

import ctypes
import math

import torch

from ..base import MXNetError
from .kernel_build import CudaKernel
from .registry import register

__all__ = ["flash_attention", "FLASH_FWD", "FLASH_BWD_DQ", "FLASH_BWD_DKV",
           "HEAD_DIMS"]

_NEG_INF = -1e30
HEAD_DIMS = (16, 32, 64, 128)
_KERNEL_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

_vp, _int = ctypes.c_void_p, ctypes.c_int
FLASH_FWD = CudaKernel(
    "flash_fwd.cu", "flash_fwd",
    # q, k, v, o, lse, bh, tq, tk, d, dtype, sm_scale, causal, stream
    [_vp, _vp, _vp, _vp, _vp, _int, _int, _int, _int, _int,
     ctypes.c_float, _int, _vp])
# q, k, v, g, lse, delta, dq, bh, tq, tk, d, dtype, sm_scale, causal, stream
FLASH_BWD_DQ = CudaKernel(
    "flash_bwd.cu", "flash_bwd_dq",
    [_vp] * 7 + [_int] * 5 + [ctypes.c_float, _int, _vp])
# q, k, v, g, lse, delta, dk, dv, bh, tq, tk, d, dtype, sm_scale, causal,
# stream
FLASH_BWD_DKV = CudaKernel(
    "flash_bwd.cu", "flash_bwd_dkv",
    [_vp] * 8 + [_int] * 5 + [ctypes.c_float, _int, _vp])


def _reference_attention_lse(q, k, v, sm_scale, causal):
    """Plain PyTorch attention over (bh, Tq, d) x (bh, Tk, d); returns
    (out, per-row log-sum-exp).  Materializes the (bh, Tq, Tk) scores.

    bf16 operands are widened to f32 before each product: a product of
    two bf16 values is exact in f32, so this is the JAX package's
    native-dtype product with f32 accumulation."""
    s = torch.einsum("bqd,bkd->bqk", q.float(), k.float()) * sm_scale
    if causal:
        tq, tk = s.shape[-2:]
        mask = torch.arange(tq, device=s.device)[:, None] \
            >= torch.arange(tk, device=s.device)[None, :]
        s = torch.where(mask, s, torch.full_like(s, _NEG_INF))
    lse = torch.logsumexp(s, dim=-1)
    p = torch.exp(s - lse[..., None])
    out = torch.einsum("bqk,bkd->bqd", p.to(v.dtype).float(), v.float())
    return out.to(q.dtype), lse


def _check_kernel_args(q, k, v):
    """Raise on what the kernel does not take: it reads (bh, T, d)
    row-major memory in 16-byte pieces, so a strided view would be read
    as garbage and a misaligned one would fault."""
    if q.dim() != 3 or k.dim() != 3 or v.dim() != 3:
        raise MXNetError("flash kernel takes 3-D (bh, T, d) tensors, got "
                         "%s, %s, %s" % (tuple(q.shape), tuple(k.shape),
                                         tuple(v.shape)))
    if not (q.dtype == k.dtype == v.dtype) or q.dtype not in _KERNEL_DTYPES:
        raise MXNetError("flash kernel takes q, k, v of one dtype, float32 "
                         "or bfloat16; got %s, %s, %s"
                         % (q.dtype, k.dtype, v.dtype))
    if not (q.device == k.device == v.device):
        raise MXNetError("flash kernel: q, k, v on different devices")
    bh, tq, d = q.shape
    if k.shape[0] != bh or k.shape[2] != d or v.shape != k.shape:
        raise MXNetError("flash kernel: q %s, k %s, v %s do not match"
                         % (tuple(q.shape), tuple(k.shape), tuple(v.shape)))
    if d not in HEAD_DIMS:
        raise MXNetError("flash kernel: head dim %d not in %s"
                         % (d, HEAD_DIMS))
    if bh == 0 or tq == 0 or k.shape[1] == 0:
        raise MXNetError("flash kernel: empty input %s x %s"
                         % (tuple(q.shape), tuple(k.shape)))
    for name, t in (("q", q), ("k", k), ("v", v)):
        _check_layout(name, t)


def _check_layout(name, t):
    if not t.is_contiguous():
        raise MXNetError("flash kernel: %s is not contiguous (strides "
                         "%s); reshape or .contiguous() it first"
                         % (name, t.stride()))
    if t.data_ptr() % 16:
        raise MXNetError("flash kernel: %s is not 16-byte aligned; "
                         ".clone() it first" % name)


def _check_bwd_args(q, k, v, g, out, lse):
    """:func:`_check_kernel_args` for q, k, v, and the same rules for
    the cotangent g and the forward's output (q's shape and dtype) and
    its LSE ((bh, Tq) float32, contiguous)."""
    _check_kernel_args(q, k, v)
    for name, t in (("g", g), ("out", out)):
        if t.shape != q.shape or t.dtype != q.dtype or t.device != q.device:
            raise MXNetError("flash kernel: %s %s %s on %s does not match q "
                             "%s %s" % (name, tuple(t.shape), t.dtype,
                                        t.device, tuple(q.shape), q.dtype))
        _check_layout(name, t)
    if lse.shape != q.shape[:2] or lse.dtype != torch.float32 \
            or lse.device != q.device or not lse.is_contiguous():
        raise MXNetError("flash kernel: lse must be a contiguous float32 "
                         "%s tensor on %s; got %s %s on %s"
                         % (tuple(q.shape[:2]), q.device, tuple(lse.shape),
                            lse.dtype, lse.device))


def _flash_forward_cuda(q, k, v, sm_scale, causal, want_lse):
    """Launch the CUDA kernel on PyTorch's current stream; returns
    (out, lse or None).  Counts one launch on ``FLASH_FWD``."""
    _check_kernel_args(q, k, v)
    if q.device.type != "cuda":
        raise MXNetError("flash kernel: tensors must be on a CUDA device, "
                         "got %s" % q.device)
    bh, tq, d = q.shape
    out = torch.empty_like(q)
    lse = torch.empty((bh, tq), dtype=torch.float32, device=q.device) \
        if want_lse else None
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        FLASH_FWD(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                  lse.data_ptr() if want_lse else None, bh, tq, k.shape[1],
                  d, _KERNEL_DTYPES[q.dtype], float(sm_scale), int(causal),
                  stream)
    return out, lse


def _flash_bwd_reference(q, k, v, g, out, lse, sm_scale, causal):
    """Plain PyTorch backward over (bh, Tq, d) x (bh, Tk, d); returns
    (dq, dk, dv) in q's, k's and v's dtypes.  Materializes the
    (bh, Tq, Tk) blocks in f32.

    The kernels' math, written out (not autograd through
    :func:`_reference_attention_lse`, which would differentiate the
    cast of P as an identity and keep P in f32 for dv): P and dS are
    rounded to the operands' dtype before the three products, as
    ``_dot_f32`` does in the JAX kernels.  Operands are then widened to
    f32, which is exact, so each product is the native-dtype product
    with f32 accumulation."""
    s = torch.einsum("bqd,bkd->bqk", q.float(), k.float()) * sm_scale
    if causal:
        tq, tk = s.shape[-2:]
        mask = torch.arange(tq, device=s.device)[:, None] \
            >= torch.arange(tk, device=s.device)[None, :]
        s = torch.where(mask, s, torch.full_like(s, _NEG_INF))
    p = torch.exp(s - lse[..., None])
    delta = _delta(out, g)
    dp = torch.einsum("bqd,bkd->bqk", g.float(), v.float())
    ds = p * (dp - delta[..., None]) * sm_scale
    dv = torch.einsum("bqk,bqd->bkd", p.to(g.dtype).float(), g.float())
    dk = torch.einsum("bqk,bqd->bkd", ds.to(q.dtype).float(), q.float())
    dq = torch.einsum("bqk,bkd->bqd", ds.to(k.dtype).float(), k.float())
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def _delta(out, g):
    """delta = rowsum(O * G), both widened to f32: (bh, Tq) float32."""
    return (out.float() * g.float()).sum(-1)


def _bwd_launch(kernel, q, k, v, g, lse, delta, outs, sm_scale, causal):
    """Launch one backward kernel on PyTorch's current stream: ``outs``
    is (dq,) for ``FLASH_BWD_DQ`` and (dk, dv) for ``FLASH_BWD_DKV``.
    The arguments must pass :func:`_check_bwd_args`; ``delta`` is
    :func:`_delta` of the forward's output and g."""
    bh, tq, d = q.shape
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        kernel(q.data_ptr(), k.data_ptr(), v.data_ptr(), g.data_ptr(),
               lse.data_ptr(), delta.data_ptr(),
               *[t.data_ptr() for t in outs], bh, tq, k.shape[1], d,
               _KERNEL_DTYPES[q.dtype], float(sm_scale), int(causal), stream)


def _flash_backward_cuda(q, k, v, g, out, lse, sm_scale, causal):
    """The backward on the card: ``flash_bwd_dq`` then ``flash_bwd_dkv``
    on PyTorch's current stream; returns (dq, dk, dv).  delta is a torch
    expression (:func:`_delta`), as the JAX package computes it outside
    its kernels.  Counts one launch on each of ``FLASH_BWD_DQ`` and
    ``FLASH_BWD_DKV``."""
    _check_bwd_args(q, k, v, g, out, lse)
    if q.device.type != "cuda":
        raise MXNetError("flash kernel: tensors must be on a CUDA device, "
                         "got %s" % q.device)
    delta = _delta(out, g)
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), \
        torch.empty_like(v)
    _bwd_launch(FLASH_BWD_DQ, q, k, v, g, lse, delta, (dq,), sm_scale, causal)
    _bwd_launch(FLASH_BWD_DKV, q, k, v, g, lse, delta, (dk, dv), sm_scale,
                causal)
    return dq, dk, dv


def _flash_impl(q, k, v, sm_scale, causal, want_lse):
    """Returns (out, lse or None): the plain version for CPU tensors,
    the kernel for CUDA tensors.  The kernel masks ragged Tq/Tk itself,
    so unlike the TPU route nothing is padded and no length takes the
    plain version."""
    if q.device.type == "cpu":
        out, lse = _reference_attention_lse(q, k, v, sm_scale, causal)
        return out, (lse if want_lse else None)
    return _flash_forward_cuda(q, k, v, sm_scale, causal, want_lse)


class _FlashAttention(torch.autograd.Function):
    """The JAX package's ``_flash`` custom_vjp (``_flash_fwd`` and
    ``_flash_bwd``) over (bh, T, d) tensors.

    Forward: ``_flash_impl``, asking for the LSE only when ``need_grad``
    (the caller's grad mode and ``requires_grad``: inside ``forward``
    grad mode is always off); then q, k, v, O and the LSE are saved.
    Backward: the plain version for CPU tensors, the two kernels for
    CUDA tensors.  The block arguments keep the JAX signature and change
    nothing; no gradient flows to them, ``sm_scale`` or ``causal``."""

    @staticmethod
    def forward(ctx, q, k, v, sm_scale, causal, block_q, block_k,
                need_grad):
        out, lse = _flash_impl(q, k, v, sm_scale, causal,
                               want_lse=need_grad)
        if need_grad:
            ctx.save_for_backward(q, k, v, out, lse)
            ctx.sm_scale, ctx.causal = sm_scale, causal
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, out, lse = ctx.saved_tensors
        if not g.is_contiguous() or g.data_ptr() % 16:  # as the kernels read
            g = g.clone(memory_format=torch.contiguous_format)
        if q.device.type == "cpu":
            grads = _flash_bwd_reference(q, k, v, g, out, lse, ctx.sm_scale,
                                         ctx.causal)
        else:
            grads = _flash_backward_cuda(q, k, v, g, out, lse, ctx.sm_scale,
                                         ctx.causal)
        return grads + (None,) * 5


def flash_attention(q, k, v, sm_scale=None, causal=False, block_q=512,
                    block_k=512):
    """Multi-head attention, flash-style, differentiable.

    q/k/v: (batch, heads, seq, head_dim) or (batch*heads, seq,
    head_dim).  Returns the same layout as the input.  A 4-D input is
    reshaped to (batch*heads, seq, head_dim), contiguous: a strided
    view (such as heads split by a transpose) becomes a copy there.

    ``block_q``/``block_k`` are kept for the JAX signature and do not
    change the result.  The CUDA kernels pick their own tiles (in bf16
    at head dims 64 and 128, the forward 128 query rows by 128-key
    tiles and the backward 128 rows by 64-wide column tiles; otherwise
    64 by 64); the TPU's block fitting (``_fit``) has no counterpart
    because the kernels mask ragged lengths themselves.

    The forward writes the LSE only when a gradient is needed (grad
    mode on and one of q, k, v requiring grad), so under ``no_grad`` or
    ``inference_mode`` it launches the forward alone.
    """
    squeeze4 = q.dim() == 4
    if squeeze4:
        b, h, t, d = q.shape
        # reshape alone can return a strided view (heads split by a
        # transpose at batch 1): the kernel reads row-major memory
        q = q.reshape(b * h, t, d).contiguous()
        k = k.reshape(b * h, k.shape[2], d).contiguous()
        v = v.reshape(b * h, v.shape[2], d).contiguous()
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(q.shape[-1])
    need_grad = torch.is_grad_enabled() and (
        q.requires_grad or k.requires_grad or v.requires_grad)
    out = _FlashAttention.apply(q, k, v, float(sm_scale), bool(causal),
                                block_q, block_k, need_grad)
    if squeeze4:
        out = out.reshape(b, h, t, d)
    return out


@register("_contrib_flash_attention")
def _contrib_flash_attention(q, k, v, sm_scale=None, causal=False,
                             block_q=512, block_k=512):
    """Flash attention over (batch, heads, seq, head_dim) inputs
    (:func:`flash_attention`: the kernels for CUDA tensors, their plain
    versions for CPU tensors).  On ``meta`` tensors, which shape
    inference passes, it gives the output's shape and nothing else."""
    if q.dim() != 4:
        raise MXNetError("_contrib_flash_attention expects "
                         "(batch, heads, seq, head_dim)")
    if q.device.type == "meta":
        return torch.empty_like(q)
    return flash_attention(q, k, v, sm_scale=sm_scale, causal=causal,
                           block_q=block_q, block_k=block_k)
