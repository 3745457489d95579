"""Flash attention forward: a hand-written CUDA kernel and its plain version.

Counterpart of ``mxtpu/ops/pallas_attention.py``: ``_flash_kernel`` (the
Pallas TPU kernel) becomes ``csrc/flash_fwd.cu`` (CUDA C++ for sm_90a,
built by :mod:`.kernel_build`), launched by :func:`_flash_forward_cuda`
(the analog of ``_flash_forward_pallas``); ``_reference_attention_lse``
is ported as the plain PyTorch version; ``_flash_impl`` routes between
them and :func:`flash_attention` keeps the 3-D/4-D public API.

Routing: a tensor on the CPU takes the plain version; a CUDA tensor
launches the kernel or raises.  There is no fallback from the kernel to
the plain version and no switch that turns the kernel off.

Numerics, in the kernel and the plain version alike (as in the JAX
package): operands enter both products in their own dtype with f32
accumulation, ``sm_scale`` multiplies the f32 scores, masked scores are
-1e30, the probabilities are rounded to V's dtype before P.V, the final
divide clamps the row sum at 1e-30, and O comes back in Q's dtype.  The
causal mask is top-left aligned (``q_idx >= k_idx``).

The backward (``_flash_bwd`` and its two Pallas kernels) is not ported
yet: this module serves the forward.
"""
from __future__ import annotations

import ctypes
import math

import torch

from ..base import MXNetError
from .kernel_build import CudaKernel

__all__ = ["flash_attention", "FLASH_FWD", "HEAD_DIMS"]

_NEG_INF = -1e30
HEAD_DIMS = (16, 32, 64, 128)
_KERNEL_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

_vp, _int = ctypes.c_void_p, ctypes.c_int
FLASH_FWD = CudaKernel(
    "flash_fwd.cu", "flash_fwd",
    # q, k, v, o, lse, bh, tq, tk, d, dtype, sm_scale, causal, stream
    [_vp, _vp, _vp, _vp, _vp, _int, _int, _int, _int, _int,
     ctypes.c_float, _int, _vp])


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
        if not t.is_contiguous():
            raise MXNetError("flash kernel: %s is not contiguous (strides "
                             "%s); reshape or .contiguous() it first"
                             % (name, t.stride()))
        if t.data_ptr() % 16:
            raise MXNetError("flash kernel: %s is not 16-byte aligned; "
                             ".clone() it first" % name)


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


def _flash_impl(q, k, v, sm_scale, causal, want_lse):
    """Returns (out, lse or None): the plain version for CPU tensors,
    the kernel for CUDA tensors.  The kernel masks ragged Tq/Tk itself,
    so unlike the TPU route nothing is padded and no length takes the
    plain version."""
    if q.device.type == "cpu":
        out, lse = _reference_attention_lse(q, k, v, sm_scale, causal)
        return out, (lse if want_lse else None)
    return _flash_forward_cuda(q, k, v, sm_scale, causal, want_lse)


def flash_attention(q, k, v, sm_scale=None, causal=False, block_q=512,
                    block_k=512):
    """Multi-head attention, flash-style (forward).

    q/k/v: (batch, heads, seq, head_dim) or (batch*heads, seq,
    head_dim).  Returns the same layout as the input.  A 4-D input is
    reshaped to (batch*heads, seq, head_dim), contiguous: a strided
    view (such as heads split by a transpose) becomes a copy there.

    ``block_q``/``block_k`` are kept for the JAX signature and do not
    change the result.  The CUDA kernel picks its own tiles (64 query
    rows by 64 key rows); the TPU's block fitting (``_fit``) has no
    counterpart because the kernel masks ragged lengths itself.
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
    out, _ = _flash_impl(q, k, v, float(sm_scale), bool(causal),
                         want_lse=False)
    if squeeze4:
        out = out.reshape(b, h, t, d)
    return out
