"""Ring attention of the PyTorch port.

Counterpart of ``mxtpu/parallel/ring_attention.py``: ``_online_block``,
``blockwise_attention``, ``_ring_forward``, ``_ring_backward`` and their
custom VJP, ``ring_attention`` and ``ring_self_attention``.

At sp = 1 with square q/k, ``ring_attention`` routes to
:func:`~mxtpu_torch.ops.flash_attention.flash_attention`, which launches
the CUDA kernels for CUDA tensors (its backward too) and takes the plain
versions on the CPU.  The non-square blocked loop is differentiated by
plain autograd; it is off the training path.

At sp > 1 the caller hands over one sp group's shards (lists in ring
order, each [B, H, T_local, D] on its own device) and
:class:`_RingAttention` runs the ring over them, one controller for
every shard.  Query shard i meets key/value shard j on i's device:

* CUDA tensors launch the flash kernels block by block.  Forward: the
  forward kernel with the LSE, ``causal`` on the diagonal block (j ==
  i) and unmasked below it (j < i); a block above it (j > i, causal) is
  skipped: the JAX package's -1e30 bias makes its contribution exactly
  0.  The blocks merge in f32: lse = logsumexp_j lse_j, out =
  sum_j exp(lse_j - lse) o_j.  Backward: ``flash_bwd_dq`` and
  ``flash_bwd_dkv`` on the same pairs with the GLOBAL lse and delta =
  rowsum(out * g) of query shard i (``_ring_backward``'s per-step
  terms), summed in f32.  The kernels write each block's o_j and
  gradients in the inputs' dtype, where the JAX package keeps one f32
  accumulator: in bf16 that rounds each partial once more.
* CPU tensors take the plain ring: ``_online_block`` over the visiting
  shards in ring order (the JAX code's einsum form) and its recompute
  backward, written out.  On the card it is the kernels' reference,
  never their fallback.
"""
from __future__ import annotations

from typing import Optional

import torch

from ..base import MXNetError
from ..ops import flash_attention as fa
from ..ops.flash_attention import flash_attention
from .mesh import AXIS_SP

__all__ = ["ring_attention", "blockwise_attention", "ring_self_attention"]

_NEG_INF = -1e30


def _online_block(q, k, v, acc, row_max, row_sum, mask_bias, scale):
    """One flash-attention accumulation step.

    q: [B, H, Tq, D]; k, v: [B, H, Tk, D]; acc: [B, H, Tq, D] f32;
    row_max/row_sum: [B, H, Tq] f32.  Returns updated (acc, row_max,
    row_sum).  Products take bf16 operands widened to f32 (exact), i.e.
    f32 accumulation; the probability block enters P.V in v's dtype."""
    scores = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * scale
    if mask_bias is not None:
        scores = scores + mask_bias
    new_max = torch.maximum(row_max, scores.amax(dim=-1))
    correction = torch.exp(row_max - new_max)
    p = torch.exp(scores - new_max[..., None])
    new_sum = row_sum * correction + p.sum(dim=-1)
    new_acc = acc * correction[..., None] + torch.einsum(
        "bhqk,bhkd->bhqd", p.to(v.dtype).float(), v.float())
    return new_acc, new_max, new_sum


def blockwise_attention(q, k, v, block_size: int = 512,
                        causal: bool = False, scale: Optional[float] = None):
    """Attention via a blocked online softmax over K/V blocks.

    q, k, v: [B, H, T, D] (q may have another T than k/v).  The square
    case goes to :func:`flash_attention`: the CUDA kernel for CUDA
    tensors, its plain version on the CPU.  Otherwise a Python loop over
    ``block_size`` key blocks accumulates in f32; there the queries are
    the LAST Tq positions of the key sequence (the decode alignment of
    the JAX package).  Returns q's dtype.
    """
    scale = scale if scale is not None else 1.0 / (q.shape[-1] ** 0.5)
    if q.shape[2] == k.shape[2]:
        return flash_attention(q, k, v, sm_scale=scale, causal=causal,
                               block_q=block_size, block_k=block_size)
    return _blockwise_loop(q, k, v, block_size, causal, scale)


def _blockwise_loop(q, k, v, block_size, causal, scale):
    """The blocked online softmax of :func:`blockwise_attention`, for
    any Tq <= Tk (queries aligned to the end of the keys)."""
    B, H, Tq, D = q.shape
    Tk = k.shape[2]
    block_size = min(block_size, Tk)
    dev = q.device
    acc = torch.zeros((B, H, Tq, D), dtype=torch.float32, device=dev)
    m = torch.full((B, H, Tq), _NEG_INF, dtype=torch.float32, device=dev)
    s = torch.zeros((B, H, Tq), dtype=torch.float32, device=dev)
    q_pos = (Tk - Tq) + torch.arange(Tq, device=dev)
    for start in range(0, Tk, block_size):
        kb = k[:, :, start:start + block_size]
        vb = v[:, :, start:start + block_size]
        k_pos = start + torch.arange(kb.shape[2], device=dev)
        bias = None
        if causal:
            bias = torch.where(k_pos[None, :] > q_pos[:, None],
                               _NEG_INF, 0.0)[None, None]
        acc, m, s = _online_block(q, kb, vb, acc, m, s, bias, scale)
    out = acc / torch.clamp(s, min=1e-30)[..., None]
    return out.to(q.dtype)


def _causal_bias(q_len, k_len, device):
    """The diagonal block's causal bias: -1e30 where key > query."""
    q_pos = torch.arange(q_len, device=device)
    k_pos = torch.arange(k_len, device=device)
    return torch.where(k_pos[None, :] > q_pos[:, None], _NEG_INF,
                       0.0)[None, None]


def _visits(i, n, causal):
    """The key/value shards query shard i meets, in ring order (the
    shard visiting at step s came from rank i - s); with ``causal`` the
    ones past i are dropped, as their blocks add exactly 0."""
    srcs = [(i - s) % n for s in range(n)]
    return [j for j in srcs if not causal or j <= i]


def _ring_forward_plain(qs, ks, vs, causal, scale):
    """``_ring_forward`` on (B, H, T, D) shards: (outs, lses), each
    lse = m + log(s) in f32."""
    outs, lses = [], []
    for i, q in enumerate(qs):
        B, H, T, D = q.shape
        dev = q.device
        acc = torch.zeros((B, H, T, D), dtype=torch.float32, device=dev)
        m = torch.full((B, H, T), _NEG_INF, dtype=torch.float32, device=dev)
        s = torch.zeros((B, H, T), dtype=torch.float32, device=dev)
        for j in _visits(i, len(qs), causal):
            bias = _causal_bias(T, T, dev) if causal and j == i else None
            acc, m, s = _online_block(q, ks[j].to(dev), vs[j].to(dev), acc,
                                      m, s, bias, scale)
        s = torch.clamp(s, min=1e-30)
        outs.append((acc / s[..., None]).to(q.dtype))
        lses.append(m + torch.log(s))
    return outs, lses


def _ring_backward_plain(qs, ks, vs, outs, lses, gs, causal, scale):
    """``_ring_backward``: each kept (i, j) pair's terms from the saved
    global lse, P and dS rounded to the activation dtype before their
    products, f32 accumulators; returns (dqs, dks, dvs) in the inputs'
    dtypes."""
    n = len(qs)
    dqs = [torch.zeros(q.shape, dtype=torch.float32, device=q.device)
           for q in qs]
    dks = [torch.zeros(k.shape, dtype=torch.float32, device=k.device)
           for k in ks]
    dvs = [torch.zeros(v.shape, dtype=torch.float32, device=v.device)
           for v in vs]
    for i in range(n):
        q, g, lse = qs[i].float(), gs[i].float(), lses[i]
        dev, lp = qs[i].device, qs[i].dtype
        delta = (outs[i].float() * g).sum(-1)
        for j in _visits(i, n, causal):
            k, v = ks[j].to(dev).float(), vs[j].to(dev).float()
            s = torch.einsum("bhqd,bhkd->bhqk", q, k) * scale
            if causal and j == i:
                s = s + _causal_bias(s.shape[-2], s.shape[-1], dev)
            p = torch.exp(s - lse[..., None])
            dp = torch.einsum("bhqd,bhkd->bhqk", g, v)
            ds = p * (dp - delta[..., None]) * scale
            ds_lp, p_lp = ds.to(lp).float(), p.to(lp).float()
            dqs[i] += torch.einsum("bhqk,bhkd->bhqd", ds_lp, k)
            dks[j] += torch.einsum("bhqk,bhqd->bhkd", ds_lp, q).to(
                dks[j].device)
            dvs[j] += torch.einsum("bhqk,bhqd->bhkd", p_lp, g).to(
                dvs[j].device)
    return ([d.to(x.dtype) for d, x in zip(dqs, qs)],
            [d.to(x.dtype) for d, x in zip(dks, ks)],
            [d.to(x.dtype) for d, x in zip(dvs, vs)])


def _bhtd(x):
    """(B, H, T, D) as the kernels' contiguous, 16-byte aligned
    (B * H, T, D)."""
    B, H, T, D = x.shape
    x = x.reshape(B * H, T, D).contiguous()
    return x if x.data_ptr() % 16 == 0 else x.clone()


def _pair_backward_cuda(q, k, v, g, o, lse, delta, scale, causal):
    """One (query shard, key/value shard) pair's dq, dk and dv: a launch
    of ``flash_bwd_dq`` and one of ``flash_bwd_dkv`` with the given
    (global) lse and delta.  Raises off the card."""
    if q.device.type != "cuda":
        raise MXNetError("flash kernel: tensors must be on a CUDA device, "
                         "got %s" % q.device)
    fa._check_bwd_args(q, k, v, g, o, lse)
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    fa._bwd_launch(fa.FLASH_BWD_DQ, q, k, v, g, lse, delta, (dq,), scale,
                   causal)
    fa._bwd_launch(fa.FLASH_BWD_DKV, q, k, v, g, lse, delta, (dk, dv), scale,
                   causal)
    return dq, dk, dv


def _ring_forward_cuda(qs, ks, vs, causal, scale):
    """The forward on the card: one forward-kernel launch with the LSE
    per kept block, merged in f32.  Returns (outs (B, H, T, D), lses
    (B*H, T) f32)."""
    k3, v3 = [_bhtd(k) for k in ks], [_bhtd(v) for v in vs]
    outs, lses = [], []
    for i, q4 in enumerate(qs):
        q, dev = _bhtd(q4), q4.device
        blocks = [fa._flash_forward_cuda(q, k3[j].to(dev), v3[j].to(dev),
                                         scale, causal and j == i,
                                         want_lse=True)
                  for j in _visits(i, len(qs), causal)]
        lse = torch.logsumexp(torch.stack([b[1] for b in blocks]), 0)
        out = sum(torch.exp(l - lse)[..., None] * o.float()
                  for o, l in blocks)
        outs.append(out.to(q.dtype).reshape(q4.shape))
        lses.append(lse)
    return outs, lses


def _ring_backward_cuda(qs, ks, vs, outs, lses, gs, causal, scale):
    """The backward on the card: for each kept pair, ``flash_bwd_dq`` and
    ``flash_bwd_dkv`` with query shard i's global lse and delta, their
    outputs summed in f32 on each shard's device."""
    q3, k3, v3 = ([_bhtd(x) for x in xs] for xs in (qs, ks, vs))
    o3, g3 = [_bhtd(o) for o in outs], [_bhtd(g) for g in gs]
    dqs, dks, dvs = ([torch.zeros(x.shape, dtype=torch.float32,
                                  device=x.device) for x in xs]
                     for xs in (q3, k3, v3))
    for i in range(len(qs)):
        q, o, g, lse, dev = q3[i], o3[i], g3[i], lses[i], q3[i].device
        delta = fa._delta(o, g)
        for j in _visits(i, len(qs), causal):
            dq, dk, dv = _pair_backward_cuda(q, k3[j].to(dev), v3[j].to(dev),
                                             g, o, lse, delta, scale,
                                             causal and j == i)
            dqs[i] += dq.float()
            dks[j] += dk.float().to(dks[j].device)
            dvs[j] += dv.float().to(dvs[j].device)
    return tuple([d.to(x.dtype).reshape(x.shape) for d, x in zip(ds, xs)]
                 for ds, xs in ((dqs, qs), (dks, ks), (dvs, vs)))


class _RingAttention(torch.autograd.Function):
    """The ring's custom VJP (``_ring_fwd_rule``/``_ring_bwd_rule``)
    over one sp group: ``apply(causal, scale, n, *qs, *ks, *vs)`` returns
    the n output shards.  The forward saves the shards, the outputs and
    the per-row lse; the backward is a second sweep over the same
    pairs.  The route follows the shards: CPU tensors the plain ring,
    CUDA tensors the kernels."""

    @staticmethod
    def forward(ctx, causal, scale, n, *tensors):
        qs, ks, vs = (list(tensors[a * n:(a + 1) * n]) for a in range(3))
        cpu = qs[0].device.type == "cpu"
        fwd = _ring_forward_plain if cpu else _ring_forward_cuda
        outs, lses = fwd(qs, ks, vs, causal, scale)
        ctx.save_for_backward(*qs, *ks, *vs, *outs, *lses)
        ctx.causal, ctx.scale, ctx.n, ctx.cpu = causal, scale, n, cpu
        return tuple(outs)

    @staticmethod
    def backward(ctx, *gs):
        n = ctx.n
        saved = ctx.saved_tensors
        qs, ks, vs, outs, lses = (list(saved[a * n:(a + 1) * n])
                                  for a in range(5))
        gs = [torch.zeros_like(o) if g is None else g
              for g, o in zip(gs, outs)]
        bwd = _ring_backward_plain if ctx.cpu else _ring_backward_cuda
        dqs, dks, dvs = bwd(qs, ks, vs, outs, lses, gs, ctx.causal,
                            ctx.scale)
        return (None, None, None) + tuple(dqs) + tuple(dks) + tuple(dvs)


def ring_attention(q, k, v, axis_name: str = AXIS_SP, causal: bool = False,
                   scale: Optional[float] = None,
                   axis_size: Optional[int] = None):
    """Attention over a sequence sharded on ``axis_name``.

    At sp > 1, q, k and v are lists of one sp group's shards in ring
    order, each [B, H, T_local, D] on its own device; the result is the
    list of output shards (:class:`_RingAttention`; causal masking by
    global positions).  The JAX package reads the axis size from the
    enclosing shard_map; here it is the lists' length, and
    ``axis_size``, when given, must agree.  A single tensor (or a list
    of one) is the degenerate ring, sp = 1: square attention goes to
    :func:`flash_attention` (the kernels for CUDA tensors, the plain
    versions on the CPU)."""
    if isinstance(q, (list, tuple)):
        n = len(q)
        if not n == len(k) == len(v) or axis_size not in (None, n):
            raise MXNetError(
                "ring_attention over %s: %d q, %d k and %d v shards for "
                "axis_size %s" % (axis_name, n, len(k), len(v), axis_size))
        if scale is None:
            scale = 1.0 / (q[0].shape[-1] ** 0.5)
        if n == 1:
            return [blockwise_attention(q[0], k[0], v[0], causal=causal,
                                        scale=scale)]
        return list(_RingAttention.apply(bool(causal), float(scale), n,
                                         *q, *k, *v))
    if axis_size not in (None, 1):
        raise MXNetError(
            "ring_attention over %s=%d takes the group's %d shards as "
            "lists (q, k and v, each in ring order)"
            % (axis_name, axis_size, axis_size))
    if scale is None:
        scale = 1.0 / (q.shape[-1] ** 0.5)
    return blockwise_attention(q, k, v, causal=causal, scale=scale)


def ring_self_attention(x, wq, wk, wv, wo, n_heads: int,
                        axis_name: str = AXIS_SP, causal: bool = True):
    """Full self-attention layer: x [B, T, E] (or, at sp > 1, the list of
    an sp group's shards [B, T_local, E]); wq/wk/wv [E, E], wo [E, E],
    replicated (each shard uses a copy on its device)."""
    shards = isinstance(x, (list, tuple))
    xs = list(x) if shards else [x]

    def split(x, w):
        B, T, _ = x.shape
        h = x @ w.to(x.device)
        return h.reshape(B, T, n_heads, w.shape[1] // n_heads).transpose(1, 2)

    q = [split(xi, wq) for xi in xs]
    k = [split(xi, wk) for xi in xs]
    v = [split(xi, wv) for xi in xs]
    o = ring_attention(q, k, v, axis_name=axis_name, causal=causal)
    out = [oi.transpose(1, 2).reshape(xi.shape[0], xi.shape[1], -1)
           @ wo.to(xi.device) for oi, xi in zip(o, xs)]
    return out if shards else out[0]
