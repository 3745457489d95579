"""Ring attention of the PyTorch port: the single-device (sp=1) route.

Counterpart of ``mxtpu/parallel/ring_attention.py``: ``_online_block``,
``blockwise_attention``, ``ring_attention`` and ``ring_self_attention``.
At sp=1 with square q/k, ``ring_attention`` routes to
:func:`~mxtpu_torch.ops.flash_attention.flash_attention`, which launches
the CUDA kernels for CUDA tensors (its backward too, through the
autograd Function) and takes the plain versions on the CPU.  The
non-square blocked loop is differentiated by plain autograd; it is off
the training path.  The ring itself (K/V rotating over an "sp" axis of
several devices, and its recompute backward) waits for multi-GPU meshes
(ROADMAP A15); sp > 1 raises.
"""
from __future__ import annotations

from typing import Optional

import torch

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


def ring_attention(q, k, v, axis_name: str = AXIS_SP, causal: bool = False,
                   scale: Optional[float] = None, axis_size: int = 1):
    """Attention over a sequence sharded on ``axis_name``; q/k/v are the
    local shards [B, H, T_local, D].

    The JAX package reads the axis size from the enclosing shard_map;
    the port has none, so the caller states it.  Only ``axis_size=1``
    runs: the degenerate ring, where square attention goes to the flash
    kernel (plain version on the CPU) exactly as the JAX package routes
    it.  A larger ring raises until multi-GPU meshes land."""
    if axis_size != 1:
        raise NotImplementedError(
            "ring_attention over %s=%d needs several devices: the ring "
            "forward/backward waits for multi-GPU meshes (ROADMAP A15)"
            % (axis_name, axis_size))
    if scale is None:
        scale = 1.0 / (q.shape[-1] ** 0.5)
    return blockwise_attention(q, k, v, causal=causal, scale=scale)


def ring_self_attention(x, wq, wk, wv, wo, n_heads: int,
                        axis_name: str = AXIS_SP, causal: bool = True):
    """Full self-attention layer: x [B, T, E]; wq/wk/wv [E, E],
    wo [E, E]."""
    B, T, E = x.shape
    D = wq.shape[1] // n_heads

    def split(h):
        return h.reshape(B, T, n_heads, D).transpose(1, 2)

    q = split(x @ wq)
    k = split(x @ wk)
    v = split(x @ wv)
    o = ring_attention(q, k, v, axis_name=axis_name, causal=causal)
    o = o.transpose(1, 2).reshape(B, T, n_heads * D)
    return o @ wo
