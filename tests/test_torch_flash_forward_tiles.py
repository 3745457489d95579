"""The bf16 arithmetic of the wgmma flash-attention forward, emulated tile
by tile on the CPU and held against both plain versions.

`mxtpu_torch/ops/csrc/flash_fwd.cu` runs bf16 at head dims 64 and 128 as
a block of 128 query rows looping over 128-key tiles, from the last key
tile to the first (so only the first one processed can need a mask):
S = Q K^T in f32,
the row max taken in the log2 domain (m = max(s * sm_scale * log2(e))),
p = 2^(s * sm_scale * log2(e) - m) in one FFMA, P rounded to bf16 at each
tile's running max before P V, the running sum kept in f32, the final
divide with l clamped at 1e-30, and the LSE taken back to the natural log
(m * ln 2 + log l).  The kernel itself runs only on the card
(`chip_smoke.py`); here its per-tile arithmetic is written out in torch
and must keep to the bounds `chip_smoke.py` holds the kernel to, against
the port's `_reference_attention_lse` and the JAX package's: elementwise
2e-3 + 2^-6 * (P |V|) / l, a relative L2 error of at most 1e-2, and
2e-5 + 2e-4 |lse| on the LSE.  With one key tile skipped it must not.
"""
import math

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from mxtpu.ops import pallas_attention as jfa
from mxtpu_torch.ops import flash_attention as tfa

BQ = BK = 128
LOG2E = np.float32(math.log2(math.e))
LN2 = np.float32(math.log(2.0))


def emulate(q, k, v, sm_scale, causal, skip_tile=None):
    """The kernel's arithmetic over (bh, Tq, d) x (bh, Tk, d) bf16;
    returns (out bf16, lse f32).  ``skip_tile`` leaves that key tile out
    (a planted fault)."""
    bh, tq, d = q.shape
    tk = k.shape[1]
    c = torch.tensor(sm_scale, dtype=torch.float32) * torch.tensor(LOG2E)
    out = torch.empty_like(q)
    lse = torch.empty(bh, tq)
    for q0 in range(0, tq, BQ):
        rows = torch.arange(q0, min(q0 + BQ, tq))
        qt = q[:, rows].float()
        m = torch.full((bh, len(rows)), -1e30)
        l = torch.zeros(bh, len(rows))
        acc = torch.zeros(bh, len(rows), d)
        k_end = min(tk, q0 + BQ) if causal else tk
        for k0 in reversed(range(0, k_end, BK)):
            if k0 // BK == skip_tile:
                continue
            keys = torch.arange(k0, min(k0 + BK, tk))
            s = qt @ k[:, keys].float().transpose(1, 2)
            if causal:
                s = s.masked_fill(rows[:, None] < keys[None, :],
                                  float("-inf"))
            m_new = torch.maximum(m, c * s.amax(-1))
            alpha = torch.exp2(m - m_new)
            # one FFMA: s * c - m rounded once (exact in f64, then f32)
            p = torch.exp2((s.double() * c.double()
                            - m_new[..., None].double()).float())
            l = alpha * l + p.sum(-1)
            acc = acc * alpha[..., None] \
                + p.to(torch.bfloat16).float() @ v[:, keys].float()
            m = m_new
        lc = l.clamp_min(1e-30)
        out[:, rows] = (acc / lc[..., None]).to(torch.bfloat16)
        lse[:, rows] = m * torch.tensor(LN2) + torch.log(lc)
    return out, lse


def _inputs(bh, tq, tk, d, seed):
    rng = np.random.RandomState(seed)
    return [torch.from_numpy(rng.normal(0, 1, (bh, t, d)).astype(np.float32))
            .to(torch.bfloat16) for t in (tq, tk, tk)]


def _within(out, lse, q, k, v, scale, causal, ref_o, ref_l):
    """chip_smoke.py's bf16 bounds on out and the LSE against a plain
    version's (ref_o, ref_l); the error scale (P |V|) / l is taken from
    the port's plain LSE, as chip_smoke.py takes it."""
    _, l_port = tfa._reference_attention_lse(q, k, v, scale, causal)
    s = torch.einsum("bqd,bkd->bqk", q.float(), k.float()) * scale
    if causal:
        s = s.masked_fill(torch.ones(s.shape[-2:], dtype=torch.bool)
                          .triu(1), float("-inf"))
    bound = 2e-3 + 2 ** -6 * (torch.exp(s - l_port[..., None])
                              @ v.float().abs())
    diff = out.float() - ref_o.float()
    rel_l2 = (diff.norm() / ref_o.float().norm()).item()
    lse_ok = bool(torch.all((lse - ref_l).abs()
                            <= 2e-5 + 2e-4 * ref_l.abs()))
    return bool(torch.all(diff.abs() <= bound)) and rel_l2 <= 1e-2 \
        and lse_ok


CASES = [((4, 256, 128), 256, True), ((4, 256, 128), 256, False),
         ((2, 200, 128), 330, False)]


@pytest.mark.parametrize("shape,tk,causal", CASES)
def test_tiled_bf16_forward_keeps_to_the_chip_bounds(shape, tk, causal):
    bh, tq, d = shape
    q, k, v = _inputs(bh, tq, tk, d, seed=21)
    scale = d ** -0.5
    out, lse = emulate(q, k, v, scale, causal)
    assert out.dtype == torch.bfloat16 and lse.shape == (bh, tq)
    ref_o, ref_l = tfa._reference_attention_lse(q, k, v, scale, causal)
    assert _within(out, lse, q, k, v, scale, causal, ref_o, ref_l)
    jo, jl = jfa._reference_attention_lse(
        *(jnp.asarray(t.float().numpy(), dtype=jnp.bfloat16)
          for t in (q, k, v)), scale, causal)
    assert _within(out, lse, q, k, v, scale, causal,
                   torch.from_numpy(np.asarray(jo).astype(np.float32)),
                   torch.from_numpy(np.array(jl)))


@pytest.mark.parametrize("shape,tk,causal", CASES)
def test_a_skipped_key_tile_breaks_the_bounds(shape, tk, causal):
    bh, tq, d = shape
    q, k, v = _inputs(bh, tq, tk, d, seed=21)
    scale = d ** -0.5
    out, lse = emulate(q, k, v, scale, causal, skip_tile=1)
    ref_o, ref_l = tfa._reference_attention_lse(q, k, v, scale, causal)
    assert not _within(out, lse, q, k, v, scale, causal, ref_o, ref_l)
