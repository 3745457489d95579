"""The bf16 arithmetic of the wgmma flash-attention backward, emulated tile
by tile on the CPU and held against the port's plain backward and the JAX
package's.

`mxtpu_torch/ops/csrc/flash_bwd.cu` runs bf16 at head dims 64 and 128 as
two kernels of one design.  A work item is a block of 128 "rows" (queries
in dq, keys in dk/dv), split between two warpgroups of 64, and loops over
64-wide "column" tiles (keys in dq, queries in dk/dv): dk/dv visits its
query tiles ascending from the block's first key, dq its key tiles
descending from the causal diagonal, and a warpgroup skips the tiles at
the front that lie wholly above its part of the diagonal, or every tile
if it has no row before the end.  Per tile: S and dP in f32,
P = 2^(s * sm_scale * log2(e) - lse * log2(e)) in one FFMA, P set to 0
where the tile meets a ragged end or the diagonal (decided for each warp
of 16 rows), dS = P (dP - delta) sm_scale in f32, and P and dS rounded
to bf16 before the accumulating products.  Rows and columns past a
ragged end read as zeros (TMA), with lse = delta = 0, and rows past the
end are not written.

The kernels themselves run only on the card (`chip_smoke.py`); here their
per-tile arithmetic is written out in torch and must keep to the bounds
`chip_smoke.py` holds them to: elementwise 2e-3 + 2^-6 of the sum before
it cancels (|dS| |K|, |dS|^T |Q|, P^T |G|) and a relative L2 error of at
most 1e-2 on each gradient.  With one column tile skipped, or one
warpgroup's diagonal tile left unmasked, it must not.
"""
import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mxtpu.ops import pallas_attention as jfa
from mxtpu_torch.ops import flash_attention as tfa

torch.set_num_threads(1)

BR, BC, WG = 128, 64, 64   # rows an item, columns a tile, rows a warpgroup
LOG2E = np.float32(math.log2(math.e))


def _ceil(a, b):
    return -(-a // b)


def _tiles(dkv, r0, tq, tk, causal):
    """The first column of each tile the item at row r0 visits, in order,
    and each warpgroup's number of skipped tiles at the front (the
    kernel's ``Item``)."""
    n_rows = tk if dkv else tq
    if dkv:
        c_begin = r0 if causal else 0
        n = _ceil(tq - c_begin, BC) if c_begin < tq else 0
        cols = [c_begin + j * BC for j in range(n)]
    else:
        n = _ceil(min(tk, r0 + BR) if causal else tk, BC)
        cols = [(n - 1 - j) * BC for j in range(n)]
    skips = []
    for cw in (0, 1):
        rw = r0 + WG * cw
        if rw >= n_rows:
            skips.append(n)
        elif not causal:
            skips.append(0)
        elif dkv:
            skips.append(min(cw, n))
        else:
            skips.append(n - _ceil(min(tk, rw + WG), BC))
    return cols, skips


def _pad(t, n):
    """t with zero rows up to n along dim 1 (TMA reads past the end as
    zeros; the stats of such rows and columns are 0)."""
    extra = n - t.shape[1]
    return torch.cat([t, t.new_zeros((t.shape[0], extra) + t.shape[2:])], 1)


def emulate_sweep(dkv, q, k, v, g, lse, delta, sm_scale, causal,
                  skip_tile=None, unmask_diagonal_of=None):
    """One kernel's arithmetic over bf16 (bh, T, d) operands: (dq,) or
    (dk, dv).  ``skip_tile`` leaves out the tile at that first column,
    ``unmask_diagonal_of`` leaves warpgroup 0's or 1's diagonal tile
    unmasked (planted faults)."""
    tq, tk = q.shape[1], k.shape[1]
    n_rows, n_cols = (tk, tq) if dkv else (tq, tk)
    rows_p, cols_p = _ceil(n_rows, BR) * BR, _ceil(n_cols, BC) * BC + BR
    x1, x2, c1, c2 = (k, v, q, g) if dkv else (q, g, k, v)
    x1, x2 = (_pad(t.float(), rows_p) for t in (x1, x2))
    c1, c2 = (_pad(t.float(), cols_p) for t in (c1, c2))
    stat_n = cols_p if dkv else rows_p
    nl = _pad(-lse * torch.tensor(LOG2E), stat_n)  # -lse * log2(e) in f32
    dl = _pad(delta, stat_n)
    scale = torch.tensor(sm_scale, dtype=torch.float32)
    c_log2 = (scale * torch.tensor(LOG2E)).double()
    outs = [torch.zeros(q.shape[0], n_rows, q.shape[2]) for _ in
            range(2 if dkv else 1)]
    for r0 in range(0, n_rows, BR):
        cols, skips = _tiles(dkv, r0, tq, tk, causal)
        for cw in (0, 1):
            rw = r0 + WG * cw
            rows = torch.arange(rw, rw + WG)
            acc = [torch.zeros(q.shape[0], WG, q.shape[2]) for _ in outs]
            for j, c0 in enumerate(cols):
                if j < skips[cw] or c0 == skip_tile:
                    continue
                cs = torch.arange(c0, c0 + BC)
                s = x1[:, rw:rw + WG] @ c1[:, c0:c0 + BC].transpose(1, 2)
                shift = nl[:, c0:c0 + BC][:, None, :] if dkv \
                    else nl[:, rw:rw + WG][:, :, None]
                # one FFMA (exact in f64, rounded once), then ex2
                p = torch.exp2((s.double() * c_log2 + shift.double()).float())
                # the mask, where this warp's 16 rows meet an end or the
                # diagonal
                rb = rows - rows % 16
                edge = torch.full((WG,), c0 + BC > n_cols)
                drop = (cs >= n_cols)[None, :].expand(WG, BC)
                if causal:
                    edge |= (c0 < rb + 15) if dkv else (c0 + BC - 1 > rb)
                    drop = drop | ((cs[None, :] < rows[:, None]) if dkv
                                   else (rows[:, None] < cs[None, :]))
                if unmask_diagonal_of == cw and c0 == rw:
                    edge[:] = False
                drop = edge[:, None] & drop
                p = p.masked_fill(drop, 0.0)
                dp = x2[:, rw:rw + WG] @ c2[:, c0:c0 + BC].transpose(1, 2)
                d_sh = dl[:, c0:c0 + BC][:, None, :] if dkv \
                    else dl[:, rw:rw + WG][:, :, None]
                ds = p * (dp - d_sh) * scale
                rnd = (lambda t: t.to(torch.bfloat16).float())
                acc[0] += rnd(ds) @ c1[:, c0:c0 + BC]
                if dkv:
                    acc[1] += rnd(p) @ c2[:, c0:c0 + BC]
            n = max(0, min(WG, n_rows - rw))
            for o, a in zip(outs, acc):
                o[:, rw:rw + n] = a[:, :n]
    return [o.to(torch.bfloat16) for o in outs]


def emulate(q, k, v, g, out, lse, sm_scale, causal, **fault):
    """(dq, dk, dv) as the two kernels compute them; ``fault`` goes to
    both sweeps."""
    delta = tfa._delta(out, g)
    dq, = emulate_sweep(False, q, k, v, g, lse, delta, sm_scale, causal,
                        **fault)
    dk, dv = emulate_sweep(True, q, k, v, g, lse, delta, sm_scale, causal,
                           **fault)
    return dq, dk, dv


def _inputs(bh, tq, tk, d, seed):
    rng = np.random.RandomState(seed)
    return [torch.from_numpy(rng.normal(0, 1, (bh, t, d)).astype(np.float32))
            .to(torch.bfloat16) for t in (tq, tk, tk, tq)]


def _scales(q, k, v, g, out, lse, sm_scale, causal):
    """chip_smoke.py's ``bwd_error_scales``: |dS||K|, |dS|^T|Q|, P^T|G|."""
    s = torch.einsum("bqd,bkd->bqk", q.float(), k.float()) * sm_scale
    if causal:
        s = s.masked_fill(torch.ones(s.shape[-2:], dtype=torch.bool)
                          .triu(1), float("-inf"))
    p = torch.exp(s - lse[..., None])
    dp = torch.einsum("bqd,bkd->bqk", g.float(), v.float())
    ds = (p * (dp - tfa._delta(out, g)[..., None]) * sm_scale).abs()
    return (ds @ k.float().abs(), ds.transpose(1, 2) @ q.float().abs(),
            p.transpose(1, 2) @ g.float().abs())


def _within(got, ref, scales):
    for a, b, s in zip(got, ref, scales):
        d = a.float() - b.float()
        if not (bool(torch.all(d.abs() <= 2e-3 + 2 ** -6 * s)) and
                (d.norm() / b.float().norm()).item() <= 1e-2):
            return False
    return True


def _case(bh, tq, tk, d, causal):
    q, k, v, g = _inputs(bh, tq, tk, d, seed=31)
    scale = d ** -0.5
    out, lse = tfa._reference_attention_lse(q, k, v, scale, causal)
    return q, k, v, g, out, lse, scale


def _to_jax(t):
    return jnp.asarray(t.float().numpy()).astype(jnp.bfloat16)


def _from_jax(a):
    return torch.from_numpy(np.array(jnp.asarray(a).astype(jnp.float32)))


CASES = [((2, 256, 128), 256, True), ((2, 130, 64), 190, False),
         ((3, 200, 128), 200, True)]


def _kept(dkv, causal, rows, cols):
    """The pairs the causal mask keeps: column >= row in dk/dv (queries
    at or after the key), column <= row in dq."""
    r, c = rows[:, None], cols[None, :]
    if not causal:
        return np.ones((len(rows), len(cols)), bool)
    return (c >= r) if dkv else (c <= r)


@pytest.mark.parametrize("dkv", [False, True])
def test_tile_ranges_cover_each_kept_pair_once(dkv):
    """Over every item and warpgroup, the tiles visited cover each
    (row, column) pair the mask keeps exactly once, and a warpgroup
    skips only tiles in which it keeps no pair."""
    for tq, tk in ((256, 256), (130, 190), (200, 200), (190, 130),
                   (64, 300), (1024, 1024)):
        for causal in (False, True):
            n_rows, n_cols = (tk, tq) if dkv else (tq, tk)
            seen = np.zeros((n_rows, n_cols), int)
            for r0 in range(0, n_rows, BR):
                cols, skips = _tiles(dkv, r0, tq, tk, causal)
                for cw in (0, 1):
                    rows = np.arange(r0 + WG * cw, min(r0 + WG * cw + WG,
                                                       n_rows))
                    for j, c0 in enumerate(cols):
                        cs = np.arange(c0, min(c0 + BC, n_cols))
                        if j >= skips[cw]:
                            seen[rows[:, None], cs[None, :]] += 1
                        else:
                            assert not _kept(dkv, causal, rows, cs).any()
            kept = _kept(dkv, causal, np.arange(n_rows), np.arange(n_cols))
            assert (seen[kept] == 1).all(), (tq, tk, causal)


@pytest.mark.parametrize("shape,tk,causal", CASES)
def test_tiled_bf16_backward_keeps_to_the_chip_bounds(shape, tk, causal,
                                                      monkeypatch):
    """Against the port's plain backward, and against the JAX package's:
    its Pallas backward kernels in interpret mode where the lengths
    divide the blocks, its f32 sweeps (where it sends ragged lengths)
    otherwise, as `test_ragged_bf16_gradients_against_jax_f32_sweeps`
    does."""
    bh, tq, d = shape
    q, k, v, g, out, lse, scale = _case(bh, tq, tk, d, causal)
    got = emulate(q, k, v, g, out, lse, scale, causal)
    assert [t.shape for t in got] == [q.shape, k.shape, v.shape]
    scales = _scales(q, k, v, g, out, lse, scale, causal)
    ref = tfa._flash_bwd_reference(q, k, v, g, out, lse, scale, causal)
    assert _within(got, ref, scales)
    if tq % BR == 0 and tk % BR == 0:
        monkeypatch.setenv("MXTPU_PALLAS_INTERPRET", "1")
        jref = jfa._flash_backward_pallas(
            *(_to_jax(t) for t in (q, k, v, g, out)),
            jnp.asarray(lse.numpy()), scale, causal, BR, BR)
    else:
        def loss(q_, k_, v_):
            return jnp.sum(jfa.flash_attention(q_, k_, v_, causal=causal)
                           .astype(jnp.float32)
                           * _to_jax(g).astype(jnp.float32))
        jref = jax.grad(loss, argnums=(0, 1, 2))(
            *(_to_jax(t) for t in (q, k, v)))
    assert _within(got, [_from_jax(a) for a in jref], scales)


@pytest.mark.parametrize("shape,tk,causal", CASES)
def test_a_skipped_column_tile_breaks_the_bounds(shape, tk, causal):
    bh, tq, d = shape
    q, k, v, g, out, lse, scale = _case(bh, tq, tk, d, causal)
    ref = tfa._flash_bwd_reference(q, k, v, g, out, lse, scale, causal)
    scales = _scales(q, k, v, g, out, lse, scale, causal)
    got = emulate(q, k, v, g, out, lse, scale, causal, skip_tile=BC)
    assert not _within(got, ref, scales)


@pytest.mark.parametrize("cw", [0, 1])
@pytest.mark.parametrize("shape,tk", [((2, 256, 128), 256),
                                      ((3, 200, 128), 200)])
def test_an_unmasked_diagonal_tile_breaks_the_bounds(shape, tk, cw):
    bh, tq, d = shape
    q, k, v, g, out, lse, scale = _case(bh, tq, tk, d, True)
    ref = tfa._flash_bwd_reference(q, k, v, g, out, lse, scale, True)
    scales = _scales(q, k, v, g, out, lse, scale, True)
    got = emulate(q, k, v, g, out, lse, scale, True, unmask_diagonal_of=cw)
    assert not _within(got, ref, scales)
