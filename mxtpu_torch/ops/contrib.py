"""Detection ops of the PyTorch port (counterpart of
``mxtpu/ops/contrib.py``): ``ROIPooling``, ``_contrib_ROIAlign``, the box
ops (``_contrib_box_iou``, ``_contrib_box_nms``,
``_contrib_bipartite_matching``), ``_contrib_MultiBoxPrior``,
``_contrib_SyncBatchNorm`` and ``_contrib_arange_like``, with the helpers
that :mod:`.vision` and :mod:`.rcnn` share: the IoU matrix and the exact
greedy suppression over score-sorted boxes (:func:`greedy_dead`).

Outputs are static-shaped, as in the JAX package: NMS replaces a
suppressed row by -1 rather than dropping it, so no op reads a count on
the host to size its output.

* ``ROIPooling`` keeps the JAX package's function: ROI corners rounded
  (half to even), ``rw, rh >= 1``, the floor/ceil bin edges, a bin
  outside the image or of no pixel gives 0.  The JAX package builds a
  masked ``(C, H, W)`` max for every ROI and bin at once; here the max
  is separable, over each row bin and then each column bin, so a
  Faster R-CNN head (128 ROIs of a 512 x 37 x 62 map) holds one
  ``(R, C, H, W)`` temporary at a time.  Its gradient
  (``_ROIPoolFn``) gives each bin's head gradient in equal parts to
  every element of the bin equal to the bin's max, as the VJP of XLA's
  ``reduce_max`` does; two chained ``amax`` calls would not.
* ``_contrib_box_nms`` and the NMS of :mod:`.vision` and :mod:`.rcnn`
  sort by score with a stable sort (ties by the lower index, as
  ``jnp.argsort`` and ``lax.top_k``) and suppress in tiles of
  ``NMS_TILE`` boxes (:func:`greedy_dead`): the same keep mask as the
  sequential greedy loop, with one host read per tile to see the
  tile's fixpoint reached.
* The IoU is computed in the JAX package's order (max/min, clamp,
  product, divide by ``max(union, 1e-12)``), so threshold comparisons
  decide alike; ``torch.maximum`` against 0 splits the gradient at a
  tie, as ``jnp.maximum`` does.
"""
from __future__ import annotations

import numpy as np
import torch

from .registry import register

# boxes a tile of the blocked greedy suppression
NMS_TILE = 256
# fixpoint sweeps between two host reads of the tile's convergence
NMS_SWEEPS = 8


def _max0(x, floor=0.0):
    """``jnp.maximum(x, floor)``: at a tie each side takes half the
    gradient (torch.clamp would pass all of it)."""
    return torch.maximum(x, x.new_full((), floor))


# ---------------------------------------------------------------------------
# ROI pooling
# ---------------------------------------------------------------------------

def _roi_index(rois, n):
    """The ROIs' image indices (truncated, as ``astype(int32)``), with
    JAX's negative wrap and clamp of a gather index."""
    b = rois[:, 0].to(torch.int64)
    b = torch.where(b < 0, b + n, b)
    return b.clamp(0, n - 1)


def _roi_bin_masks(rois, pooled_size, spatial_scale, hh, ww):
    """(row mask (R, ph, H), column mask (R, pw, W)) of every bin."""
    ph, pw = pooled_size
    dev = rois.device

    def corner(k):
        return torch.round(rois[:, k] * spatial_scale).to(torch.int64)

    x1, y1, x2, y2 = corner(1), corner(2), corner(3), corner(4)
    rw = torch.clamp(x2 - x1 + 1, min=1)
    rh = torch.clamp(y2 - y1 + 1, min=1)

    def masks(lo, extent, bins, size):
        i = torch.arange(bins, device=dev)
        start = lo[:, None] + torch.div(i[None, :] * extent[:, None], bins,
                                        rounding_mode="floor")
        end = lo[:, None] + torch.div((i[None, :] + 1) * extent[:, None]
                                      + bins - 1, bins,
                                      rounding_mode="floor")
        at = torch.arange(size, device=dev)
        return (at >= start[:, :, None]) & (at < end[:, :, None])

    return masks(y1, rh, ph, hh), masks(x1, rw, pw, ww)


class _ROIPoolFn(torch.autograd.Function):
    """Max over each bin, separably (over the bin's rows, then its
    columns); backward splits a bin's gradient evenly over its tied
    maxima.

    A bin's tie count is separable too: an element of the bin equals the
    bin's max m exactly where it equals its column's max over the bin's
    rows (``rowmax``) and that column max equals m.  So the count is the
    sum over the bin's columns with ``rowmax == m`` of how many rows tie
    in that column (``rowcnt``), and the gradient goes first to
    ``rowmax``'s tied entries, then down to the tied rows: ``ph`` passes
    over the (R, C, H, W) map and ``pw`` over the small (R, C, ph, W)
    one, where a pass per bin would take ``ph * pw`` over the map."""

    @staticmethod
    def forward(ctx, data, rois, pooled_size, spatial_scale):
        n, c, hh, ww = data.shape
        ph, pw = pooled_size
        b = _roi_index(rois, n)
        rows, cols = _roi_bin_masks(rois, pooled_size, spatial_scale, hh, ww)
        img = data.index_select(0, b)                     # (R, C, H, W)
        neg = torch.tensor(float("-inf"), dtype=data.dtype,
                           device=data.device)
        rowmax = torch.stack(
            [torch.where(rows[:, iy, None, :, None], img, neg).amax(2)
             for iy in range(ph)], dim=2)                 # (R, C, ph, W)
        out = torch.stack(
            [torch.where(cols[:, ix, None, None, :], rowmax, neg).amax(3)
             for ix in range(pw)], dim=3)                 # (R, C, ph, pw)
        filled = rows.any(2)[:, :, None] & cols.any(2)[:, None, :]
        out = torch.where(filled[:, None], out,
                          torch.zeros((), dtype=data.dtype,
                                      device=data.device))
        ctx.save_for_backward(data, rois, rowmax, out)
        ctx.attrs = (pooled_size, spatial_scale)
        return out

    @staticmethod
    def backward(ctx, g):
        data, rois, rowmax, out = ctx.saved_tensors
        pooled_size, spatial_scale = ctx.attrs
        n, c, hh, ww = data.shape
        ph, pw = pooled_size
        b = _roi_index(rois, n)
        rows, cols = _roi_bin_masks(rois, pooled_size, spatial_scale, hh, ww)
        img = data.index_select(0, b)

        def tied_rows(iy):                                # (R, C, H, W)
            return (img == rowmax[:, :, iy, None, :]) & \
                rows[:, iy, None, :, None]

        rowcnt = torch.stack([tied_rows(iy).sum(2) for iy in range(ph)],
                             dim=2).to(g.dtype)           # (R, C, ph, W)
        share = torch.zeros_like(rowmax, dtype=g.dtype)
        for ix in range(pw):
            tied = ((rowmax == out[:, :, :, ix, None])
                    & cols[:, None, None, ix, :]).to(g.dtype)
            cnt = (tied * rowcnt).sum(3)                  # (R, C, ph)
            share += tied * (g[:, :, :, ix] / torch.clamp(cnt, min=1))[
                ..., None]
        gimg = torch.zeros_like(img, dtype=g.dtype)
        for iy in range(ph):
            gimg += tied_rows(iy).to(g.dtype) * share[:, :, iy, None, :]
        return (torch.zeros_like(data).index_add_(0, b, gimg), None, None,
                None)


@register("ROIPooling")
def _roi_pooling(data, rois, pooled_size=(1, 1), spatial_scale=1.0):
    """rois: (R, 5) [batch_idx, x1, y1, x2, y2] in image coords."""
    return _ROIPoolFn.apply(data, rois, tuple(int(p) for p in pooled_size),
                            float(spatial_scale))


@register("_contrib_ROIAlign")
def _roi_align(data, rois, pooled_size=(1, 1), spatial_scale=1.0,
               sample_ratio=-1, position_sensitive=False, aligned=False):
    ph, pw = (int(p) for p in pooled_size)
    n, c, hh, ww = data.shape
    off = 0.5 if aligned else 0.0
    sr = sample_ratio if sample_ratio > 0 else 2
    b = _roi_index(rois, n)
    x1 = rois[:, 1] * spatial_scale - off
    y1 = rois[:, 2] * spatial_scale - off
    x2 = rois[:, 3] * spatial_scale - off
    y2 = rois[:, 4] * spatial_scale - off
    bin_h = _max0(y2 - y1, 1.0) / ph
    bin_w = _max0(x2 - x1, 1.0) / pw

    def samples(lo, size, bins):
        f = torch.tensor([i + (s + 0.5) / sr for i in range(bins)
                          for s in range(sr)], dtype=rois.dtype,
                         device=rois.device)
        return lo[:, None] + f[None, :] * size[:, None]   # (R, bins*sr)

    y = samples(y1, bin_h, ph)
    x = samples(x1, bin_w, pw)
    y0 = torch.clamp(torch.floor(y), 0, hh - 1)
    x0 = torch.clamp(torch.floor(x), 0, ww - 1)
    y1i = torch.clamp(y0 + 1, 0, hh - 1).to(torch.int64)
    x1i = torch.clamp(x0 + 1, 0, ww - 1).to(torch.int64)
    wy = (y - y0)[:, :, None, None]
    wx = (x - x0)[:, None, :, None]
    y0i, x0i = y0.to(torch.int64), x0.to(torch.int64)
    bi = b[:, None, None]

    def at(yi, xi):           # (R, ph*sr, pw*sr, C)
        return data[bi, :, yi[:, :, None], xi[:, None, :]]

    v = (at(y0i, x0i) * (1 - wy) * (1 - wx) +
         at(y1i, x0i) * wy * (1 - wx) +
         at(y0i, x1i) * (1 - wy) * wx +
         at(y1i, x1i) * wy * wx)
    v = v.reshape(-1, ph, sr, pw, sr, c)
    return (v.sum((2, 4)) / (sr * sr)).permute(0, 3, 1, 2)


# ---------------------------------------------------------------------------
# boxes
# ---------------------------------------------------------------------------

def _corners(a, fmt):
    if fmt == "center":
        return (a[..., 0] - a[..., 2] / 2, a[..., 1] - a[..., 3] / 2,
                a[..., 0] + a[..., 2] / 2, a[..., 1] + a[..., 3] / 2)
    return a[..., 0], a[..., 1], a[..., 2], a[..., 3]


def iou_matrix(a, b, fmt="corner"):
    """Pairwise IoU of a (..., M, 4) and b (..., N, 4) -> (..., M, N)."""
    ax1, ay1, ax2, ay2 = _corners(a, fmt)
    bx1, by1, bx2, by2 = _corners(b, fmt)
    ix1 = torch.maximum(ax1[..., :, None], bx1[..., None, :])
    iy1 = torch.maximum(ay1[..., :, None], by1[..., None, :])
    ix2 = torch.minimum(ax2[..., :, None], bx2[..., None, :])
    iy2 = torch.minimum(ay2[..., :, None], by2[..., None, :])
    inter = _max0(ix2 - ix1) * _max0(iy2 - iy1)
    area_a = _max0((ax2 - ax1) * (ay2 - ay1))
    area_b = _max0((bx2 - bx1) * (by2 - by1))
    union = area_a[..., :, None] + area_b[..., None, :] - inter
    return inter / _max0(union, 1e-12)


def greedy_dead(rel, dead0, tile=NMS_TILE):
    """Exact greedy suppression over items in score order.

    ``dead0`` (B, n) marks the items that start suppressed; an item that
    is not suppressed when its turn comes suppresses every later item
    ``j`` with ``rel(lo, hi)[:, r - lo, j]`` (``rel`` gives the rows
    ``lo:hi`` of the (B, n, n) relation, computed a tile at a time, so
    the whole matrix never exists).  Returns the final (B, n) mask.

    Tile by tile: the tile's own suppression is the fixpoint of
    ``dead_s = dead0_s | OR_{r<s} (~dead_r & rel_rs)`` (after k sweeps
    the first k items are final, so at most ``tile`` sweeps; a handful
    in practice, checked on the host every ``NMS_SWEEPS``), then the
    tile's survivors suppress every later item in one vectorised pass.
    """
    n = dead0.shape[1]
    dead = dead0.clone()
    idx = torch.arange(n, device=dead0.device)
    for lo in range(0, n, tile):
        hi = min(lo + tile, n)
        later = idx[None, None, :] > idx[lo:hi][None, :, None]
        r = rel(lo, hi) & later                           # (B, t, n)
        own = r[:, :, lo:hi]
        first = dead[:, lo:hi]
        cur = first
        while True:
            for _ in range(NMS_SWEEPS):
                prev, cur = cur, first | (own & ~cur[:, :, None]).any(1)
            if torch.equal(prev, cur):
                break
        dead[:, lo:hi] = cur
        if hi < n:
            dead[:, hi:] |= (r[:, :, hi:] & ~cur[:, :, None]).any(1)
    return dead


def greedy_dead_seq(rel, dead0):
    """The plain sequential greedy loop (one trip per item): the oracle
    :func:`greedy_dead` is held to."""
    n = dead0.shape[1]
    dead = dead0.clone()
    idx = torch.arange(n, device=dead0.device)
    for i in range(n):
        kill = rel(i, i + 1)[:, 0] & (idx[None, :] > i) & ~dead[:, i:i + 1]
        dead = dead | kill
    return dead


def stable_order(scores):
    """Indices sorting the last axis by descending score, ties by the
    lower index (``jnp.argsort(-scores)``)."""
    return torch.argsort(-scores, dim=-1, stable=True)


@register("_contrib_box_iou")
def _box_iou(lhs, rhs, format="corner"):
    return iou_matrix(lhs, rhs, format)


@register("_contrib_box_nms", num_outputs=1)
def _box_nms(data, overlap_thresh=0.5, valid_thresh=0.0, topk=-1,
             coord_start=2, score_index=1, id_index=-1, background_id=-1,
             force_suppress=False, in_format="corner",
             out_format="corner"):
    """Greedy NMS with static shapes: rows in score order, suppressed
    rows replaced by -1 (``topk``, ``background_id`` and ``out_format``
    are not read, as in the JAX package)."""
    shape = data.shape
    x = data.reshape(-1, shape[-2], shape[-1])
    order = stable_order(x[:, :, score_index])
    boxes = torch.gather(x, 1, order[:, :, None].expand_as(x))
    coords = boxes[:, :, coord_start:coord_start + 4]
    ids = boxes[:, :, id_index] if id_index >= 0 else None

    def rel(lo, hi):
        r = iou_matrix(coords[:, lo:hi], coords, in_format) > overlap_thresh
        if ids is not None and not force_suppress:
            r = r & (ids[:, lo:hi, None] == ids[:, None, :])
        return r

    with torch.no_grad():
        keep = ~greedy_dead(rel, ~(boxes[:, :, score_index] > valid_thresh))
    out = torch.where(keep[:, :, None], boxes,
                      torch.full((), -1.0, dtype=data.dtype,
                                 device=data.device))
    return out.reshape(shape)


@register("_contrib_bipartite_matching", num_outputs=2, differentiable=False)
def _bipartite_matching(data, is_ascend=False, threshold=0.5, topk=-1):
    mats = data if data.dim() == 3 else data[None]
    bsz, r, c = mats.shape
    k = min(r, c) if topk <= 0 else min(topk, r, c)
    work = (-mats if is_ascend else mats).clone()
    thr = -threshold if is_ascend else threshold
    rm = torch.full((bsz, r), -1.0, device=data.device)
    cm = torch.full((bsz, c), -1.0, device=data.device)
    rows = torch.arange(bsz, device=data.device)
    neg = float("-inf")
    for _ in range(k):
        idx = work.reshape(bsz, -1).argmax(1)
        i, j = idx // c, idx % c
        ok = work[rows, i, j] >= thr
        rm[rows, i] = torch.where(ok, j.to(rm.dtype), rm[rows, i])
        cm[rows, j] = torch.where(ok, i.to(cm.dtype), cm[rows, j])
        work[rows, i, :] = neg
        work[rows, :, j] = neg
    if data.dim() == 2:
        return rm[0], cm[0]
    return rm, cm


# ---------------------------------------------------------------------------
# SSD priors, SyncBatchNorm, arange_like
# ---------------------------------------------------------------------------

@register("_contrib_MultiBoxPrior", differentiable=False)
def _multibox_prior(data, sizes=(1.0,), ratios=(1.0,), clip=False,
                    steps=(-1.0, -1.0), offsets=(0.5, 0.5)):
    """(1, h*w*(len(sizes)+len(ratios)-1), 4) corner anchors: the first
    size with every ratio, then the other sizes with the first ratio;
    computed in numpy from the attrs and the map's shape alone."""
    _, _, h, w = data.shape
    step_y = steps[0] if steps[0] > 0 else 1.0 / h
    step_x = steps[1] if steps[1] > 0 else 1.0 / w
    cy = (np.arange(h) + offsets[0]) * step_y
    cx = (np.arange(w) + offsets[1]) * step_x
    cyg, cxg = np.meshgrid(cy, cx, indexing="ij")
    combos = [(sizes[0], r) for r in ratios] + \
        [(s, ratios[0]) for s in sizes[1:]]
    boxes = []
    for s, r in combos:
        bw = s * np.sqrt(r) / 2
        bh = s / np.sqrt(r) / 2
        boxes.append(np.stack([cxg - bw, cyg - bh, cxg + bw, cyg + bh],
                              axis=-1))
    out = np.stack(boxes, axis=2).reshape(1, -1, 4).astype(np.float32)
    if clip:
        out = np.clip(out, 0.0, 1.0)
    return torch.as_tensor(out, device=data.device)


@register("_contrib_SyncBatchNorm", num_outputs=3, train_aware=True,
          visible_outputs=lambda attrs: 3 if attrs.get("output_mean_var")
          else 1)
def _sync_batch_norm(data, gamma, beta, moving_mean, moving_var, eps=1e-3,
                     momentum=0.9, fix_gamma=True, use_global_stats=False,
                     output_mean_var=False, ndev=1, key=None,
                     is_train=False):
    """BatchNorm over the batch on one device: the JAX package's body
    (its statistics become global only under a sharded batch axis, which
    the port's one device does not have)."""
    from .nn import _batch_norm

    return _batch_norm(data, gamma, beta, moving_mean, moving_var, eps=eps,
                       momentum=momentum, fix_gamma=fix_gamma,
                       use_global_stats=use_global_stats,
                       output_mean_var=output_mean_var, axis=1,
                       is_train=is_train)


@register("_contrib_arange_like", differentiable=False)
def _arange_like(data, start=0.0, step=1.0, repeat=1, axis=None):
    dtype = data.dtype if data.dtype.is_floating_point else torch.float32

    def ramp(n):
        rep = max(1, int(repeat))
        base = torch.arange(-(-n // rep), dtype=dtype,
                            device=data.device) * step + start
        return torch.repeat_interleave(base, rep)[:n]

    if axis is None:
        return ramp(int(np.prod(data.shape))).reshape(data.shape)
    return ramp(data.shape[axis])
