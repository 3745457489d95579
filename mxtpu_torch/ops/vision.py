"""Vision ops of the PyTorch port (counterpart of ``mxtpu/ops/vision.py``):
spatial sampling (``GridGenerator``, ``BilinearSampler``,
``SpatialTransformer``), ``Correlation``, and the SSD heads
``_contrib_MultiBoxTarget`` and ``_contrib_MultiBoxDetection`` (with
their ``MultiBox*`` aliases).  ``cast_storage`` and ``_sparse_retain``,
which the JAX package keeps in the same file, are in :mod:`.indexing`.

* The affine grid is a product on cuBLAS (``fp32_library``: TF32 off
  for float32, as for every product of the port).
* ``_bilinear_sample`` is the JAX package's four-gather form: each of
  the four taps outside the image is zeroed on its own, and the grid's
  gradient comes from the tap weights alone (``floor`` has none).
* ``Correlation``'s window sum pads as XLA's ``SAME`` does:
  ``(k - 1) // 2`` before and ``k // 2`` after, so an even kernel leans
  the same way; the displaced map wraps around (``roll``), as there.
* The SSD heads compute in float32 and cast back.  ``MultiBoxTarget``
  reads neither ``cls_preds`` nor ``ignore_label`` nor the
  ``negative_mining_*`` arguments, as in the JAX package: class 0 is
  the background and no anchor is marked -1.  Where two ground-truth
  boxes share a best anchor, the later box claims it, as the JAX
  package's scatter does on the CPU (``scatter_reduce`` of the box
  index with ``amax`` makes that deterministic on the card).
  ``MultiBoxDetection`` does not read ``nms_topk``; its greedy NMS runs
  over every anchor a tile at a time (``contrib.greedy_dead``), so the
  (A, A) IoU matrix (8732^2 floats for SSD300) never exists: a tile is
  (batch, ``NMS_TILE``, A).
"""
from __future__ import annotations

import numpy as np
import torch

from .contrib import greedy_dead, iou_matrix, stable_order
from .registry import register


# ---------------------------------------------------------------------------
# grid generation and bilinear sampling
# ---------------------------------------------------------------------------

@register("GridGenerator", fp32_library=True)
def _grid_generator(data, transform_type="affine", target_shape=(0, 0)):
    """affine: data (N, 6) -> grid (N, 2, H, W) of normalised (x, y)
    sample positions; warp: data (N, 2, H, W) pixel flow -> grid."""
    f32 = torch.float32
    dev = data.device
    if transform_type == "affine":
        h, w = int(target_shape[0]), int(target_shape[1])
        ys = torch.linspace(-1.0, 1.0, h, device=dev)
        xs = torch.linspace(-1.0, 1.0, w, device=dev)
        gy, gx = torch.meshgrid(ys, xs, indexing="ij")
        tgt = torch.stack([gx.reshape(-1), gy.reshape(-1),
                           torch.ones(h * w, device=dev)])   # (3, HW)
        theta = data.reshape(-1, 2, 3).to(f32)
        grid = torch.einsum("nij,jk->nik", theta, tgt)
        return grid.reshape(-1, 2, h, w).to(data.dtype)
    n, _, h, w = data.shape
    gy, gx = torch.meshgrid(torch.arange(h, dtype=f32, device=dev),
                            torch.arange(w, dtype=f32, device=dev),
                            indexing="ij")
    fx = data[:, 0].to(f32) + gx[None]
    fy = data[:, 1].to(f32) + gy[None]
    nx = 2.0 * fx / max(w - 1, 1) - 1.0
    ny = 2.0 * fy / max(h - 1, 1) - 1.0
    return torch.stack([nx, ny], dim=1).to(data.dtype)


def _bilinear_sample(data, grid_x, grid_y):
    """data (N, C, H, W); grid_x/y (N, Ho, Wo) in [-1, 1]; zero outside."""
    n, c, h, w = data.shape
    x = (grid_x.to(torch.float32) + 1.0) * (w - 1) / 2.0
    y = (grid_y.to(torch.float32) + 1.0) * (h - 1) / 2.0
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    wx = x - x0
    wy = y - y0
    flat = data.reshape(n, c, h * w)

    def gather(yy, xx):
        inside = (xx >= 0) & (xx <= w - 1) & (yy >= 0) & (yy <= h - 1)
        xi = torch.clamp(xx, 0, w - 1).to(torch.int64)
        yi = torch.clamp(yy, 0, h - 1).to(torch.int64)
        idx = (yi * w + xi).reshape(n, 1, -1).expand(n, c, -1)
        v = torch.gather(flat, 2, idx).reshape(n, c, *xx.shape[1:])
        return torch.where(inside[:, None], v.to(torch.float32),
                           torch.zeros((), device=data.device))

    out = (gather(y0, x0) * ((1 - wy) * (1 - wx))[:, None]
           + gather(y0, x0 + 1) * ((1 - wy) * wx)[:, None]
           + gather(y0 + 1, x0) * (wy * (1 - wx))[:, None]
           + gather(y0 + 1, x0 + 1) * (wy * wx)[:, None])
    return out.to(data.dtype)


@register("BilinearSampler")
def _bilinear_sampler(data, grid, cudnn_off=False):
    """data (N, C, H, W), grid (N, 2, Ho, Wo) normalised -> (N, C, Ho, Wo)."""
    return _bilinear_sample(data, grid[:, 0], grid[:, 1])


@register("SpatialTransformer", fp32_library=True)
def _spatial_transformer(data, loc, target_shape=(0, 0),
                         transform_type="affine", sampler_type="bilinear",
                         cudnn_off=False):
    """GridGenerator(affine) then BilinearSampler."""
    grid = _grid_generator(loc, "affine", target_shape)
    return _bilinear_sample(data, grid[:, 0], grid[:, 1])


# ---------------------------------------------------------------------------
# Correlation (FlowNet)
# ---------------------------------------------------------------------------

@register("Correlation")
def _correlation(data1, data2, kernel_size=1, max_displacement=1,
                 stride1=1, stride2=1, pad_size=0, is_multiply=True):
    """One output channel per displacement of the
    (2 * max_displacement / stride2 + 1)^2 neighbourhood: the
    kernel_size-window mean of x1 * x2 (or |x1 - x2|) over the channels."""
    n, c, h, w = data1.shape
    k = int(kernel_size)
    kr = (k - 1) // 2
    bsz = max_displacement + kr
    ph, pw = h + 2 * pad_size, w + 2 * pad_size
    out_h = int(np.ceil((ph - 2 * bsz) / float(stride1)))
    out_w = int(np.ceil((pw - 2 * bsz) / float(stride1)))
    pad = (pad_size,) * 4
    p1 = torch.nn.functional.pad(data1.to(torch.float32), pad)
    p2 = torch.nn.functional.pad(data2.to(torch.float32), pad)
    ys = bsz + stride1 * torch.arange(out_h, device=data1.device)
    xs = bsz + stride1 * torch.arange(out_w, device=data1.device)
    reach = (max_displacement // stride2) * stride2
    outs = []
    for dy in range(-reach, reach + 1, stride2):
        for dx in range(-reach, reach + 1, stride2):
            shifted = torch.roll(p2, shifts=(-dy, -dx), dims=(2, 3))
            prod = p1 * shifted if is_multiply else torch.abs(p1 - shifted)
            s = torch.nn.functional.pad(prod.sum(1),
                                        (kr, k // 2, kr, k // 2))
            win = sum(s[:, a:a + ph, b:b + pw] for a in range(k)
                      for b in range(k))
            outs.append(win[:, ys][:, :, xs])
    out = torch.stack(outs, dim=1) / (k * k * c)
    return out.to(data1.dtype)


# ---------------------------------------------------------------------------
# SSD heads
# ---------------------------------------------------------------------------

def _anchor_frame(anchors):
    a = anchors.reshape(-1, 4).to(torch.float32)
    aw = torch.clamp(a[:, 2] - a[:, 0], min=1e-12)
    ah = torch.clamp(a[:, 3] - a[:, 1], min=1e-12)
    return aw, ah, (a[:, 0] + a[:, 2]) / 2, (a[:, 1] + a[:, 3]) / 2


@register("_contrib_MultiBoxTarget", num_outputs=3, differentiable=False,
          aliases=("MultiBoxTarget",))
def _multibox_target(anchors, labels, cls_preds, overlap_threshold=0.5,
                     ignore_label=-1.0, negative_mining_ratio=-1.0,
                     negative_mining_thresh=0.5, minimum_negative_samples=0,
                     variances=(0.1, 0.1, 0.2, 0.2)):
    """Anchors matched to ground-truth boxes by best IoU, each valid box
    claiming its best anchor; returns (box_target (N, A*4), box_mask
    (N, A*4), cls_target (N, A)), class 0 the background and a box's
    class + 1 otherwise.  labels: (N, O, 5) rows [cls, x1, y1, x2, y2],
    cls -1 a pad."""
    a = anchors.reshape(-1, 4).to(torch.float32)
    na = a.shape[0]
    lab = labels.to(torch.float32)
    n, o, _ = lab.shape
    var = [float(v) for v in variances]
    aw, ah, acx, acy = _anchor_frame(anchors)
    valid = lab[:, :, 0] >= 0                                   # (N, O)
    iou = iou_matrix(a[None], lab[:, :, 1:5])                   # (N, A, O)
    iou = torch.where(valid[:, None, :], iou, torch.full((), -1.0,
                                                         device=a.device))
    best_gt = iou.argmax(2)                                     # (N, A)
    best_iou = torch.gather(iou, 2, best_gt[:, :, None])[:, :, 0]
    matched = best_iou >= overlap_threshold
    best_anchor = iou.argmax(1)                                 # (N, O)
    gts = torch.arange(o, device=a.device).expand(n, o)
    claim = torch.full((n, na), -1, dtype=torch.int64, device=a.device)
    claim = claim.scatter_reduce(1, best_anchor, gts, "amax")
    claimed = claim >= 0
    winner = claim.clamp(min=0)
    forced = claimed & torch.gather(valid, 1, winner)
    gt_idx = torch.where(forced, winner, best_gt)
    pos = matched | forced
    g = torch.gather(lab, 1, gt_idx[:, :, None].expand(n, na, 5))
    gw = torch.clamp(g[..., 3] - g[..., 1], min=1e-12)
    gh = torch.clamp(g[..., 4] - g[..., 2], min=1e-12)
    gcx = (g[..., 1] + g[..., 3]) / 2
    gcy = (g[..., 2] + g[..., 4]) / 2
    bt = torch.stack([(gcx - acx) / aw / var[0], (gcy - acy) / ah / var[1],
                      torch.log(gw / aw) / var[2],
                      torch.log(gh / ah) / var[3]], dim=2)
    zero = torch.zeros((), device=a.device)
    bt = torch.where(pos[..., None], bt, zero)
    bm = torch.where(pos[..., None], torch.ones((), device=a.device),
                     zero).expand(n, na, 4)
    ct = torch.where(pos, g[..., 0] + 1.0, zero)
    dt = anchors.dtype
    return (bt.reshape(n, -1).to(dt), bm.reshape(n, -1).to(dt), ct.to(dt))


def detection_boxes(cls_prob, loc_pred, anchors, clip=True, threshold=0.01,
                    background_id=0, variances=(0.1, 0.1, 0.2, 0.2)):
    """MultiBoxDetection's decoding: (class id, score, box) of each
    anchor in float32, (N, A), (N, A), (N, A, 4); the class -1 and the
    score -1 where the best non-background score is not above
    ``threshold``."""
    var = [float(v) for v in variances]
    aw, ah, acx, acy = _anchor_frame(anchors)
    probs = cls_prob.to(torch.float32)                          # (N, C+1, A)
    n, _, na = probs.shape
    lo = loc_pred.to(torch.float32).reshape(n, na, 4)
    cx = lo[..., 0] * var[0] * aw + acx
    cy = lo[..., 1] * var[1] * ah + acy
    bw = torch.exp(lo[..., 2] * var[2]) * aw
    bh = torch.exp(lo[..., 3] * var[3]) * ah
    boxes = torch.stack([cx - bw / 2, cy - bh / 2, cx + bw / 2,
                         cy + bh / 2], dim=2)
    if clip:
        boxes = torch.clamp(boxes, 0.0, 1.0)
    masked = probs.clone()
    masked[:, background_id] = -1.0
    cls_id = masked.argmax(1).to(torch.float32)
    score = masked.amax(1)
    keep = score > threshold
    minus = torch.full((), -1.0, device=probs.device)
    cls_id = torch.where(keep, cls_id - (cls_id > background_id).float(),
                         minus)
    return cls_id, torch.where(keep, score, minus), boxes


def detection_nms(cls_id, score, boxes, nms_threshold=0.5,
                  force_suppress=False):
    """MultiBoxDetection's greedy NMS over :func:`detection_boxes`'
    output: (N, A, 6) rows in score order, suppressed rows -1."""
    n, na = score.shape
    order = stable_order(score)
    cls_s = torch.gather(cls_id, 1, order)
    score_s = torch.gather(score, 1, order)
    box_s = torch.gather(boxes, 1, order[:, :, None].expand(n, na, 4))

    def rel(lo, hi):
        r = iou_matrix(box_s[:, lo:hi], box_s) > nms_threshold
        if not force_suppress:
            r = r & (cls_s[:, lo:hi, None] == cls_s[:, None, :])
        return r

    alive = ~greedy_dead(rel, score_s < 0)
    minus = torch.full((), -1.0, device=score.device)
    return torch.cat([torch.where(alive, cls_s, minus)[..., None],
                      torch.where(alive, score_s, minus)[..., None],
                      torch.where(alive[..., None], box_s, minus)], dim=2)


@register("_contrib_MultiBoxDetection", differentiable=False,
          aliases=("MultiBoxDetection",))
def _multibox_detection(cls_prob, loc_pred, anchors, clip=True,
                        threshold=0.01, background_id=0, nms_threshold=0.5,
                        force_suppress=False,
                        variances=(0.1, 0.1, 0.2, 0.2), nms_topk=-1):
    """Box regressions decoded against the anchors, then greedy NMS per
    class (across classes with ``force_suppress``).  Returns (N, A, 6)
    rows [cls_id, score, x1, y1, x2, y2] in score order, suppressed rows
    -1."""
    cls_id, score, boxes = detection_boxes(
        cls_prob, loc_pred, anchors, clip, threshold, background_id,
        variances)
    out = detection_nms(cls_id, score, boxes, nms_threshold, force_suppress)
    return out.to(cls_prob.dtype)
