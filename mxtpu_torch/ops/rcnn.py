"""R-CNN-family ops of the PyTorch port (counterpart of
``mxtpu/ops/rcnn.py``): region proposals (``_contrib_Proposal``,
``_contrib_MultiProposal``), position-sensitive ROI pooling
(``_contrib_PSROIPooling``), deformable convolution
(``_contrib_DeformableConvolution``) and deformable PS-ROI pooling
(``_contrib_DeformablePSROIPooling``).  Their symbol metadata (the
deformable convolution's auto-created weight and bias, the optional
``trans``) is in ``mxtpu_torch/symbol/op_meta.py``.

* Proposals are static-shaped, as in the JAX package: the anchors of
  ``_generate_anchors`` (numpy, from the attrs) shifted over the map in
  (h, w, a) order, decoded and clipped, anchors past the image's real
  extent and boxes under ``rpn_min_size`` scored -1, the top
  ``rpn_pre_nms_top_n`` by a stable descending sort (ties by the lower
  index, as ``lax.top_k``; the -1 scores tie often), exact greedy NMS
  with the +1 pixel convention (``_greedy_nms_suppressed``, a tile at a
  time: one (tile, n) IoU block, never the (n, n) matrix), and the
  survivors cycled to ``rpn_post_nms_top_n`` rows.  The survivors'
  positions come from a stable sort of the suppression mask, so no
  count is read on the host; the tiles' fixpoints read one flag each.
* ``PSROIPooling`` averages, for each bin, one channel group over the
  bin's pixels; it loops over the bins, so it holds an (R, output_dim,
  H, W) gather at a time where the JAX package's einsum holds
  (R, C, H, W).  Its contraction, like the deformable convolution's, is
  a product on cuBLAS (``fp32_library``: TF32 off for float32).
* ``DeformableConvolution`` samples each tap with the four-gather
  bilinear form (``_bilinear_flat``; zero outside the image) and
  contracts the columns with the weights in one grouped ``einsum``, as
  the JAX package does outside any kernel.
"""
from __future__ import annotations

import numpy as np
import torch

from ..base import MXNetError
from .contrib import greedy_dead, greedy_dead_seq
from .registry import register


# ---------------------------------------------------------------------------
# anchors, IoU and greedy NMS (+1 pixel convention)
# ---------------------------------------------------------------------------

def _generate_anchors(feature_stride, scales, ratios):
    base_w = base_h = float(feature_stride)
    x_ctr = 0.5 * (base_w - 1.0)
    y_ctr = 0.5 * (base_h - 1.0)
    size = base_w * base_h
    out = []
    for r in ratios:
        size_ratio = np.floor(size / r)
        base = np.floor(np.sqrt(size_ratio) + 0.5)
        for s in scales:
            new_w = base * s
            new_h = np.floor(base * r + 0.5) * s
            out.append([x_ctr - 0.5 * (new_w - 1.0),
                        y_ctr - 0.5 * (new_h - 1.0),
                        x_ctr + 0.5 * (new_w - 1.0),
                        y_ctr + 0.5 * (new_h - 1.0)])
    return np.asarray(out, np.float32)


def _iou_matrix(a, b):
    """IoU of a (..., M, 4) against b (..., N, 4) with the +1 pixel
    area convention."""
    area_a = (a[..., 2] - a[..., 0] + 1.0) * (a[..., 3] - a[..., 1] + 1.0)
    area_b = (b[..., 2] - b[..., 0] + 1.0) * (b[..., 3] - b[..., 1] + 1.0)
    xx1 = torch.maximum(a[..., :, None, 0], b[..., None, :, 0])
    yy1 = torch.maximum(a[..., :, None, 1], b[..., None, :, 1])
    xx2 = torch.minimum(a[..., :, None, 2], b[..., None, :, 2])
    yy2 = torch.minimum(a[..., :, None, 3], b[..., None, :, 3])
    w = torch.clamp(xx2 - xx1 + 1.0, min=0.0)
    h = torch.clamp(yy2 - yy1 + 1.0, min=0.0)
    inter = w * h
    return inter / (area_a[..., :, None] + area_b[..., None, :] - inter)


def _nms_relation(boxes, thresh):
    """rel(lo, hi) of :func:`contrib.greedy_dead` for (B, n, 4) boxes."""
    return lambda lo, hi: _iou_matrix(boxes[:, lo:hi], boxes) > thresh


def _greedy_nms_suppressed_seq(boxes, thresh):
    """Sequential greedy NMS over score-sorted (n, 4) boxes (one trip per
    box): the oracle the blocked form is held to."""
    b = boxes[None]
    dead0 = torch.zeros((1, boxes.shape[0]), dtype=torch.bool,
                        device=boxes.device)
    return greedy_dead_seq(_nms_relation(b, thresh), dead0)[0]


def _greedy_nms_suppressed(boxes, thresh, tile=256):
    """Blocked exact greedy NMS: the suppression mask over score-sorted
    boxes (n, 4), or (B, n, 4) for a batch of images."""
    b = boxes if boxes.dim() == 3 else boxes[None]
    dead0 = torch.zeros(b.shape[:2], dtype=torch.bool, device=boxes.device)
    dead = greedy_dead(_nms_relation(b, thresh), dead0, tile)
    return dead if boxes.dim() == 3 else dead[0]


# ---------------------------------------------------------------------------
# proposals
# ---------------------------------------------------------------------------

def proposal_boxes(scores_fg, deltas, im_info, anchors, feature_stride,
                   pre_nms_top_n, rpn_min_size, iou_loss):
    """The boxes RPN proposals choose from, per image (reference
    ``proposal.cc`` Forward up to its NMS).  scores_fg: (N, A, H, W);
    deltas: (N, 4A, H, W); im_info: (N, 3) = (height, width, scale).
    Returns the top ``pre_nms_top_n`` decoded boxes (N, n_pre, 4) in
    score order, their scores and their indices among the anchors."""
    n, na, hh, ww = scores_fg.shape
    dev = scores_fg.device
    fs = float(feature_stride)
    f32 = torch.float32
    sx = (torch.arange(ww, dtype=f32, device=dev)[None, :] * fs) \
        .expand(hh, ww)
    sy = (torch.arange(hh, dtype=f32, device=dev)[:, None] * fs) \
        .expand(hh, ww)
    shifts = torch.stack([sx, sy, sx, sy], dim=-1)[:, :, None, :]
    boxes = (torch.as_tensor(anchors, device=dev)[None, None] + shifts) \
        .reshape(-1, 4)                                   # (K, 4)
    d = deltas.reshape(n, na, 4, hh, ww).permute(0, 3, 4, 1, 2) \
        .reshape(n, -1, 4)
    score = scores_fg.permute(0, 2, 3, 1).reshape(n, -1)

    im_h, im_w, im_scale = (im_info[:, k, None] for k in range(3))
    width = boxes[:, 2] - boxes[:, 0] + 1.0
    height = boxes[:, 3] - boxes[:, 1] + 1.0
    if iou_loss:
        px1 = boxes[:, 0] + d[..., 0]
        py1 = boxes[:, 1] + d[..., 1]
        px2 = boxes[:, 2] + d[..., 2]
        py2 = boxes[:, 3] + d[..., 3]
    else:
        ctr_x = boxes[:, 0] + 0.5 * (width - 1.0)
        ctr_y = boxes[:, 1] + 0.5 * (height - 1.0)
        pred_ctr_x = d[..., 0] * width + ctr_x
        pred_ctr_y = d[..., 1] * height + ctr_y
        pred_w = torch.exp(d[..., 2]) * width
        pred_h = torch.exp(d[..., 3]) * height
        px1 = pred_ctr_x - 0.5 * (pred_w - 1.0)
        py1 = pred_ctr_y - 0.5 * (pred_h - 1.0)
        px2 = pred_ctr_x + 0.5 * (pred_w - 1.0)
        py2 = pred_ctr_y + 0.5 * (pred_h - 1.0)
    zero = torch.zeros((), device=dev)
    px1 = torch.clamp(px1, zero, im_w - 1.0)
    py1 = torch.clamp(py1, zero, im_h - 1.0)
    px2 = torch.clamp(px2, zero, im_w - 1.0)
    py2 = torch.clamp(py2, zero, im_h - 1.0)

    # anchors beyond the real (unpadded) feature extent score -1
    real_h = torch.ceil(im_h / fs).to(torch.int64)        # (N, 1)
    real_w = torch.ceil(im_w / fs).to(torch.int64)
    hidx = torch.arange(hh, device=dev)[:, None, None].expand(hh, ww, na)
    widx = torch.arange(ww, device=dev)[None, :, None].expand(hh, ww, na)
    oob = (hidx.reshape(1, -1) >= real_h) | (widx.reshape(1, -1) >= real_w)
    minus = torch.full((), -1.0, device=dev)
    score = torch.where(oob, minus, score)

    # min-size filter: widen the box and kill its score (FilterBox)
    min_sz = rpn_min_size * im_scale
    small = (px2 - px1 + 1.0 < min_sz) | (py2 - py1 + 1.0 < min_sz)
    px1 = torch.where(small, px1 - min_sz / 2, px1)
    py1 = torch.where(small, py1 - min_sz / 2, py1)
    px2 = torch.where(small, px2 + min_sz / 2, px2)
    py2 = torch.where(small, py2 + min_sz / 2, py2)
    score = torch.where(small, minus, score)
    pboxes = torch.stack([px1, py1, px2, py2], dim=2)     # (N, K, 4)

    k = pboxes.shape[1]
    n_pre = min(pre_nms_top_n, k) if pre_nms_top_n > 0 else k
    top_scores, top_idx = torch.sort(score, dim=1, descending=True,
                                     stable=True)
    top_scores, top_idx = top_scores[:, :n_pre], top_idx[:, :n_pre]
    top_boxes = torch.gather(pboxes, 1, top_idx[:, :, None].expand(
        n, n_pre, 4))
    return top_boxes, top_scores, top_idx


def proposal_pick(top_boxes, top_scores, suppressed, post_nms_top_n):
    """The first ``post_nms_top_n`` survivors of the NMS mask
    ``suppressed``, in order, cycled where fewer survive: (rois (N,
    post, 4), scores (N, post))."""
    n, n_pre = suppressed.shape
    dev = suppressed.device
    # the survivors' positions first, in order (jnp.nonzero's order)
    kept_pos = torch.argsort(suppressed.to(torch.uint8), dim=1, stable=True)
    out_size = torch.clamp((~suppressed).sum(1, keepdim=True), min=1)
    i = torch.arange(post_nms_top_n, device=dev)[None, :]
    # fewer survivors than asked for: cycle them (proposal.cc's fill)
    pick = torch.gather(kept_pos, 1, torch.where(i < out_size, i % n_pre,
                                                 i % out_size))
    return (torch.gather(top_boxes, 1, pick[:, :, None].expand(
        n, post_nms_top_n, 4)), torch.gather(top_scores, 1, pick))


@register("_contrib_Proposal",
          num_outputs=lambda attrs: 2 if attrs.get("output_score") else 1,
          differentiable=False)
def _contrib_proposal(cls_prob, bbox_pred, im_info, rpn_pre_nms_top_n=6000,
                      rpn_post_nms_top_n=300, threshold=0.7, rpn_min_size=16,
                      scales=(4, 8, 16, 32), ratios=(0.5, 1, 2),
                      feature_stride=16, output_score=False, iou_loss=False):
    """RPN proposals of one image (batch 1; ``_contrib_MultiProposal`` is
    the batched form): rois (post, 5) with 0 in column 0."""
    if cls_prob.shape[0] != 1:
        raise MXNetError("_contrib_Proposal requires batch 1 "
                         "(use _contrib_MultiProposal)")
    return _contrib_multi_proposal(
        cls_prob, bbox_pred, im_info, rpn_pre_nms_top_n, rpn_post_nms_top_n,
        threshold, rpn_min_size, scales, ratios, feature_stride,
        output_score, iou_loss)


@register("_contrib_MultiProposal",
          num_outputs=lambda attrs: 2 if attrs.get("output_score") else 1,
          differentiable=False)
def _contrib_multi_proposal(cls_prob, bbox_pred, im_info,
                            rpn_pre_nms_top_n=6000, rpn_post_nms_top_n=300,
                            threshold=0.7, rpn_min_size=16,
                            scales=(4, 8, 16, 32), ratios=(0.5, 1, 2),
                            feature_stride=16, output_score=False,
                            iou_loss=False):
    """RPN proposals of a batch: rois (N * post, 5) with the image index
    in column 0."""
    anchors = _generate_anchors(feature_stride, scales, ratios)
    na = anchors.shape[0]
    top_boxes, top_scores, _ = proposal_boxes(
        cls_prob[:, na:], bbox_pred, im_info, anchors, feature_stride,
        int(rpn_pre_nms_top_n), float(rpn_min_size), bool(iou_loss))
    boxes, scores = proposal_pick(
        top_boxes, top_scores,
        _greedy_nms_suppressed(top_boxes, float(threshold)),
        int(rpn_post_nms_top_n))
    n, p = boxes.shape[:2]
    bidx = torch.arange(n, dtype=boxes.dtype, device=boxes.device)[
        :, None, None].expand(n, p, 1)
    rois = torch.cat([bidx, boxes], dim=2).reshape(n * p, 5)
    if output_score:
        return rois, scores.reshape(n * p, 1)
    return rois


# ---------------------------------------------------------------------------
# position-sensitive ROI pooling (reference psroi_pooling.cc)
# ---------------------------------------------------------------------------

def _roi_frame(rois, n, spatial_scale, shift):
    """(image index, x1, y1, roi_w, roi_h) of each ROI, corners rounded
    (half to even) and scaled, minus ``shift``."""
    f32 = torch.float32
    bidx = torch.clamp(rois[:, 0].to(torch.int64), 0, n - 1)
    x1 = torch.round(rois[:, 1]).to(f32) * spatial_scale - shift
    y1 = torch.round(rois[:, 2]).to(f32) * spatial_scale - shift
    x2 = (torch.round(rois[:, 3]) + 1.0).to(f32) * spatial_scale - shift
    y2 = (torch.round(rois[:, 4]) + 1.0).to(f32) * spatial_scale - shift
    return (bidx, x1, y1, torch.clamp(x2 - x1, min=0.1),
            torch.clamp(y2 - y1, min=0.1))


def _ps_channels(od, pooled, group):
    """(od, P, P) channel of each output channel and bin:
    (ctop * G + gh) * G + gw with gh, gw from the bin's position."""
    gh = np.minimum((np.arange(pooled) * group) // pooled, group - 1)
    return ((np.arange(od)[:, None, None] * group + gh[None, :, None])
            * group + gh[None, None, :])


@register("_contrib_PSROIPooling", fp32_library=True)
def _psroi_pooling(data, rois, spatial_scale=1.0, output_dim=0,
                   pooled_size=0, group_size=0):
    """Each output bin averages one channel group, chosen by the bin's
    position, over the bin's pixels."""
    P = int(pooled_size)
    G = int(group_size) or P
    od = int(output_dim)
    n, c, hh, ww = data.shape
    dev = data.device
    f32 = torch.float32
    bidx, x1, y1, roi_w, roi_h = _roi_frame(rois, n, spatial_scale, 0.0)
    bin_h, bin_w = roi_h / P, roi_w / P
    p = torch.arange(P, dtype=f32, device=dev)

    def edges(lo, size, extent):
        start = torch.clamp(torch.floor(p[None, :] * size[:, None]
                                        + lo[:, None]), 0, extent)
        end = torch.clamp(torch.ceil((p + 1.0)[None, :] * size[:, None]
                                     + lo[:, None]), 0, extent)
        at = torch.arange(extent, device=dev)
        return ((at >= start[:, :, None]) & (at < end[:, :, None])) \
            .to(data.dtype)                               # (R, P, extent)

    mh, mw = edges(y1, bin_h, hh), edges(x1, bin_w, ww)
    cnt = torch.clamp(mh.sum(2)[:, :, None] * mw.sum(2)[:, None, :],
                      min=1.0)                            # (R, P, P)
    chans = torch.as_tensor(_ps_channels(od, P, G), device=dev)
    img = data.index_select(0, bidx)                      # (R, C, H, W)
    out = torch.stack([torch.stack([
        torch.einsum("rchw,rh,rw->rc", img[:, chans[:, i, j]], mh[:, i],
                     mw[:, j]) for j in range(P)], dim=-1)
        for i in range(P)], dim=-2)                       # (R, od, P, P)
    return out / cnt[:, None]


# ---------------------------------------------------------------------------
# bilinear gather (the deformable ops)
# ---------------------------------------------------------------------------

def _bilinear_flat(img_flat, W, H, y, x, chan=None):
    """Bilinear interpolation by four flat gathers along the last axis.

    img_flat: (..., C*H*W) when ``chan`` is given, else (..., H*W); y/x:
    sample positions shaped like the gather index; chan: the channel of
    each sample.  Indices clamp to the image (edge extension, as the
    reference's ``deformable_im2col_bilinear``)."""
    y0 = torch.floor(y)
    x0 = torch.floor(x)
    ly = (y - y0).to(img_flat.dtype)
    lx = (x - x0).to(img_flat.dtype)
    y0i = torch.clamp(y0.to(torch.int64), 0, H - 1)
    x0i = torch.clamp(x0.to(torch.int64), 0, W - 1)
    y1i = torch.clamp(y0i + 1, 0, H - 1)
    x1i = torch.clamp(x0i + 1, 0, W - 1)
    base = 0 if chan is None else chan * (H * W)

    def g(yi, xi):
        return torch.gather(img_flat, -1, base + yi * W + xi)

    v00, v01 = g(y0i, x0i), g(y0i, x1i)
    v10, v11 = g(y1i, x0i), g(y1i, x1i)
    return (v00 * (1 - ly) * (1 - lx) + v01 * (1 - ly) * lx +
            v10 * ly * (1 - lx) + v11 * ly * lx)


# ---------------------------------------------------------------------------
# deformable convolution (reference deformable_convolution.cc)
# ---------------------------------------------------------------------------

@register("_contrib_DeformableConvolution", fp32_library=True)
def _deformable_convolution(data, offset, weight, *maybe_bias, kernel=(),
                            stride=(), dilate=(), pad=(), num_filter=0,
                            num_group=1, num_deformable_group=1,
                            no_bias=False, workspace=1024, layout=None):
    """Deformable convolution v1 (https://arxiv.org/abs/1703.06211): each
    kernel tap samples at base + dilation + learned offset, bilinearly,
    zero outside the image; a grouped product with the weights."""
    if len(kernel) != 2:
        raise MXNetError("_contrib_DeformableConvolution supports 2D only")
    kh, kw = kernel
    sh, sw = stride or (1, 1)
    dh, dw = dilate or (1, 1)
    ph, pw = pad or (0, 0)
    n, c, hh, ww = data.shape
    dg = int(num_deformable_group)
    f32 = torch.float32
    dev = data.device
    ho = (hh + 2 * ph - ((kh - 1) * dh + 1)) // sh + 1
    wo = (ww + 2 * pw - ((kw - 1) * dw + 1)) // sw + 1
    t = kh * kw
    h_in = torch.arange(ho, dtype=f32, device=dev) * sh - ph
    w_in = torch.arange(wo, dtype=f32, device=dev) * sw - pw
    off = offset.reshape(n, dg, t, 2, ho, wo)
    taps = np.arange(t)
    tap_dy = torch.as_tensor((taps // kw) * dh, dtype=f32, device=dev)
    tap_dx = torch.as_tensor((taps % kw) * dw, dtype=f32, device=dev)
    y = (h_in[None, None, None, :, None] +
         tap_dy[None, None, :, None, None] + off[:, :, :, 0])
    x = (w_in[None, None, None, None, :] +
         tap_dx[None, None, :, None, None] + off[:, :, :, 1])
    valid = (y >= 0) & (y < hh) & (x >= 0) & (x < ww)
    cg = c // dg
    dflat = data.reshape(n, dg, cg, hh * ww)
    y_b = y[:, :, None].expand(n, dg, cg, t, ho, wo).reshape(n, dg, cg, -1)
    x_b = x[:, :, None].expand(n, dg, cg, t, ho, wo).reshape(n, dg, cg, -1)
    cols = _bilinear_flat(dflat, ww, hh, y_b, x_b)
    cols = cols.reshape(n, dg, cg, t, ho, wo) * \
        valid[:, :, None].to(data.dtype)
    g = int(num_group)
    cols = cols.reshape(n, g, (c // g) * t, ho * wo)
    wmat = weight.reshape(g, num_filter // g, (c // g) * t)
    out = torch.einsum("gfk,ngkp->ngfp", wmat, cols) \
        .reshape(n, num_filter, ho, wo)
    if not no_bias and maybe_bias:
        out = out + maybe_bias[0].reshape(1, -1, 1, 1)
    return out


# ---------------------------------------------------------------------------
# deformable PS-ROI pooling (reference deformable_psroi_pooling.cu)
# ---------------------------------------------------------------------------

@register("_contrib_DeformablePSROIPooling", num_outputs=2,
          visible_outputs=1)
def _deformable_psroi_pooling(data, rois, *maybe_trans, spatial_scale=1.0,
                              output_dim=0, group_size=0, pooled_size=0,
                              part_size=0, sample_per_part=1,
                              trans_std=0.0, no_trans=False):
    """Each bin's window shifted by a learned normalised offset and
    averaged over ``sample_per_part``^2 bilinear taps; returns (out,
    top_count), the count of in-image samples of each bin (only ``out``
    is visible)."""
    P = int(pooled_size)
    G = int(group_size)
    od = int(output_dim)
    PS = int(part_size) or P
    S = int(sample_per_part)
    n, c, hh, ww = data.shape
    r = rois.shape[0]
    dev = data.device
    f32 = torch.float32
    bidx, x1, y1, roi_w, roi_h = _roi_frame(rois, n, spatial_scale, 0.5)
    bin_h, bin_w = roi_h / P, roi_w / P
    sub_h, sub_w = bin_h / S, bin_w / S
    if no_trans or not maybe_trans:
        ncls = 1
        tx = torch.zeros((r, 1, P, P), dtype=f32, device=dev)
        ty = torch.zeros((r, 1, P, P), dtype=f32, device=dev)
    else:
        trans = maybe_trans[0]
        ncls = trans.shape[1] // 2
        part = torch.as_tensor(np.minimum((np.arange(P) * PS) // P, PS - 1),
                               device=dev)
        t = trans.reshape(r, ncls, 2, PS, PS)
        tsel = t[:, :, :, part[:, None], part[None, :]]   # (R, ncls, 2, P, P)
        tx = tsel[:, :, 0] * trans_std
        ty = tsel[:, :, 1] * trans_std
    pg = torch.arange(P, dtype=f32, device=dev)
    hstart = (pg[None, None, :, None] * bin_h[:, None, None, None] +
              y1[:, None, None, None] + ty * roi_h[:, None, None, None])
    wstart = (pg[None, None, None, :] * bin_w[:, None, None, None] +
              x1[:, None, None, None] + tx * roi_w[:, None, None, None])
    sg = torch.arange(S, dtype=f32, device=dev)
    y = hstart[..., None, None] + \
        sg[None, None, None, None, :, None] * \
        sub_h[:, None, None, None, None, None]
    x = wstart[..., None, None] + \
        sg[None, None, None, None, None, :] * \
        sub_w[:, None, None, None, None, None]
    y, x = torch.broadcast_tensors(y, x)
    inb = (y >= -0.5) & (y <= hh - 0.5) & (x >= -0.5) & (x <= ww - 0.5)
    yc = torch.clamp(y, 0.0, hh - 1.0)
    xc = torch.clamp(x, 0.0, ww - 1.0)
    chans = _ps_channels(od, P, G)
    cls_of = np.minimum(np.arange(od) // max(od // ncls, 1), ncls - 1)
    cls_of = torch.as_tensor(cls_of, device=dev)
    yq, xq, inbq = yc[:, cls_of], xc[:, cls_of], inb[:, cls_of]
    chan = torch.as_tensor(chans, device=dev)[None, :, :, :, None, None] \
        .expand(yq.shape)
    dflat = data.reshape(n, c * hh * ww).index_select(0, bidx)
    shp = yq.shape
    val = _bilinear_flat(dflat, ww, hh, yq.reshape(r, -1),
                         xq.reshape(r, -1),
                         chan=chan.reshape(r, -1)).reshape(shp)
    val = val * inbq.to(data.dtype)
    cnt = inbq.to(data.dtype).sum((-2, -1))               # (R, od, P, P)
    out = val.sum((-2, -1)) / torch.clamp(cnt, min=1.0)
    return out, cnt
