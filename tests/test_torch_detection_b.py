"""Greedy NMS and the SSD heads of the PyTorch port against the JAX
package on the CPU: the blocked suppression (`contrib.greedy_dead`, a
tile at a time) against the sequential greedy loop, the port's and the
JAX package's; `box_nms` and `MultiBoxDetection` over several tiles;
`MultiBoxTarget` where two ground-truth boxes share a best anchor; and
the JAX package's departures from MXNet that the port keeps (ROADMAP
§C): `MultiBoxTarget` reads neither `cls_preds` nor `ignore_label` nor
the negative-mining arguments, `MultiBoxDetection` does not read
`nms_topk`, `box_nms` returns its rows in score order with -1 rows for
the suppressed ones.

Keep masks and class ids must be equal; coordinates and scores within
1e-5 relative (float32 arithmetic in other orders).
"""
import numpy as np
import pytest
import torch

import mxtpu as jmx
import mxtpu_torch as tmx
from mxtpu_torch.ops import rcnn as trcnn
from test_torch_op_cases import ANCHORS, MB_LABELS, boxes_near, nms_rows

torch.set_num_threads(1)


def clustered(n, seed):
    """n boxes in pixels, clustered so that IoU chains are common."""
    rng = np.random.RandomState(seed)
    centers = rng.uniform(0, 200, (n, 2))
    wh = rng.uniform(20, 80, (n, 2))
    return np.concatenate([centers - wh / 2, centers + wh / 2],
                          1).astype(np.float32)


@pytest.mark.parametrize("n,tile", [(700, 256), (700, 64), (513, 128),
                                    (64, 16)])
def test_blocked_nms_matches_the_sequential_oracle(n, tile):
    boxes = torch.as_tensor(clustered(n, 11))
    for thresh in (0.3, 0.7):
        got = trcnn._greedy_nms_suppressed(boxes, thresh, tile=tile)
        want = trcnn._greedy_nms_suppressed_seq(boxes, thresh)
        assert torch.equal(got, want), (n, tile, thresh)


def test_blocked_nms_matches_the_reference_oracle():
    """The port's blocked NMS (3 tiles) against the JAX package's
    sequential loop: the same suppression mask."""
    from mxtpu.ops.rcnn import _greedy_nms_suppressed_seq
    import jax.numpy as jnp

    boxes = clustered(600, 12)
    for thresh in (0.3, 0.7):
        want = np.asarray(_greedy_nms_suppressed_seq(jnp.asarray(boxes),
                                                     thresh))
        got = trcnn._greedy_nms_suppressed(torch.as_tensor(boxes), thresh)
        np.testing.assert_array_equal(got.numpy(), want)
        assert 0 < want.sum() < len(want)


def _nd(mx, name, *arrays, **attrs):
    out = getattr(mx.nd.contrib, name)(
        *[mx.nd.array(a, ctx=mx.cpu()) for a in arrays], **attrs)
    return [o.asnumpy() for o in (out if isinstance(out, list) else [out])]


def _same_rows(got, want, keep_col):
    np.testing.assert_array_equal(got[..., keep_col] >= 0,
                                  want[..., keep_col] >= 0)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("attrs", [dict(), dict(id_index=0,
                                                overlap_thresh=0.3)])
def test_box_nms_over_two_tiles(attrs):
    """300 rows (two tiles of 256): rows in score order, suppressed ones
    -1, exactly the reference's."""
    rows = nms_rows(2, 300, seed=4)
    got, want = _nd(tmx, "box_nms", rows, **attrs), _nd(jmx, "box_nms", rows,
                                                         **attrs)
    np.testing.assert_array_equal(got[0], want[0])
    out = got[0]
    kept = out[..., 1] >= 0
    assert kept.any() and (~kept).any()
    assert (out[~kept] == -1).all()
    for b in range(2):      # score order, the -1 rows in place
        order = np.argsort(-rows[b, :, 1], kind="stable")
        np.testing.assert_array_equal(out[b][kept[b]],
                                      rows[b][order][kept[b]])


def test_multibox_detection_over_several_tiles():
    """600 anchors (three tiles), 4 classes, batch 2: the same kept rows
    as the reference, per class and with force_suppress."""
    rng = np.random.RandomState(7)
    anchors = boxes_near(600, seed=3)[None]
    e = np.exp(rng.normal(0, 1.5, (2, 5, 600)))
    probs = (e / e.sum(1, keepdims=True)).astype(np.float32)
    loc = rng.normal(0, 0.3, (2, 2400)).astype(np.float32)
    for kw in (dict(nms_threshold=0.45), dict(force_suppress=True,
                                              threshold=0.2)):
        got = _nd(tmx, "MultiBoxDetection", probs, loc, anchors, **kw)[0]
        want = _nd(jmx, "MultiBoxDetection", probs, loc, anchors, **kw)[0]
        _same_rows(got, want, 0)
        assert 0 < (got[..., 0] >= 0).sum() < got.shape[0] * got.shape[1]


def test_multibox_detection_does_not_read_nms_topk():
    probs = np.exp(np.random.RandomState(1).normal(0, 1, (1, 3, 24)))
    probs = (probs / probs.sum(1, keepdims=True)).astype(np.float32)
    loc = np.random.RandomState(2).normal(0, 0.3, (1, 96)).astype(np.float32)
    base = _nd(tmx, "MultiBoxDetection", probs, loc, ANCHORS)[0]
    np.testing.assert_array_equal(
        _nd(tmx, "MultiBoxDetection", probs, loc, ANCHORS, nms_topk=2)[0],
        base)
    _same_rows(base, _nd(jmx, "MultiBoxDetection", probs, loc, ANCHORS,
                         nms_topk=2)[0], 0)


def test_multibox_target_shared_best_anchor_goes_to_the_later_box():
    """Image 0: boxes 0 and 1 both have anchor 3 as their best; the
    later (box 1, class 0) claims it, as the reference's scatter keeps
    the last write.  Image 1: the pads after a valid box point at anchor
    0 (their IoU column is all -1) and their write unclaims it, in both."""
    cls_preds = np.zeros((2, 3, 24), np.float32)
    got = _nd(tmx, "MultiBoxTarget", ANCHORS, MB_LABELS, cls_preds,
              overlap_threshold=0.95)
    want = _nd(jmx, "MultiBoxTarget", ANCHORS, MB_LABELS, cls_preds,
               overlap_threshold=0.95)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-6)
    cls_t = got[2]
    assert cls_t[0, 3] == 1.0           # class 0 of box 1, plus one
    np.testing.assert_array_equal(got[0][0, 12:16], 0.0)  # box 1 is anchor 3
    assert cls_t[1, 0] == 0.0 and (cls_t[1] == 0).all()


def test_multibox_target_reads_no_mining_arguments():
    """cls_preds, ignore_label and negative mining change nothing, and no
    anchor is marked -1: the background is class 0."""
    rng = np.random.RandomState(4)
    base = _nd(tmx, "MultiBoxTarget", ANCHORS, MB_LABELS,
               rng.normal(0, 1, (2, 3, 24)).astype(np.float32))
    other = _nd(tmx, "MultiBoxTarget", ANCHORS, MB_LABELS,
                rng.normal(0, 5, (2, 3, 24)).astype(np.float32),
                ignore_label=-2.0, negative_mining_ratio=3.0,
                negative_mining_thresh=0.1, minimum_negative_samples=5)
    for b, o in zip(base, other):
        np.testing.assert_array_equal(b, o)
    assert (base[2] >= 0).all() and (base[2] == 0).any()
    ref = _nd(jmx, "MultiBoxTarget", ANCHORS, MB_LABELS,
              rng.normal(0, 5, (2, 3, 24)).astype(np.float32),
              negative_mining_ratio=3.0)
    for b, r in zip(base, ref):
        np.testing.assert_allclose(b, r, rtol=1e-5, atol=1e-6)
