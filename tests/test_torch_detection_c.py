"""RPN proposals of the PyTorch port (`_contrib_Proposal`,
`_contrib_MultiProposal`, `mxtpu_torch/ops/rcnn.py`) against the JAX
package's and against `tests/test_rcnn_dgl.py`'s numpy transcription of
`proposal.cc`, as that file holds the JAX package's: one image, a batch
against its images one by one, thousands of boxes before NMS (several
tiles of the blocked NMS) with many -1 scores tied (anchors past the
image and boxes under the least size), and fewer survivors than rows
asked for (cycled).

The picks and the scores must be equal; the rois within 1e-5 of the
reference's (the decoding's exp rounds apart) and the gold's bounds,
those of `test_rcnn_dgl.py` (1e-4 relative, 1e-3 absolute).
"""
import numpy as np
import pytest
import torch

import mxtpu as jmx
import mxtpu_torch as tmx
from mxtpu_torch.ops import rcnn as trcnn
from test_rcnn_dgl import _proposal_gold

torch.set_num_threads(1)


def _prop(mx, name, cls, bbox, info, **kw):
    out = getattr(mx.nd.contrib, name)(
        mx.nd.array(cls, ctx=mx.cpu()), mx.nd.array(bbox, ctx=mx.cpu()),
        mx.nd.array(info, ctx=mx.cpu()), **kw)
    return [o.asnumpy() for o in (out if isinstance(out, list) else [out])]


def _close(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=1e-5,
                                   atol=1e-5 * max(1.0, np.abs(w).max()))


def test_proposal_matches_the_gold_and_the_reference():
    rng = np.random.RandomState(7)
    a, h, w = 4, 4, 4
    scales, ratios, fs = (8, 16), (0.5, 1.0), 16
    cls = rng.uniform(0, 1, (1, 2 * a, h, w)).astype(np.float32)
    bbox = rng.uniform(-0.3, 0.3, (1, 4 * a, h, w)).astype(np.float32)
    info = np.array([[64, 64, 1.0]], np.float32)
    kw = dict(rpn_pre_nms_top_n=12, rpn_post_nms_top_n=6, threshold=0.7,
              rpn_min_size=4, scales=scales, ratios=ratios,
              feature_stride=fs)
    got = _prop(tmx, "Proposal", cls, bbox, info, output_score=True, **kw)
    g_rois, g_score = _proposal_gold(cls, bbox, info, fs, scales, ratios, 12,
                                     6, 0.7, 4)
    np.testing.assert_allclose(got[0], g_rois, rtol=1e-4, atol=1e-3)
    np.testing.assert_allclose(got[1], g_score, rtol=1e-4, atol=1e-4)
    want = _prop(jmx, "Proposal", cls, bbox, info, output_score=True, **kw)
    np.testing.assert_array_equal(got[1], want[1])
    _close(got, want)


def test_multi_proposal_is_the_batched_proposal():
    rng = np.random.RandomState(8)
    a, h, w = 3, 3, 3
    kw = dict(rpn_pre_nms_top_n=10, rpn_post_nms_top_n=4, threshold=0.6,
              rpn_min_size=2, scales=(8,), ratios=(0.5, 1.0, 2.0),
              feature_stride=16)
    cls = rng.uniform(0, 1, (2, 2 * a, h, w)).astype(np.float32)
    bbox = rng.uniform(-0.2, 0.2, (2, 4 * a, h, w)).astype(np.float32)
    info = np.array([[48, 48, 1.0], [40, 44, 2.0]], np.float32)
    multi = _prop(tmx, "MultiProposal", cls, bbox, info, **kw)[0]
    assert multi.shape == (8, 5)
    for b in range(2):
        single = _prop(tmx, "Proposal", cls[b:b + 1], bbox[b:b + 1],
                       info[b:b + 1], **kw)[0]
        part = multi[b * 4:(b + 1) * 4]
        assert (part[:, 0] == b).all()
        np.testing.assert_array_equal(part[:, 1:], single[:, 1:])
    _close([multi], _prop(jmx, "MultiProposal", cls, bbox, info, **kw))


@pytest.mark.parametrize("threshold", [0.5, 0.7])
def test_multi_proposal_over_several_tiles(threshold):
    """A 16 x 20 map of 9 anchors a cell (2,880 boxes; 1,000 before NMS,
    four tiles), images smaller than the map (anchors past their real
    extent score -1) and a least size that drops boxes: the same picks
    as the reference, and the NMS mask equal to the sequential oracle's."""
    rng = np.random.RandomState(9)
    a, h, w = 9, 16, 20
    kw = dict(rpn_pre_nms_top_n=1000, rpn_post_nms_top_n=300,
              threshold=threshold, rpn_min_size=24, scales=(4, 8, 16),
              ratios=(0.5, 1, 2), feature_stride=16)
    cls = rng.uniform(0, 1, (2, 2 * a, h, w)).astype(np.float32)
    bbox = rng.normal(0, 0.4, (2, 4 * a, h, w)).astype(np.float32)
    info = np.array([[100, 120, 1.0], [90, 150, 1.2]], np.float32)
    got = _prop(tmx, "MultiProposal", cls, bbox, info, output_score=True,
                **kw)
    want = _prop(jmx, "MultiProposal", cls, bbox, info, output_score=True,
                 **kw)
    np.testing.assert_array_equal(got[1], want[1])
    _close(got, want)
    assert (got[1] == -1).any()
    anchors = trcnn._generate_anchors(16, kw["scales"], kw["ratios"])
    top, _, _ = trcnn.proposal_boxes(
        torch.as_tensor(cls[:, a:]), torch.as_tensor(bbox),
        torch.as_tensor(info), anchors, 16, 1000, 24.0, False)
    for b in range(2):
        assert torch.equal(trcnn._greedy_nms_suppressed(top[b], threshold),
                           trcnn._greedy_nms_suppressed_seq(top[b],
                                                            threshold))


def test_proposal_cycles_its_survivors():
    """Fewer boxes survive than rows are asked for: the survivors repeat
    in order, as proposal.cc fills."""
    rng = np.random.RandomState(10)
    cls = rng.uniform(0, 1, (1, 2, 2, 2)).astype(np.float32)
    bbox = np.zeros((1, 4, 2, 2), np.float32)
    kw = dict(rpn_pre_nms_top_n=4, rpn_post_nms_top_n=7, threshold=0.3,
              rpn_min_size=1, scales=(2,), ratios=(1,), feature_stride=8)
    info = np.array([[16, 16, 1.0]], np.float32)
    got = _prop(tmx, "Proposal", cls, bbox, info, output_score=True, **kw)
    want = _prop(jmx, "Proposal", cls, bbox, info, output_score=True, **kw)
    np.testing.assert_array_equal(got[1], want[1])
    _close(got, want)
    kept = len({tuple(r) for r in got[0][:, 1:]})
    assert kept < 7
    np.testing.assert_array_equal(got[0][kept:], got[0][:7 - kept])
