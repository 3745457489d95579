"""The slice as a whole: Faster R-CNN (`test_torch_detection_net.py`) at a
narrow width, one step in the port and in the JAX package on the CPU
from the same weights, image and targets: the RPN's scores and deltas,
`MultiProposal`'s rois, `ROIPooling`'s features, the loss and every
parameter's gradient.

The backbone is the zoo's VGG class cut to one 3x3 conv of 8 channels
and the four pools before conv5 (stride 16), the RPN 8 wide, fc6
and fc7 16 wide, 16 ROIs pooled 2 x 2 from 300 boxes kept before NMS and
40 after.  Tolerances: float32's, 1e-5 relative on the forward values
(the rois: of their largest coordinate), 1e-4 relative L2 on each
gradient.
"""
import numpy as np

import mxtpu as jmx
import mxtpu_torch as tmx
from mxtpu_torch.gluon.parameter import load_numpy
import test_torch_detection_net as dn
import torch

torch.set_num_threads(1)

SPEC = dn.frcnn_spec(layers=(1, 0, 0, 0, 0), filters=(8, 8, 8, 8, 8), rpn=8,
                     fc=16, rois=16, pool=2, pre_nms=300, post_nms=40,
                     side=(96, 160))


def _step(mx, weights=None):
    ctx = mx.cpu()
    net = dn.FasterRCNN(mx, ctx, SPEC)
    if weights is not None:
        load_numpy(net.params, weights)
    x, info = dn.image(SPEC)
    out = net.step(mx.nd.array(x, ctx=ctx), mx.nd.array(info, ctx=ctx),
                   dn.targets(mx, ctx, SPEC))
    return ({k: v.asnumpy() for k, v in out.items()},
            {k: p.grad().asnumpy() for k, p in net.params.items()},
            {k: p.data().asnumpy() for k, p in net.params.items()})


def test_faster_rcnn_step_matches_the_reference():
    want, want_grads, weights = _step(jmx)
    got, grads, _ = _step(tmx, weights)
    assert set(grads) == set(want_grads) and len(grads) == 16
    for k in ("score", "delta", "feat", "pooled", "loss"):
        np.testing.assert_allclose(got[k], want[k], rtol=1e-5,
                                   atol=1e-6 * max(1.0,
                                                   np.abs(want[k]).max()))
    np.testing.assert_array_equal(got["rois"][:, 0], want["rois"][:, 0])
    np.testing.assert_allclose(got["rois"], want["rois"], rtol=1e-5,
                               atol=1e-5 * np.abs(want["rois"]).max())
    assert np.isfinite(got["loss"]).all()
    for k, g in grads.items():
        w = want_grads[k]
        assert np.linalg.norm(g - w) <= 1e-4 * np.linalg.norm(w), k
