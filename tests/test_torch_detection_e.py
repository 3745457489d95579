"""`staged_grads` of `test_torch_detection_net.py`, the layer-by-layer
backward by which `chip_smoke.py`'s det phase holds a Faster R-CNN step
on the card to the CPU, checked on the CPU at a narrow width: two copies
of the model with equal weights agree on every layer's input gradient
exactly, and the parameters' gradients it writes are the whole step's
(`FasterRCNN.step` from the same rois: the same sums, to float32's
rounding, 1e-6 relative).  A layer left out of the chain, or a head
gradient sent to the wrong layer, would change some parameter's
gradient.
"""
import numpy as np

import mxtpu_torch as tmx
import test_torch_detection_net as dn
import torch

torch.set_num_threads(1)

SPEC = dn.frcnn_spec(layers=(1, 1, 0, 0, 0), filters=(8, 8, 8, 8, 8), rpn=8,
                     fc=16, rois=16, pool=2, pre_nms=300, post_nms=40,
                     side=(96, 160))


def _net(weights=None):
    ctx = tmx.cpu()
    with tmx.sym.NameManager():
        net = dn.FasterRCNN(tmx, ctx, SPEC)
    if weights is not None:
        from mxtpu_torch.gluon.parameter import load_numpy
        load_numpy(net.params, weights)
    return net


def test_staged_grads_are_the_whole_steps():
    ctx = tmx.cpu()
    x_np, info_np = dn.image(SPEC)
    x = tmx.nd.array(x_np, ctx=ctx)
    info = tmx.nd.array(info_np, ctx=ctx)
    t = dn.targets(tmx, ctx, SPEC)
    net = _net()
    rois = net.step(x, info, t)["rois"]
    weights = {k: p.data().asnumpy() for k, p in net.params.items()}
    ref, whole = _net(weights), _net(weights)
    feat = net.rpn(x)[0]
    errs, losses = dn.staged_grads(
        tmx, [(net, ctx, t), (ref, tmx.cpu(), dn.targets(tmx, ctx, SPEC))],
        x, feat, rois, lambda a, b: float(np.abs(a.asnumpy()
                                                 - b.asnumpy()).max()))
    # the loss, 4 + 1 + 1 layers of the head, 2 + 1 + 1 of the RPN,
    # ROIPooling and the backbone's 8 layers
    assert len(errs) == 4 + 6 + 5 + 8 and max(errs.values()) == 0.0
    assert losses[0] == losses[1]
    out = whole.step(x, info, t, rois=rois)
    np.testing.assert_allclose(losses[0], float(out["loss"].asnumpy()),
                               rtol=1e-6)
    for k, p in whole.params.items():
        want = p.grad().asnumpy()
        for model in (net, ref):
            np.testing.assert_allclose(model.params[k].grad().asnumpy(),
                                       want, rtol=1e-6,
                                       atol=1e-6 * np.abs(want).max(),
                                       err_msg=k)
