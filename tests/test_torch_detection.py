"""The PyTorch port's detection ops (`mxtpu_torch/ops/contrib.py`,
`vision.py`, `rcnn.py`) against the JAX package's on the CPU, beyond the
op sweep's cases (`test_torch_op_cases.py`): ROIPooling's gradient on
tied maxima, its separable max against a plain numpy transcription of
the JAX package's masked max at a Faster R-CNN head's pooling (7 x 7,
ROIs past the image, degenerate ROIs), the symbol metadata of the new
ops (the deformable convolution's auto-created weight and bias, the
optional `trans`), SyncBatchNorm's moving statistics through a Module,
and the names under `nd`, `nd.contrib`, `sym` and `sym.contrib`.

Tolerances: float32 forward 1e-5 relative, gradients 1e-4 (and exact
where the arithmetic is: a max, a count); names and shapes equal.
"""
import numpy as np
import pytest

import mxtpu as jmx
import mxtpu_torch as tmx
import torch

torch.set_num_threads(1)

NAMES = {
    "nd": ("ROIPooling", "GridGenerator", "BilinearSampler",
           "SpatialTransformer", "Correlation", "MultiBoxTarget",
           "MultiBoxDetection"),
    "contrib": ("ROIAlign", "box_iou", "box_nms", "bipartite_matching",
                "MultiBoxPrior", "SyncBatchNorm", "arange_like",
                "MultiBoxTarget", "MultiBoxDetection", "Proposal",
                "MultiProposal", "PSROIPooling", "DeformableConvolution",
                "DeformablePSROIPooling"),
}


def _pool(mx, data, rois, **kw):
    x = mx.nd.array(data, ctx=mx.cpu())
    x.attach_grad()
    with mx.autograd.record():
        y = mx.nd.ROIPooling(x, mx.nd.array(rois, ctx=mx.cpu()), **kw)
    y.backward(mx.nd.ones(y.shape, ctx=mx.cpu()))
    return y.asnumpy(), x.grad.asnumpy()


def test_roi_pooling_splits_a_bin_gradient_over_its_tied_maxima():
    """A bin [[v, v], [v, u]], u < v: each v gets a third (XLA's
    reduce_max VJP), where two chained maxima would give 1/4, 1/4, 1/2."""
    data = np.array([[[[2.0, 2.0], [2.0, 1.0]]]], np.float32)
    rois = np.array([[0, 0, 0, 1, 1]], np.float32)
    want = _pool(jmx, data, rois, pooled_size=(1, 1))
    got = _pool(tmx, data, rois, pooled_size=(1, 1))
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_allclose(got[1], want[1], rtol=1e-6)
    np.testing.assert_allclose(got[1][0, 0], [[1 / 3, 1 / 3], [1 / 3, 0]],
                               rtol=1e-6)


def test_roi_pooling_gradient_on_relu_ties_matches_the_reference():
    """A ReLU'd map (a third zeros, values in halves), 2 x 2 bins that
    overlap: every tied maximum of a bin takes its share."""
    rng = np.random.RandomState(3)
    data = np.maximum(np.round(rng.uniform(-1, 2, (1, 2, 5, 5)) * 2) / 2,
                      0).astype(np.float32)
    rois = np.array([[0, 0, 0, 4, 4], [0, 1, 0, 3, 4]], np.float32)
    want = _pool(jmx, data, rois, pooled_size=(2, 2))
    got = _pool(tmx, data, rois, pooled_size=(2, 2))
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_allclose(got[1], want[1], rtol=1e-4, atol=1e-6)


def roi_pool_reference(data, rois, ph, pw, scale):
    """The JAX package's ROIPooling transcribed to numpy loops: rounded
    corners, rw and rh at least 1, floor/ceil bin edges, an empty bin 0."""
    n, c, h, w = data.shape
    out = np.zeros((len(rois), c, ph, pw), np.float32)
    for r, roi in enumerate(rois):
        b = int(roi[0])
        x1, y1, x2, y2 = (int(np.round(np.float32(v) * np.float32(scale)))
                          for v in roi[1:])
        rw, rh = max(x2 - x1 + 1, 1), max(y2 - y1 + 1, 1)
        for iy in range(ph):
            hs = max(y1 + (iy * rh) // ph, 0)
            he = min(y1 + ((iy + 1) * rh + ph - 1) // ph, h)
            for ix in range(pw):
                ws = max(x1 + (ix * rw) // pw, 0)
                we = min(x1 + ((ix + 1) * rw + pw - 1) // pw, w)
                if hs < he and ws < we:
                    out[r, :, iy, ix] = data[b, :, hs:he, ws:we].max((1, 2))
    return out


def test_roi_pooling_at_a_head_shape_matches_the_masked_max():
    """7 x 7 bins at 1/16 over a 24 x 40 map of 16 channels, 24 ROIs of
    every size, some past the image or degenerate: equal to the masked
    max, value for value."""
    rng = np.random.RandomState(5)
    data = rng.normal(0, 1, (2, 16, 24, 40)).astype(np.float32)
    xy1 = rng.uniform(-64, 600, (24, 2))
    wh = rng.uniform(-16, 400, (24, 2))
    rois = np.concatenate([rng.randint(0, 2, (24, 1)), xy1, xy1 + wh],
                          1).astype(np.float32)
    got = tmx.nd.ROIPooling(tmx.nd.array(data, ctx=tmx.cpu()),
                            tmx.nd.array(rois, ctx=tmx.cpu()),
                            pooled_size=(7, 7), spatial_scale=1 / 16)
    np.testing.assert_array_equal(got.asnumpy(), roi_pool_reference(
        data, rois, 7, 7, 1 / 16))


@pytest.mark.parametrize("kw", [dict(no_bias=False), dict(no_bias=True)])
def test_deformable_convolution_symbol_creates_weight_and_bias(kw):
    shapes = {}
    for mx in (jmx, tmx):
        s = mx.sym
        net = s.contrib.DeformableConvolution(
            data=s.var("data"), offset=s.var("offset"), kernel=(3, 3),
            pad=(1, 1), num_filter=6, num_group=2, name="dc", **kw)
        args, outs, _ = net.infer_shape(data=(2, 4, 7, 7),
                                        offset=(2, 18, 7, 7))
        shapes[mx] = (net.list_arguments(), args, outs)
    assert shapes[tmx] == shapes[jmx]
    assert shapes[tmx][0][2:] == (["dc_weight"] if kw["no_bias"]
                                  else ["dc_weight", "dc_bias"])
    assert tuple(shapes[tmx][1][2]) == (6, 2, 3, 3)


@pytest.mark.parametrize("no_trans", [False, True])
def test_deformable_psroi_pooling_symbol_inputs(no_trans):
    got = {}
    for mx in (jmx, tmx):
        s = mx.sym
        net = s.contrib.DeformablePSROIPooling(
            data=s.var("data"), rois=s.var("rois"),
            **({} if no_trans else {"trans": s.var("trans")}),
            spatial_scale=0.5, output_dim=2, group_size=3, pooled_size=3,
            no_trans=no_trans, name="dp")
        got[mx] = net.list_arguments()
    assert got[tmx] == got[jmx]


def _bn_module(mx, op):
    s = mx.sym
    bn = getattr(s, op) if op == "BatchNorm" else s.contrib.SyncBatchNorm
    net = s.MakeLoss(s.mean(s.square(bn(s.var("data"), fix_gamma=False,
                                        momentum=0.8, name="bn"))))
    mod = mx.mod.Module(net, data_names=("data",), label_names=None,
                        context=mx.cpu())
    mod.bind(data_shapes=[("data", (4, 3, 2, 2))])
    mod.init_params(mx.init.Constant(0.5))
    mod.init_optimizer(optimizer_params={"learning_rate": 0.1})
    x = (np.random.RandomState(2).normal(0, 2, (4, 3, 2, 2)) + 3) \
        .astype(np.float32)
    mod.forward(mx.io.DataBatch([mx.nd.array(x, ctx=mx.cpu())], None),
                is_train=True)
    mod.backward()
    mod.update()
    args, aux = mod.get_params()
    return ({k: v.asnumpy() for k, v in args.items()},
            {k: v.asnumpy() for k, v in aux.items()})


def test_sync_batch_norm_trains_and_folds_its_moving_stats():
    """SyncBatchNorm in a Module is BatchNorm on one device: one step's
    weights and moving statistics equal BatchNorm's, in the port and in
    the reference."""
    t_sync, t_bn = _bn_module(tmx, "SyncBatchNorm"), _bn_module(tmx,
                                                                "BatchNorm")
    j_sync = _bn_module(jmx, "SyncBatchNorm")
    for k in ("bn_moving_mean", "bn_moving_var"):
        assert not np.allclose(t_sync[1][k], 0.5)
    for got, want in ((t_sync, t_bn), (t_sync, j_sync)):
        for part in (0, 1):
            assert set(got[part]) == set(want[part])
            for k in got[part]:
                np.testing.assert_allclose(got[part][k], want[part][k],
                                           rtol=1e-5, atol=1e-6)


def test_detection_names_under_nd_and_sym():
    for where in ("nd", "sym"):
        for name in NAMES["nd"]:
            assert hasattr(getattr(jmx, where), name), (where, name)
            assert hasattr(getattr(tmx, where), name), (where, name)
        for name in NAMES["contrib"]:
            assert hasattr(getattr(jmx, where).contrib, name), (where, name)
            assert hasattr(getattr(tmx, where).contrib, name), (where, name)
