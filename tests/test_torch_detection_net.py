"""Faster R-CNN with a VGG16 backbone and SSD300's detection heads, for
either package (`mx` is passed in), as the reference's `example/rcnn`
and `example/ssd` configure them.

Faster R-CNN (VOC: 21 classes): the zoo's VGG16 features up to conv5_3
(no pool5: stride 16); an RPN of a 3x3 conv of 512 channels and 1x1
heads for 9 anchors (scales 8, 16, 32; ratios 0.5, 1, 2);
`contrib.MultiProposal` (stride 16, 12,000 boxes before NMS, 2,000
after, IoU 0.7, least size 16); the first 128 proposals into
`ROIPooling` 7x7 at 1/16; fc6 and fc7 of 4096 (no dropout, so that two
devices' steps can be compared); a 21-way classifier and an 84-wide box
regression.  The loss is the RPN's softmax cross-entropy and smooth L1
over 256 sampled anchors plus the head's over its ROIs, with labels and
targets drawn from a seed (random weights: nothing is downloaded).
`frcnn_spec(...)` narrows every width and depth for the CPU tests.
`staged_grads` runs a step's backward layer by layer on two copies of
the model (the card's and the CPU's), each layer from the first copy's
input.

SSD300 (VGG16-reduced at 300x300, `example/ssd`'s config): the six
feature maps 38, 19, 10, 5, 3, 1 with their sizes, ratios and steps give
8,732 anchors.

Used by `test_torch_detection_c.py` at a narrow width and by
`chip_smoke.py`'s det phase at the published one.  Imports numpy only
and holds no test.
"""
import numpy as np

CLASSES = 21
RPN_SCALES = (8, 16, 32)
RPN_RATIOS = (0.5, 1, 2)
STRIDE = 16
VGG16 = dict(layers=(2, 2, 3, 3, 3), filters=(64, 128, 256, 512, 512),
             rpn=512, fc=4096, rois=128, pool=7, pre_nms=12000,
             post_nms=2000, side=(600, 1000))
RPN_SAMPLES = 256
LR = 0.001

SSD300_MAPS = (38, 19, 10, 5, 3, 1)
SSD300_SIZES = ((0.1, 0.141), (0.2, 0.272), (0.37, 0.447), (0.54, 0.619),
                (0.71, 0.79), (0.88, 0.961))
SSD300_RATIOS = ((1, 2, 0.5),) + ((1, 2, 0.5, 3, 1.0 / 3),) * 3 + \
    ((1, 2, 0.5),) * 2
SSD300_STEPS = tuple(s / 300.0 for s in (8, 16, 32, 64, 100, 300))
SSD300_ANCHORS = 8732


def frcnn_spec(**narrow):
    """VGG16's spec with the given entries replaced."""
    return dict(VGG16, **narrow)


def proposal_attrs(spec):
    return dict(feature_stride=STRIDE, rpn_pre_nms_top_n=spec["pre_nms"],
                rpn_post_nms_top_n=spec["post_nms"], threshold=0.7,
                rpn_min_size=16, scales=RPN_SCALES, ratios=RPN_RATIOS)


class FasterRCNN(object):
    """The blocks of the model, built under fixed prefixes (the same
    parameter names in both packages)."""

    def __init__(self, mx, ctx, spec=VGG16):
        nn = mx.gluon.nn
        self.mx, self.spec = mx, spec
        a = len(RPN_SCALES) * len(RPN_RATIOS)
        vgg = mx.gluon.model_zoo.vision.VGG(list(spec["layers"]),
                                            list(spec["filters"]),
                                            prefix="vgg0_")
        # conv5_3's ReLU is the last layer before pool5
        self.body = vgg.features[:len(vgg.features) - 5]
        self.rpn_conv = nn.Conv2D(spec["rpn"], 3, padding=1,
                                  activation="relu", prefix="rpn_conv_")
        self.rpn_cls = nn.Conv2D(2 * a, 1, prefix="rpn_cls_")
        self.rpn_reg = nn.Conv2D(4 * a, 1, prefix="rpn_bbox_")
        self.fc6 = nn.Dense(spec["fc"], activation="relu", prefix="fc6_")
        self.fc7 = nn.Dense(spec["fc"], activation="relu", prefix="fc7_")
        self.cls = nn.Dense(CLASSES, prefix="cls_score_")
        self.reg = nn.Dense(4 * CLASSES, prefix="bbox_pred_")
        self.blocks = [self.body, self.rpn_conv, self.rpn_cls, self.rpn_reg,
                       self.fc6, self.fc7, self.cls, self.reg]
        self.params = mx.gluon.ParameterDict()
        for b in self.blocks:
            self.params.update(b.collect_params())
        self.params.initialize(mx.init.Xavier(), ctx=ctx)

    def rpn(self, x):
        """(conv5_3's features, the RPN's logits, scores, deltas)."""
        feat = self.body(x)
        return (feat,) + self.rpn_head(feat)

    def rpn_head(self, feat):
        nd = self.mx.nd
        r = self.rpn_conv(feat)
        logits = self.rpn_cls(r)
        n, c, h, w = logits.shape
        score = nd.softmax(logits.reshape((0, 2, -1)), axis=1) \
            .reshape((0, c, h, w))
        return logits, score, self.rpn_reg(r)

    def proposals(self, score, delta, im_info):
        nd = self.mx.nd
        rois = nd.contrib.MultiProposal(nd.BlockGrad(score),
                                        nd.BlockGrad(delta), im_info,
                                        **proposal_attrs(self.spec))
        return rois[:self.spec["rois"]]

    def head(self, feat, rois):
        pool = self.spec["pool"]
        pooled = self.mx.nd.ROIPooling(feat, rois, pooled_size=(pool, pool),
                                       spatial_scale=1.0 / STRIDE)
        h = self.fc7(self.fc6(pooled.reshape((pooled.shape[0], -1))))
        return pooled, self.cls(h), self.reg(h)

    def loss(self, logits, delta, cls_out, reg_out, t):
        """The RPN's and the head's losses (``t`` from ``targets``)."""
        nd = self.mx.nd
        logp = nd.log_softmax(logits.reshape((0, 2, -1)), axis=1)[0]
        rpn_ce = -(nd.pick(logp, t["rpn_label"], axis=0)
                   * t["rpn_weight"]).sum() / RPN_SAMPLES
        rpn_l1 = (nd.smooth_l1(delta - t["rpn_target"], scalar=3.0)
                  * t["rpn_box_weight"]).sum() / RPN_SAMPLES
        ce = nd.softmax_cross_entropy(cls_out, t["label"]) \
            / t["label"].shape[0]
        l1 = (nd.smooth_l1(reg_out - t["target"], scalar=1.0)
              * t["box_weight"]).sum() / t["label"].shape[0]
        return rpn_ce + rpn_l1 + ce + l1

    def step(self, x, im_info, t, rois=None):
        """One forward and backward; the proposals are made here unless
        ``rois`` is given.  Returns the tensors of the step."""
        mx = self.mx
        with mx.autograd.record():
            feat, logits, score, delta = self.rpn(x)
            if rois is None:
                rois = self.proposals(score, delta, im_info)
            pooled, cls_out, reg_out = self.head(feat, rois)
            loss = self.loss(logits, delta, cls_out, reg_out, t)
        loss.backward()
        return dict(loss=loss, rois=rois, pooled=pooled, score=score,
                    delta=delta, feat=feat)


def no_act(block, x):
    """``block`` applied to ``x`` without its fused activation."""
    act, block.act = block.act, None
    try:
        return block(x)
    finally:
        block.act = act


def staged_grads(mx, pair, x, feat, rois, err):
    """One step's backward from the loss down to the image, layer by
    layer, on two copies of a model: ``pair`` is ``[(net, ctx, t), (ref,
    ctx, t)]`` with equal weights and each its own ``targets``.  Each
    layer (the loss; every linear part, ReLU, ROIPooling and pool apart)
    gets the first model's input and the first model's gradient of its
    output on both, and the first model's gradient of its input goes on
    to the layer below, so that a ReLU or a max decides alike on both
    even where the two round apart.  ``feat`` and ``rois`` are the first
    model's conv5_3 features of ``x`` and its rois.  Each parameter's
    gradient is written (grad_req "write"); returns ``{name: err(a, b)}``
    over every layer's input gradients and the loss on each copy."""
    (net, ctx_a, _), (ref, ctx_b, _) = pair
    for model, _, _ in pair:
        for p in model.params.values():
            p.zero_grad()
    errs, losses = {}, []
    pool = net.spec["pool"]
    rois_at = {id(ctx_a): rois, id(ctx_b): rois.as_in_context(ctx_b)}

    def roi_pool(ctx):
        def fn(f):
            out = mx.nd.ROIPooling(f, rois_at[id(ctx)],
                                   pooled_size=(pool, pool),
                                   spatial_scale=1.0 / STRIDE)
            return out.reshape((out.shape[0], -1))
        return fn

    def stage(name, layer, inputs, head):
        """``layer(model, ctx, t)`` gives the function of ``inputs``;
        returns the first model's gradients of ``inputs`` under the head
        gradient ``head`` (None: the output is the loss)."""
        grads = []
        for model, ctx, t in pair:
            xs = [v.as_in_context(ctx).copy() for v in inputs]
            for v in xs:
                v.attach_grad()
            with mx.autograd.record():
                y = layer(model, ctx, t)(*xs)
            y.backward(None if head is None else head.as_in_context(ctx))
            if head is None:
                losses.append(float(y.asnumpy()))
            grads.append([v.grad for v in xs])
        for i, (a, b) in enumerate(zip(*grads)):
            errs["%s input %d" % (name, i)] = err(a, b)
        return grads[0]

    # the first model's forward from conv5_3's features, each input kept
    rz = no_act(net.rpn_conv, feat)
    r = net.rpn_conv.act(rz)
    logits, delta = net.rpn_cls(r), net.rpn_reg(r)
    flat = roi_pool(ctx_a)(feat)
    z6 = no_act(net.fc6, flat)
    h6 = net.fc6.act(z6)
    z7 = no_act(net.fc7, h6)
    h7 = net.fc7.act(z7)
    cls_out, reg_out = net.cls(h7), net.reg(h7)

    g_logits, g_delta, g_cls, g_reg = stage(
        "loss", lambda m, ctx, t: lambda a, b, c, d: m.loss(a, b, c, d, t),
        [logits, delta, cls_out, reg_out], None)
    g_h7 = stage("cls_score", lambda m, ctx, t: m.cls, [h7], g_cls)[0] \
        + stage("bbox_pred", lambda m, ctx, t: m.reg, [h7], g_reg)[0]
    g_z7, = stage("fc7 relu", lambda m, ctx, t: m.fc7.act, [z7], g_h7)
    g_h6, = stage("fc7", lambda m, ctx, t: lambda v: no_act(m.fc7, v),
                  [h6], g_z7)
    g_z6, = stage("fc6 relu", lambda m, ctx, t: m.fc6.act, [z6], g_h6)
    g_flat, = stage("fc6", lambda m, ctx, t: lambda v: no_act(m.fc6, v),
                    [flat], g_z6)
    g_feat, = stage("roi pooling", lambda m, ctx, t: roi_pool(ctx), [feat],
                    g_flat)
    g_r = stage("rpn_cls", lambda m, ctx, t: m.rpn_cls, [r], g_logits)[0] \
        + stage("rpn_bbox", lambda m, ctx, t: m.rpn_reg, [r], g_delta)[0]
    g_rz, = stage("rpn relu", lambda m, ctx, t: m.rpn_conv.act, [rz], g_r)
    upstream = g_feat + stage(
        "rpn_conv", lambda m, ctx, t: lambda v: no_act(m.rpn_conv, v),
        [feat], g_rz)[0]
    inputs, h = [], x
    for layer in net.body:
        inputs.append(h)
        h = layer(h)
    for i in reversed(range(len(inputs))):
        upstream, = stage("layer %d" % i,
                          lambda m, ctx, t, i=i: m.body[i], [inputs[i]],
                          upstream)
    return errs, losses


def image(spec, seed=0):
    """One image (1, 3, H, W) of normalised pixels and its im_info."""
    h, w = spec["side"]
    x = np.random.RandomState(seed).normal(0, 1, (1, 3, h, w))
    return x.astype(np.float32), np.array([[h, w, 1.0]], np.float32)


def targets(mx, ctx, spec, seed=1):
    """Labels and targets of one step, drawn from ``seed``: 256 sampled
    anchors (half foreground) of the (H/16) x (W/16) x 9 map, and
    ``spec["rois"]`` ROIs' classes and box targets."""
    rng = np.random.RandomState(seed)
    a = len(RPN_SCALES) * len(RPN_RATIOS)
    # the backbone's four pools halve each side, rounding down
    fh, fw = (s // 2 // 2 // 2 // 2 for s in spec["side"])
    k = a * fh * fw
    picked = rng.choice(k, RPN_SAMPLES, replace=False)
    label = np.zeros(k, np.float32)
    label[picked[:RPN_SAMPLES // 2]] = 1.0
    weight = np.zeros(k, np.float32)
    weight[picked] = 1.0
    box_w = np.zeros((1, 4 * a, fh, fw), np.float32)
    fg = np.unravel_index(picked[:RPN_SAMPLES // 2], (a, fh, fw))
    for j in range(4):
        box_w[0, fg[0] * 4 + j, fg[1], fg[2]] = 1.0
    r = spec["rois"]
    cls = rng.randint(0, CLASSES, r)
    bw = np.zeros((r, 4 * CLASSES), np.float32)
    for i, c in enumerate(cls):
        if c:
            bw[i, 4 * c:4 * c + 4] = 1.0
    arr = lambda v: mx.nd.array(v, ctx=ctx)  # noqa: E731
    return dict(
        rpn_label=arr(label), rpn_weight=arr(weight),
        rpn_target=arr(rng.normal(0, 0.1, (1, 4 * a, fh, fw))
                       .astype(np.float32)),
        rpn_box_weight=arr(box_w), label=arr(cls.astype(np.float32)),
        target=arr(rng.normal(0, 0.1, (r, 4 * CLASSES)).astype(np.float32)),
        box_weight=arr(bw))


def ssd300_anchors(mx, ctx):
    """MultiBoxPrior over the six maps of SSD300: (1, 8732, 4)."""
    nd = mx.nd
    out = []
    for side, sizes, ratios, step in zip(SSD300_MAPS, SSD300_SIZES,
                                         SSD300_RATIOS, SSD300_STEPS):
        feat = nd.zeros((1, 1, side, side), ctx=ctx)
        out.append(nd.contrib.MultiBoxPrior(feat, sizes=sizes,
                                            ratios=ratios,
                                            steps=(step, step)))
    return nd.concat(*out, dim=1)


def ssd_labels(batch, max_boxes=8, seed=0):
    """(batch, max_boxes, 5) ground truth [cls, x1, y1, x2, y2], 1 to
    ``max_boxes`` boxes an image of VOC's 20 classes, -1 rows after."""
    rng = np.random.RandomState(seed)
    lab = np.full((batch, max_boxes, 5), -1.0, np.float32)
    for i in range(batch):
        k = rng.randint(1, max_boxes + 1)
        c = rng.uniform(0.1, 0.9, (k, 2))
        wh = rng.uniform(0.05, 0.5, (k, 2))
        lab[i, :k, 0] = rng.randint(0, CLASSES - 1, k)
        lab[i, :k, 1:3] = np.clip(c - wh / 2, 0, 1)
        lab[i, :k, 3:5] = np.clip(c + wh / 2, 0, 1)
    return lab


def ssd_predictions(batch, anchors=SSD300_ANCHORS, seed=0):
    """Class probabilities (batch, 21, anchors) and box offsets
    (batch, anchors * 4) as an untrained head gives them."""
    rng = np.random.RandomState(seed)
    logits = rng.normal(0, 1, (batch, CLASSES, anchors))
    e = np.exp(logits - logits.max(1, keepdims=True))
    probs = (e / e.sum(1, keepdims=True)).astype(np.float32)
    loc = rng.normal(0, 0.5, (batch, anchors * 4)).astype(np.float32)
    return probs, loc
