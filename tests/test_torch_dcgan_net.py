"""The DCGAN of Radford et al. (ICLR 2016), as MXNet's
`example/gluon/dc_gan/dcgan.py` builds and trains it, written against
the gluon API both packages share: `generator`, `discriminator`,
their Trainers, one training iteration and the nets' state.
`test_torch_dcgan.py` trains it narrow in both packages on the CPU; `chip_smoke.py`'s gan phase trains
it at its published widths (nz 100, ngf = ndf = 64, 64 x 64 x 3) on
the card.  This file imports only numpy and holds no test.

G: `Conv2DTranspose(8 ngf, 4, 1, 0)`, then `(4|2|1 ngf, 4, 2, 1)`,
each followed by BatchNorm and relu, then `Conv2DTranspose(3, 4, 2,
1)` and tanh.  D: `Conv2D(ndf, 4, 2, 1)` and `LeakyReLU(0.2)`, then
`(2|4|8 ndf, 4, 2, 1)`, each followed by BatchNorm and
`LeakyReLU(0.2)`, then `Conv2D(1, 4, 1, 0)`.  Both without biases.
An iteration: a D step on a real and a fake batch (the fake detached),
then a G step (the non-saturating loss), each through
`SigmoidBinaryCrossEntropyLoss` and Adam (lr 2e-4, beta1 0.5).
"""
import numpy as np

NZ, NGF, NDF, SIDE = 100, 64, 64, 64
LR, BETA1 = 2e-4, 0.5


def generator(mx, ngf=NGF, nc=3):
    nn = mx.gluon.nn
    net = nn.HybridSequential(prefix="generator_")
    with net.name_scope():
        for i, mult in enumerate((8, 4, 2, 1)):
            net.add(nn.Conv2DTranspose(ngf * mult, 4, 1 if i == 0 else 2,
                                       0 if i == 0 else 1, use_bias=False),
                    nn.BatchNorm(), nn.Activation("relu"))
        net.add(nn.Conv2DTranspose(nc, 4, 2, 1, use_bias=False),
                nn.Activation("tanh"))
    return net


def discriminator(mx, ndf=NDF):
    nn = mx.gluon.nn
    net = nn.HybridSequential(prefix="discriminator_")
    with net.name_scope():
        net.add(nn.Conv2D(ndf, 4, 2, 1, use_bias=False), nn.LeakyReLU(0.2))
        for mult in (2, 4, 8):
            net.add(nn.Conv2D(ndf * mult, 4, 2, 1, use_bias=False),
                    nn.BatchNorm(), nn.LeakyReLU(0.2))
        net.add(nn.Conv2D(1, 4, 1, 0, use_bias=False))
    return net


def build(mx, ctx, ngf=NGF, ndf=NDF, hybridize=True):
    """(G, D) in a fresh NameManager, initialized as the example does
    (Normal(0.02) after ``random.seed(0)``; the shapes, so the draws,
    come with the first forward)."""
    with mx.sym.NameManager():
        net_g, net_d = generator(mx, ngf), discriminator(mx, ndf)
    mx.random.seed(0)
    for net in (net_g, net_d):
        net.initialize(mx.init.Normal(0.02), ctx=ctx)
        if hybridize:
            net.hybridize()
    return net_g, net_d


def trainers(mx, net_g, net_d):
    return [mx.gluon.Trainer(net.collect_params(), "adam",
                             {"learning_rate": LR, "beta1": BETA1})
            for net in (net_g, net_d)]


def real_images(batch, side=SIDE, seed=0):
    """Images in [-1, 1] drawn from ``seed`` (the repo holds no
    dataset): each a smooth gradient with a bright disc on it."""
    rng = np.random.RandomState(seed)
    yy, xx = np.mgrid[:side, :side] / float(side)
    out = np.empty((batch, 3, side, side), np.float32)
    for i in range(batch):
        cx, cy, r = rng.uniform(0.25, 0.75, 2).tolist() + [
            rng.uniform(0.1, 0.3)]
        disc = ((xx - cx) ** 2 + (yy - cy) ** 2 < r * r).astype(np.float64)
        for c in range(3):
            a, b = rng.uniform(-1, 1, 2)
            out[i, c] = np.clip(0.5 * (a * xx + b * yy) + disc
                                * rng.uniform(0.5, 1.0) - 0.25, -1, 1)
    return out


def noise(batch, nz=NZ, seed=1):
    return np.random.RandomState(seed).normal(0, 1, (batch, nz, 1, 1)) \
        .astype(np.float32)


def iteration(mx, nets, steppers, loss_fn, real, z, mark=None):
    """One iteration of the example's loop on the arrays ``real`` and
    ``z``: returns (D's loss, G's loss) as arrays a sample.  ``mark``,
    when given, is called with each stage's name as it ends: "d"
    (D's forward and backward), "d_update", "g", "g_update"."""
    net_g, net_d = nets
    trainer_g, trainer_d = steppers
    mark = mark or (lambda stage: None)
    batch = real.shape[0]
    ones = mx.nd.ones((batch,), ctx=real.ctx)
    zeros = mx.nd.zeros((batch,), ctx=real.ctx)
    with mx.autograd.record():
        err_real = loss_fn(net_d(real).reshape((-1, 1)), ones)
        fake = net_g(z)
        err_fake = loss_fn(net_d(fake.detach()).reshape((-1, 1)), zeros)
        err_d = err_real + err_fake
    err_d.backward()
    mark("d")
    trainer_d.step(batch)
    mark("d_update")
    with mx.autograd.record():
        err_g = loss_fn(net_d(net_g(z)).reshape((-1, 1)), ones)
    err_g.backward()
    mark("g")
    trainer_g.step(batch)
    mark("g_update")
    return err_d, err_g


def state(nets):
    """{group: {parameter: numpy}} of the nets: "gradients", "weights"
    and "moving stats"."""
    out = {"gradients": {}, "weights": {}, "moving stats": {}}
    for net in nets:
        for k, p in net.collect_params().items():
            if p.grad_req == "null":
                out["moving stats"][k] = p.data().asnumpy()
            else:
                out["gradients"][k] = p.grad().asnumpy()
                out["weights"][k] = p.data().asnumpy()
    return out
