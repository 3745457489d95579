"""The DCGAN of `test_torch_dcgan_net.py` trained in both packages on
the CPU from the same weights: ngf = ndf = 8, 64 x 64 x 3 images, batch
4, two iterations (a D step and a G step each, Adam lr 2e-4 beta1 0.5),
hybridized and not.  The real images and the noise are numpy draws
from seeds; the port's nets take the weights `mxtpu`'s drew
(`load_numpy`, by name).

After each iteration D's and G's losses, every Parameter's gradient,
every weight and every moving statistic must agree with `mxtpu`'s
within `TOL`, a relative L2 over each group (1e-4): float32 sums in
other orders through fourteen convolutions and their transposes, six
batch normalizations of 4 samples and Adam's first steps, which divide
each gradient by its own magnitude.
"""
import numpy as np
import pytest

import mxtpu as jmx
import mxtpu_torch as tmx
from mxtpu_torch.gluon.parameter import load_numpy

import test_torch_dcgan_net as dcgan
from test_torch_gluon import _rel
import torch

torch.set_num_threads(1)

TOL = 1e-4
WIDTH, BATCH, ITERATIONS = 8, 4, 2


def _group(tree):
    return np.concatenate([np.ravel(tree[k]) for k in sorted(tree)])


def _train(mx, hybridize, weights=None):
    nets = dcgan.build(mx, mx.cpu(), WIDTH, WIDTH, hybridize)
    real = [mx.nd.array(dcgan.real_images(BATCH, seed=i), ctx=mx.cpu())
            for i in range(ITERATIONS)]
    z = [mx.nd.array(dcgan.noise(BATCH, seed=10 + i), ctx=mx.cpu())
         for i in range(ITERATIONS)]
    with mx.autograd.pause():   # the deferred shapes
        nets[1](nets[0](z[0]))
    if weights is None:
        weights = {k: p.data().asnumpy() for net in nets
                   for k, p in net.collect_params().items()}
    else:
        for net in nets:
            load_numpy(net.collect_params(), {
                k: weights[k] for k in net.collect_params().keys()})
    steppers = dcgan.trainers(mx, *nets)
    loss_fn = mx.gluon.loss.SigmoidBinaryCrossEntropyLoss()
    out = []
    for i in range(ITERATIONS):
        err_d, err_g = dcgan.iteration(mx, nets, steppers, loss_fn, real[i],
                                       z[i])
        out.append(((err_d.asnumpy(), err_g.asnumpy()), dcgan.state(nets)))
    return weights, out


_REFERENCE = []


@pytest.mark.parametrize("hybridize", [False, True])
def test_two_iterations_match_the_reference(hybridize):
    if not _REFERENCE:      # once a process: the reference runs hybridized
        _REFERENCE.append(_train(jmx, True))
    weights, ref = _REFERENCE[0]
    _, got = _train(tmx, hybridize, weights)
    for i, ((jl, js), (tl, ts)) in enumerate(zip(ref, got)):
        for a, b in zip(tl, jl):
            assert np.isfinite(a).all() and _rel(a, b) <= TOL, (i, _rel(a, b))
        for what in js:
            assert set(ts[what]) == set(js[what]), what
            err = _rel(_group(ts[what]), _group(js[what]))
            assert err <= TOL, (i, what, err)
