"""The CIFAR-10 input pipeline and its ResNet-18 v1, for either package
(`mx` is passed in): CIFAR-10's published binary batches written with
numpy, `gluon.data.vision.CIFAR10` over them, the train transform
(`RandomFlipLeftRight`, `ToTensor`, `Normalize` with CIFAR-10's channel
means and deviations), a seeded shuffling `DataLoader`, and
`resnet18_v1(classes=10)` trained by a Trainer with SGD (lr 0.1,
momentum 0.9, wd 5e-4).  The same images as numpy with the transform in
numpy (`numpy_dataset`) feed process workers, which take no NDArray.
Used by `test_torch_cifar.py` at a few images and by `chip_smoke.py`'s
data phase at the dataset's 50,000.  Imports numpy only and holds no
test.
"""
import os

import numpy as np

MEAN = (0.4914, 0.4822, 0.4465)
STD = (0.2023, 0.1994, 0.2010)
ROW = 1 + 32 * 32 * 3
TRAIN_FILES = ["data_batch_%d.bin" % i for i in range(1, 6)]
OPT = {"learning_rate": 0.1, "momentum": 0.9, "wd": 5e-4}


def write_cifar10(root, per_file=10000, seed=0, test=False):
    """CIFAR-10's binary batches under ``root/cifar-10-batches-bin``: the
    five training files (and the test file) of ``per_file`` rows, each a
    label byte and 3,072 bytes of channel-major 32x32 pixels; returns
    the bytes written."""
    base = os.path.join(root, "cifar-10-batches-bin")
    os.makedirs(base, exist_ok=True)
    rng = np.random.RandomState(seed)
    total = 0
    for name in TRAIN_FILES + (["test_batch.bin"] if test else []):
        rows = np.empty((per_file, ROW), np.uint8)
        rows[:, 0] = rng.randint(0, 10, per_file)
        rows[:, 1:] = rng.randint(0, 256, (per_file, ROW - 1))
        with open(os.path.join(base, name), "wb") as f:
            f.write(rows.tobytes())
        total += rows.nbytes
    return total


def transform(mx, flip=True):
    T = mx.gluon.data.vision.transforms
    steps = [T.RandomFlipLeftRight()] if flip else []
    return T.Compose(steps + [T.ToTensor(), T.Normalize(MEAN, STD)])


def loader(mx, root, batch, workers, seed, flip=True, **kw):
    """The training images of ``root`` through the transform, shuffled
    from ``seed``, the last partial batch discarded."""
    ds = mx.gluon.data.vision.CIFAR10(root=root, train=True)
    return mx.gluon.data.DataLoader(
        ds.transform_first(transform(mx, flip)), batch_size=batch,
        shuffle=True, last_batch="discard", num_workers=workers, seed=seed,
        **kw)


class NumpyTransform(object):
    """ToTensor and Normalize in numpy float32, the same arithmetic as
    the image ops (x / 255, then (x - mean) / std)."""

    def __call__(self, x):
        x = x.astype(np.float32) / np.float32(255.0)
        x = (x - np.asarray(MEAN, np.float32)) / np.asarray(STD, np.float32)
        return np.ascontiguousarray(x.transpose(2, 0, 1))


def numpy_dataset(mx, root):
    """The training images as numpy (uint8 HWC, int32 labels) in an
    ArrayDataset, with the transform in numpy: samples a process worker
    can make."""
    ds = mx.gluon.data.vision.CIFAR10(root=root, train=True)
    return mx.gluon.data.ArrayDataset(ds._data, ds._label).transform_first(
        NumpyTransform())


def resnet18(mx, ctx, hybridize=True):
    with mx.sym.NameManager():
        net = mx.gluon.model_zoo.vision.resnet18_v1(classes=10)
    net.initialize(mx.init.Xavier(), ctx=ctx)
    if hybridize:
        net.hybridize()
    return net


def trainer(mx, net):
    return mx.gluon.Trainer(net.collect_params(), "sgd", dict(OPT))


def iteration(mx, net, step, loss_fn, x, y):
    """One training iteration: the mean loss under record(), backward,
    Trainer.step(batch); returns the per-image losses."""
    with mx.autograd.record():
        loss = loss_fn(net(x), y)
    loss.backward()
    step.step(x.shape[0])
    return loss
