"""The PyTorch port's `gluon.data` (`mxtpu_torch/gluon/data/`) against
the JAX package's (`mxtpu/gluon/data/`): the datasets and their
`filter`/`take`/`transform`/`transform_first`, the samplers (a seeded
shuffle index for index), `BatchSampler`'s three `last_batch` modes,
`IntervalSampler`, the four vision datasets from small files written in
their published formats and from the synthetic fallback (equal arrays),
the 11 transforms, and the DataLoader inline and with threads: equal
batches, `state()`/`set_state` re-entry, a worker's exception, the
device-prefetch error through a full queue, the input-wait gauge.
Process workers are in `test_torch_gluon_data_b.py`.

Values are equal unless a transform computes in float32 (within 1e-6
of the largest magnitude) or resizes uint8 (within one unit).  Every
thread a DataLoader starts is joined (with a timeout) and checked dead.
"""
import gzip
import os
import random
import struct
import threading
import time

import numpy as np
import pytest
import torch

import mxtpu as jmx
import mxtpu_torch as tmx
from mxtpu_torch import context as tcontext
from mxtpu_torch import telemetry as ttel
from mxtpu_torch.base import MXNetError

torch.set_num_threads(1)

LOADER_THREADS = ("mxtpu-dataloader", "mxtpu-device-prefetch")


@pytest.fixture(autouse=True)
def _cpu_default(monkeypatch):
    """The datasets and the default batchify make arrays on the default
    device, the card: here it is the CPU."""
    monkeypatch.setattr(tcontext, "default_ctx", lambda: torch.device("cpu"))
    yield
    for t in threading.enumerate():
        if t.name in LOADER_THREADS:
            t.join(timeout=10)
            assert not t.is_alive(), t.name


def _np(x):
    if isinstance(x, (list, tuple)):
        return [_np(v) for v in x]
    return x.asnumpy() if hasattr(x, "asnumpy") else np.asarray(x)


def _equal(a, b):
    a, b = _np(a), _np(b)
    if isinstance(a, list):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _equal(x, y)
    else:
        assert a.shape == b.shape and a.dtype == b.dtype, \
            (a.shape, b.shape, a.dtype, b.dtype)
        np.testing.assert_array_equal(a, b)


def _data(mx):
    return mx.gluon.data


# ---------------------------------------------------------------------------
# datasets and samplers
# ---------------------------------------------------------------------------

def _pairs(n=10):
    rng = np.random.RandomState(0)
    return [(rng.randn(3).astype(np.float32), float(i % 4)) for i in range(n)]


def test_dataset_methods_match_the_reference():
    def run(mx):
        d = _data(mx)
        ds = d.SimpleDataset(_pairs())
        return [
            [ds[i] for i in range(len(ds))],
            list(ds.filter(lambda s: s[1] > 1)._data),
            list(ds.take(4)._data),
            [ds.transform(lambda x, y: (x * 2, y + 1))[i] for i in range(3)],
            list(ds.transform(lambda x, y: (x - 1, y), lazy=False)._data),
            [ds.transform_first(lambda x: x[::-1])[i] for i in range(3)],
            len(ds.take(40))]

    t, j = run(tmx), run(jmx)
    assert t[-1] == j[-1] == 10
    for a, b in zip(t[:-1], j[:-1]):
        assert len(a) == len(b)
        for sa, sb in zip(a, b):
            np.testing.assert_array_equal(sa[0], sb[0])
            assert sa[1] == sb[1]


def test_array_dataset_matches_the_reference():
    x = np.arange(24, dtype=np.float32).reshape(6, 4)
    y = np.arange(6, dtype=np.float32)

    def run(mx):
        ds = _data(mx).ArrayDataset(mx.nd.array(x, ctx=mx.cpu()),
                                    mx.nd.array(y, ctx=mx.cpu()), list("abcdef"))
        one = _data(mx).ArrayDataset(x)
        return [ds[i] for i in range(6)], [one[i] for i in range(6)], \
            type(ds[0][1]).__name__

    t, j = run(tmx), run(jmx)
    assert t[2] == j[2] == "float32"  # a 1-D NDArray is read as numpy
    for a, b in zip(t[0], j[0]):
        _equal(a[0], b[0])
        assert a[1] == b[1] and a[2] == b[2]
    for a, b in zip(t[1], j[1]):
        _equal(a, b)


@pytest.mark.parametrize("seed", [None, 0, 1234567])
def test_random_sampler_stream_is_the_reference_index_for_index(seed):
    streams = []
    for mx in (tmx, jmx):
        np.random.seed(9)
        s = _data(mx).RandomSampler(37, seed=seed)
        streams.append([list(s) for _ in range(3)])
    assert streams[0] == streams[1]
    assert sorted(streams[0][0]) == list(range(37))
    assert streams[0][0] != streams[0][1]
    if seed is not None:
        s = tmx.gluon.data.RandomSampler(37, seed=seed)
        s.set_epoch(2)
        assert list(s) == streams[0][2]


@pytest.mark.parametrize("last_batch", ["keep", "discard", "rollover"])
def test_batch_sampler_modes_match_the_reference(last_batch):
    out = []
    for mx in (tmx, jmx):
        d = _data(mx)
        bs = d.BatchSampler(d.SequentialSampler(10), 4, last_batch)
        out.append([list(bs), len(bs), list(bs), len(bs)])
    assert out[0] == out[1]
    with pytest.raises(MXNetError):
        tmx.gluon.data.BatchSampler(tmx.gluon.data.SequentialSampler(3), 2,
                                    "bad")


@pytest.mark.parametrize("length,interval,rollover", [
    (6, 2, True), (7, 3, True), (7, 3, False), (5, 5, True)])
def test_interval_sampler_matches_the_reference(length, interval, rollover):
    t = tmx.gluon.contrib.data.IntervalSampler(length, interval, rollover)
    j = jmx.gluon.contrib.data.IntervalSampler(length, interval, rollover)
    assert list(t) == list(j) and len(t) == len(j)
    with pytest.raises(ValueError):
        tmx.gluon.contrib.data.IntervalSampler(3, 4)


# ---------------------------------------------------------------------------
# the vision datasets: published formats and the synthetic fallback
# ---------------------------------------------------------------------------

def _write_idx(root, prefix, n, rows=28, cols=28, gz=False, seed=0):
    rng = np.random.RandomState(seed)
    imgs = rng.randint(0, 256, (n, rows, cols)).astype(np.uint8)
    labels = rng.randint(0, 10, n).astype(np.uint8)
    opener, ext = (gzip.open, ".gz") if gz else (open, "")
    with opener(os.path.join(root, prefix + "-images-idx3-ubyte" + ext),
                "wb") as f:
        f.write(struct.pack(">IIII", 2051, n, rows, cols) + imgs.tobytes())
    with opener(os.path.join(root, prefix + "-labels-idx1-ubyte" + ext),
                "wb") as f:
        f.write(struct.pack(">II", 2049, n) + labels.tobytes())


def write_cifar10(root, per_file=7, seed=0):
    """CIFAR-10's binary batches: rows of a label byte and 3,072 bytes of
    channel-major 32x32 pixels."""
    base = os.path.join(root, "cifar-10-batches-bin")
    os.makedirs(base, exist_ok=True)
    rng = np.random.RandomState(seed)
    names = ["data_batch_%d.bin" % i for i in range(1, 6)] + ["test_batch.bin"]
    for name in names:
        rows = np.concatenate(
            [rng.randint(0, 10, (per_file, 1)),
             rng.randint(0, 256, (per_file, 3072))], axis=1).astype(np.uint8)
        with open(os.path.join(base, name), "wb") as f:
            f.write(rows.tobytes())


def _write_cifar100(root, n=9, seed=0):
    base = os.path.join(root, "cifar-100-binary")
    os.makedirs(base, exist_ok=True)
    rng = np.random.RandomState(seed)
    for name in ("train.bin", "test.bin"):
        rows = np.concatenate([rng.randint(0, 20, (n, 1)),
                               rng.randint(0, 100, (n, 1)),
                               rng.randint(0, 256, (n, 3072))],
                              axis=1).astype(np.uint8)
        with open(os.path.join(base, name), "wb") as f:
            f.write(rows.tobytes())


def _same_dataset(t, j, n=None):
    assert len(t) == len(j)
    np.testing.assert_array_equal(t._data, j._data)
    np.testing.assert_array_equal(t._label, j._label)
    assert t._data.dtype == j._data.dtype and \
        t._label.dtype == j._label.dtype
    for i in range(min(len(t), n or 3)):
        (tx, ty), (jx, jy) = t[i], j[i]
        _equal(tx, jx)
        assert ty == jy


@pytest.mark.parametrize("cls", ["MNIST", "FashionMNIST"])
@pytest.mark.parametrize("gz", [False, True])
def test_mnist_files_read_as_the_reference(tmp_path, cls, gz):
    _write_idx(str(tmp_path), "train", 12, gz=gz)
    _write_idx(str(tmp_path), "t10k", 5, gz=gz, seed=1)
    for train in (True, False):
        t = getattr(tmx.gluon.data.vision, cls)(root=str(tmp_path),
                                                train=train)
        j = getattr(jmx.gluon.data.vision, cls)(root=str(tmp_path),
                                                train=train)
        assert t._data.shape == (12 if train else 5, 28, 28, 1)
        _same_dataset(t, j)


def test_cifar_files_read_as_the_reference(tmp_path):
    write_cifar10(str(tmp_path))
    _write_cifar100(str(tmp_path))
    for train in (True, False):
        t = tmx.gluon.data.vision.CIFAR10(root=str(tmp_path), train=train)
        j = jmx.gluon.data.vision.CIFAR10(root=str(tmp_path), train=train)
        assert len(t) == (35 if train else 7)
        _same_dataset(t, j)
        for fine in (False, True):
            t = tmx.gluon.data.vision.CIFAR100(root=str(tmp_path),
                                               fine_label=fine, train=train)
            j = jmx.gluon.data.vision.CIFAR100(root=str(tmp_path),
                                               fine_label=fine, train=train)
            _same_dataset(t, j)


@pytest.mark.parametrize("cls", ["MNIST", "FashionMNIST", "CIFAR10",
                                 "CIFAR100"])
def test_synthetic_fallback_is_the_reference_bit_for_bit(tmp_path, cls):
    root = str(tmp_path / "absent")
    for train in (True, False):
        t = getattr(tmx.gluon.data.vision, cls)(root=root, train=train)
        j = getattr(jmx.gluon.data.vision, cls)(root=root, train=train)
        _same_dataset(t, j)
    ds = tmx.gluon.data.vision.CIFAR10(
        root=root, transform=lambda x, y: (x.astype("float32") / 2, y + 1))
    x, y = ds[4]
    np.testing.assert_array_equal(x.asnumpy(), ds._data[4] / 2.0)
    assert y == ds._label[4] + 1


# ---------------------------------------------------------------------------
# transforms
# ---------------------------------------------------------------------------

def _transforms(mx):
    T = mx.gluon.data.vision.transforms
    return {
        "compose": T.Compose([T.ToTensor(), T.Normalize(
            (0.4914, 0.4822, 0.4465), (0.2023, 0.1994, 0.2010))]),
        "cast": T.Cast("float16"),
        "to_tensor": T.ToTensor(),
        "normalize": T.Normalize(0.5, 2.0),
        "resize": T.Resize((7, 5)),
        "resize_keep_ratio": T.Resize(6, keep_ratio=True),
        "resize_int_nearest": T.Resize(4, interpolation=0),
        "center_crop": T.CenterCrop((5, 3)),
        "center_crop_larger": T.CenterCrop(12),
        "random_resized_crop": T.RandomResizedCrop(6),
        "random_brightness": T.RandomBrightness(0.3),
        "random_contrast": T.RandomContrast(0.4),
    }


def _image(kind, seed=0):
    rng = np.random.RandomState(seed)
    if kind == "normalize":
        return rng.rand(3, 8, 10).astype(np.float32)
    return rng.randint(0, 256, (8, 10, 3)).astype(np.uint8)


@pytest.mark.parametrize("name", sorted(_transforms(tmx)))
def test_transform_matches_the_reference(name):
    x = _image(name)
    out = []
    for mx in (tmx, jmx):
        random.seed(3)  # the crops, brightness and contrast draw here
        out.append(_transforms(mx)[name](mx.nd.array(x, ctx=mx.cpu(),
                                                     dtype=x.dtype)).asnumpy())
    t, j = out
    assert t.shape == j.shape and t.dtype == j.dtype, (t.shape, j.shape)
    diff = np.abs(t.astype(np.float64) - j.astype(np.float64))
    bound = 1 if t.dtype == np.uint8 else \
        1e-6 * max(1.0, float(np.abs(j.astype(np.float64)).max()))
    assert diff.max() <= bound, (name, diff.max())


@pytest.mark.parametrize("name", ["RandomFlipLeftRight",
                                  "RandomFlipTopBottom"])
def test_random_flip_transforms_flip_half_the_time(name):
    x = np.arange(4 * 5 * 3, dtype=np.float32).reshape(4, 5, 3)
    axis = 1 if name.endswith("LeftRight") else 0
    for mx in (tmx, jmx):
        mx.random.seed(1)
        flip = getattr(mx.gluon.data.vision.transforms, name)()
        a = mx.nd.array(x, ctx=mx.cpu())
        ys = [flip(a).asnumpy() for _ in range(200)]
        n = sum(np.array_equal(y, np.flip(x, axis)) for y in ys)
        assert all(np.array_equal(y, x) or np.array_equal(y, np.flip(x, axis))
                   for y in ys)
        assert abs(n - 100) < 5 * np.sqrt(50), (mx.__name__, n)


# ---------------------------------------------------------------------------
# the DataLoader: inline and threads
# ---------------------------------------------------------------------------

class _Numbered(object):
    """Samples whose values name them: (x, y) with x filled with i."""

    def __init__(self, n=23):
        self.n = n

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        return np.full((2, 3), float(i), np.float32), float(i % 5)


def _batches(mx, **kw):
    return [_np(b) for b in mx.gluon.data.DataLoader(_Numbered(), **kw)]


@pytest.mark.parametrize("kw", [
    dict(batch_size=5),
    dict(batch_size=5, last_batch="discard"),
    dict(batch_size=5, last_batch="rollover", shuffle=True, seed=3),
    dict(batch_size=4, shuffle=True, seed=11, num_workers=3),
    dict(batch_size=6, num_workers=2, prefetch=1),
])
def test_loader_batches_match_the_reference(kw):
    t, j = _batches(tmx, **kw), _batches(jmx, **kw)
    _equal(t, j)
    assert len(t) == len(tmx.gluon.data.DataLoader(_Numbered(), **kw)) \
        or kw.get("last_batch") == "rollover"


def test_loader_of_ndarray_samples_stacks_them():
    ds = tmx.gluon.data.ArrayDataset(
        tmx.nd.array(np.arange(12, dtype=np.float32).reshape(6, 2),
                     ctx=tmx.cpu()))
    jds = jmx.gluon.data.ArrayDataset(
        jmx.nd.array(np.arange(12, dtype=np.float32).reshape(6, 2)))
    for workers in (0, 2):
        t = _batches_of(tmx, ds, workers)
        _equal(t, _batches_of(jmx, jds, workers))


def _batches_of(mx, ds, workers):
    return [_np(b) for b in mx.gluon.data.DataLoader(ds, batch_size=4,
                                                     num_workers=workers)]


@pytest.mark.parametrize("workers", [0, 3])
def test_state_and_set_state_re_enter_the_stream(workers):
    kw = dict(batch_size=3, shuffle=True, seed=7, num_workers=workers)
    whole = tmx.gluon.data.DataLoader(_Numbered(), **kw)
    first = [_np(b) for b in whole]
    second = []
    for i, b in enumerate(whole):  # epoch 1
        second.append(_np(b))
        if i == 4:
            state = whole.state()
    assert state == {"epoch": 1, "batch": 5, "seed": 7}
    fresh = tmx.gluon.data.DataLoader(_Numbered(), **kw)
    fresh.set_state(state)
    resumed = [_np(b) for b in fresh]
    _equal(resumed, second[5:])
    assert not all(np.array_equal(a[0], b[0])
                   for a, b in zip(first, second))
    jl = jmx.gluon.data.DataLoader(_Numbered(), **kw)
    jl.set_state(state)
    _equal(resumed, [_np(b) for b in jl])
    with pytest.raises(MXNetError, match="seed mismatch"):
        tmx.gluon.data.DataLoader(_Numbered(), batch_size=3, shuffle=True,
                                  seed=8).set_state(state)


class _Exploding(object):
    """Batches of 4 are fine up to index 7; any index past it raises."""

    def __len__(self):
        return 12

    def __getitem__(self, i):
        if i >= 8:
            raise RuntimeError("boom at %d" % i)
        return np.full((2,), float(i), np.float32)


@pytest.mark.parametrize("workers", [0, 2])
def test_a_worker_exception_surfaces_with_its_message(workers):
    got = []
    with pytest.raises((RuntimeError, MXNetError)) as info:
        for b in tmx.gluon.data.DataLoader(_Exploding(), batch_size=4,
                                           num_workers=workers):
            got.append(_np(b)[0, 0])
    err = info.value
    text = str(err) + repr(getattr(err, "__cause__", ""))
    assert "boom at 8" in text, text
    assert got == [0.0, 4.0]


def test_device_prefetch_error_sentinel_survives_a_full_queue(monkeypatch):
    """`tests/test_gluon_data.py`'s regression on the port: the error is
    raised while the depth-1 queue is full and must still reach the
    consumer, which waits 1.5 s before it drains."""
    monkeypatch.setenv("MXTPU_PREFETCH_DEVICE", "1")
    ld = tmx.gluon.data.DataLoader(_Exploding(), batch_size=4)
    outcome = {}

    def consume():
        it = iter(ld)
        try:
            first = next(it)
            time.sleep(1.5)
            second = next(it)
            next(it)
            outcome["result"] = "no error raised"
        except RuntimeError:
            outcome["result"] = "raised"
            outcome["batches"] = (first.asnumpy()[0, 0],
                                  second.asnumpy()[0, 0])

    t = threading.Thread(target=consume, daemon=True)
    t.start()
    t.join(timeout=20)
    assert not t.is_alive(), "the consumer hung on a dropped error"
    assert outcome.get("result") == "raised"
    assert outcome["batches"] == (0.0, 4.0)


def test_device_prefetch_gives_the_same_batches(monkeypatch):
    monkeypatch.setenv("MXTPU_PREFETCH_DEVICE", "2")
    kw = dict(batch_size=4, shuffle=True, seed=5, num_workers=2)
    _equal(_batches(tmx, **kw), _batches(jmx, **kw))


def test_input_wait_counts_one_wait_a_batch():
    ttel.clear()
    n = len(_batches(tmx, batch_size=5, num_workers=2))
    m = ttel.metrics()
    assert m["input_waits"] == n == 5
    assert m["input_wait_sum_s"] > 0
    assert abs(m["input_wait_avg_s"] * n - m["input_wait_sum_s"]) < 1e-9
    with ttel.input_wait():
        with ttel.input_wait():  # nested: counted once
            pass
    assert ttel.metrics()["input_waits"] == n + 1


def _defined(module):
    """The public names a module defines or holds from its own package:
    classes, functions and submodules, not what it imports for its use."""
    out = set()
    for n in dir(module):
        v = getattr(module, n)
        home = getattr(v, "__module__", None) or getattr(v, "__name__", "")
        if not n.startswith("_") and isinstance(home, str) and \
                home.startswith(module.__name__):
            out.add(n)
    return out


@pytest.mark.parametrize("path", [
    "gluon.data", "gluon.data.vision", "gluon.data.vision.transforms",
    "gluon.data.vision.datasets", "gluon.data.dataset",
    "gluon.data.sampler", "gluon.data.dataloader", "gluon.contrib",
    "gluon.contrib.nn", "gluon.contrib.rnn", "gluon.contrib.data",
    "control_flow"])
def test_the_port_lacks_no_public_name_but_record_files(path):
    """`RecordFileDataset` reads through recordio, which waits for
    ROADMAP A16; no other public name of the reference's is missing."""
    t, j = tmx, jmx
    for part in path.split("."):
        t, j = getattr(t, part), getattr(j, part)
    assert _defined(j) - set(dir(t)) <= {"RecordFileDataset"}
    for name in ("foreach", "while_loop", "cond"):
        assert getattr(tmx.nd.contrib, name) is getattr(tmx.sym.contrib,
                                                        name)
