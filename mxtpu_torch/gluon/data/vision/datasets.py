"""Vision datasets of the PyTorch port (counterpart of
``mxtpu/gluon/data/vision/datasets.py``; MXNet's
``gluon/data/vision/datasets.py``).

MNIST, FashionMNIST, CIFAR10 and CIFAR100 read their published file
formats (idx-ubyte, optionally gzipped; the CIFAR binary batches) from a
local root.  Nothing is downloaded: when the files are absent the
datasets fall back to the JAX package's deterministic synthetic set of
the right shapes, dtypes and classes (numpy seeds 42-47), bit for bit.
A sample's image is an NDArray on the default device (``from_numpy``),
its label an int32.
"""
from __future__ import annotations

import gzip
import os
import struct

import numpy as np

from ....ndarray.ndarray import from_numpy
from ..dataset import Dataset

__all__ = ["MNIST", "FashionMNIST", "CIFAR10", "CIFAR100"]


def _synthetic_images(n, shape, num_classes, seed):
    rng = np.random.RandomState(seed)
    # class-dependent means so models can actually learn from it
    labels = rng.randint(0, num_classes, n).astype(np.int32)
    base = rng.rand(num_classes, *shape).astype(np.float32)
    imgs = (base[labels] * 128 + rng.rand(n, *shape) * 64).astype(np.uint8)
    return imgs, labels


class _DownloadedDataset(Dataset):
    def __init__(self, root, transform):
        self._transform = transform
        self._data = None
        self._label = None
        self._root = os.path.expanduser(root)
        self._get_data()

    def __getitem__(self, idx):
        x = from_numpy(self._data[idx])
        y = self._label[idx]
        if self._transform is not None:
            return self._transform(x, y)
        return x, y

    def __len__(self):
        return len(self._label)

    def _get_data(self):
        raise NotImplementedError


class MNIST(_DownloadedDataset):
    """MNIST (reference datasets.MNIST). Reads idx-ubyte(.gz) files from
    `root` when present; synthetic fallback otherwise."""

    _train_files = ("train-images-idx3-ubyte", "train-labels-idx1-ubyte")
    _test_files = ("t10k-images-idx3-ubyte", "t10k-labels-idx1-ubyte")
    _shape = (28, 28, 1)
    _classes = 10
    _synthetic_n = 2048

    def __init__(self, root=os.path.join("~", ".mxnet", "datasets", "mnist"),
                 train=True, transform=None):
        self._train = train
        super().__init__(root, transform)

    def _read_idx(self, img_path, lbl_path):
        opener = gzip.open if img_path.endswith(".gz") else open
        with opener(lbl_path, "rb") as f:
            magic, num = struct.unpack(">II", f.read(8))
            label = np.frombuffer(f.read(), dtype=np.uint8).astype(np.int32)
        with opener(img_path, "rb") as f:
            magic, num, rows, cols = struct.unpack(">IIII", f.read(16))
            data = np.frombuffer(f.read(), dtype=np.uint8)
            data = data.reshape(num, rows, cols, 1)
        return data, label

    def _get_data(self):
        files = self._train_files if self._train else self._test_files
        for ext in ("", ".gz"):
            img = os.path.join(self._root, files[0] + ext)
            lbl = os.path.join(self._root, files[1] + ext)
            if os.path.exists(img) and os.path.exists(lbl):
                self._data, self._label = self._read_idx(img, lbl)
                return
        n = self._synthetic_n if self._train else self._synthetic_n // 4
        self._data, self._label = _synthetic_images(
            n, self._shape, self._classes, seed=42 if self._train else 43)


class FashionMNIST(MNIST):
    def __init__(self, root=os.path.join("~", ".mxnet", "datasets",
                                         "fashion-mnist"), train=True,
                 transform=None):
        super().__init__(root, train, transform)


class CIFAR10(_DownloadedDataset):
    """CIFAR10 (reference datasets.CIFAR10). Reads the binary batches from
    `root` when present; synthetic fallback otherwise."""

    _shape = (32, 32, 3)
    _classes = 10
    _synthetic_n = 2048

    def __init__(self, root=os.path.join("~", ".mxnet", "datasets",
                                         "cifar10"), train=True,
                 transform=None):
        self._train = train
        super().__init__(root, transform)

    def _read_batch(self, filename):
        with open(filename, "rb") as f:
            raw = np.frombuffer(f.read(), dtype=np.uint8)
        row = 1 + self._shape[0] * self._shape[1] * self._shape[2]
        data = raw.reshape(-1, row)
        label = data[:, 0].astype(np.int32)
        imgs = data[:, 1:].reshape(-1, 3, 32, 32).transpose(0, 2, 3, 1)
        return imgs, label

    def _get_data(self):
        base = os.path.join(self._root, "cifar-10-batches-bin")
        if self._train:
            names = ["data_batch_%d.bin" % i for i in range(1, 6)]
        else:
            names = ["test_batch.bin"]
        paths = [os.path.join(base, n) for n in names]
        if all(os.path.exists(p) for p in paths):
            parts = [self._read_batch(p) for p in paths]
            self._data = np.concatenate([p[0] for p in parts])
            self._label = np.concatenate([p[1] for p in parts])
            return
        n = self._synthetic_n if self._train else self._synthetic_n // 4
        self._data, self._label = _synthetic_images(
            n, self._shape, self._classes, seed=44 if self._train else 45)


class CIFAR100(CIFAR10):
    _classes = 100

    def __init__(self, root=os.path.join("~", ".mxnet", "datasets",
                                         "cifar100"), fine_label=False,
                 train=True, transform=None):
        self._fine = fine_label
        super().__init__(root, train, transform)

    def _get_data(self):
        base = os.path.join(self._root, "cifar-100-binary")
        name = "train.bin" if self._train else "test.bin"
        path = os.path.join(base, name)
        if os.path.exists(path):
            with open(path, "rb") as f:
                raw = np.frombuffer(f.read(), dtype=np.uint8)
            row = 2 + 32 * 32 * 3
            data = raw.reshape(-1, row)
            self._label = data[:, 1 if self._fine else 0].astype(np.int32)
            self._data = data[:, 2:].reshape(-1, 3, 32, 32) \
                .transpose(0, 2, 3, 1)
            return
        n = self._synthetic_n if self._train else self._synthetic_n // 4
        self._data, self._label = _synthetic_images(
            n, self._shape, self._classes, seed=46 if self._train else 47)
