"""``mxtpu_torch.gluon.data.vision``: the vision datasets and transforms
(counterpart of ``mxtpu/gluon/data/vision/``)."""
from .datasets import MNIST, FashionMNIST, CIFAR10, CIFAR100
from . import transforms
