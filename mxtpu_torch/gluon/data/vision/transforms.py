"""Vision transforms of the PyTorch port (counterpart of
``mxtpu/gluon/data/vision/transforms.py``; MXNet's
``gluon/data/vision/transforms.py``): Compose, Cast, ToTensor,
Normalize, Resize, CenterCrop, RandomResizedCrop, the random flips,
RandomBrightness and RandomContrast, over the image ops
(``mxtpu_torch/ops/image.py``).  The crops and the brightness and
contrast draw from Python's ``random``, the flips from the device's
generator."""
from __future__ import annotations

import random as _pyrandom

import numpy as np

from ...block import Block, HybridBlock
from ...nn.basic_layers import HybridSequential

__all__ = ["Compose", "Cast", "ToTensor", "Normalize", "Resize",
           "CenterCrop", "RandomResizedCrop", "RandomFlipLeftRight",
           "RandomFlipTopBottom", "RandomBrightness", "RandomContrast"]


class Compose(HybridSequential):
    def __init__(self, transforms):
        super().__init__()
        with self.name_scope():
            for t in transforms:
                self.add(t)


class Cast(HybridBlock):
    def __init__(self, dtype="float32"):
        super().__init__()
        self._dtype = dtype

    def hybrid_forward(self, F, x):
        return F.Cast(x, dtype=self._dtype)


class ToTensor(HybridBlock):
    def __init__(self):
        super().__init__()

    def hybrid_forward(self, F, x):
        return F._image_to_tensor(x)


class Normalize(HybridBlock):
    def __init__(self, mean=0.0, std=1.0):
        super().__init__()
        self._mean = mean if isinstance(mean, (list, tuple)) else (mean,)
        self._std = std if isinstance(std, (list, tuple)) else (std,)

    def hybrid_forward(self, F, x):
        return F._image_normalize(x, mean=tuple(self._mean),
                                  std=tuple(self._std))


class Resize(Block):
    def __init__(self, size, keep_ratio=False, interpolation=1):
        super().__init__()
        self._size = size
        self._keep = keep_ratio
        self._interp = interpolation

    def forward(self, x):
        from .... import ndarray as _nd

        if isinstance(self._size, tuple):
            size = self._size
        elif self._keep:
            # short-side resize preserving aspect ratio
            hh, ww = x.shape[-3], x.shape[-2]
            if ww < hh:
                size = (self._size, int(round(hh * self._size / ww)))
            else:
                size = (int(round(ww * self._size / hh)), self._size)
        else:
            size = (self._size, self._size)
        return _nd._image_resize(x, size=size, interp=self._interp)


class CenterCrop(Block):
    def __init__(self, size, interpolation=1):
        super().__init__()
        self._size = size if isinstance(size, tuple) else (size, size)

    def forward(self, x):
        from .... import ndarray as _nd

        w, h = self._size
        hh, ww = x.shape[-3], x.shape[-2]
        y0 = max((hh - h) // 2, 0)
        x0 = max((ww - w) // 2, 0)
        return _nd._image_crop(x, x=x0, y=y0, width=min(w, ww),
                               height=min(h, hh))


class RandomResizedCrop(Block):
    def __init__(self, size, scale=(0.08, 1.0), ratio=(3 / 4, 4 / 3),
                 interpolation=1):
        super().__init__()
        self._size = size if isinstance(size, tuple) else (size, size)
        self._scale = scale
        self._ratio = ratio
        self._interp = interpolation

    def forward(self, x):
        from .... import ndarray as _nd

        hh, ww = x.shape[-3], x.shape[-2]
        area = hh * ww
        for _ in range(10):
            target_area = _pyrandom.uniform(*self._scale) * area
            ar = _pyrandom.uniform(*self._ratio)
            w = int(round(np.sqrt(target_area * ar)))
            h = int(round(np.sqrt(target_area / ar)))
            if w <= ww and h <= hh:
                x0 = _pyrandom.randint(0, ww - w)
                y0 = _pyrandom.randint(0, hh - h)
                crop = _nd._image_crop(x, x=x0, y=y0, width=w, height=h)
                return _nd._image_resize(crop, size=self._size,
                                         interp=self._interp)
        return _nd._image_resize(x, size=self._size, interp=self._interp)


class RandomFlipLeftRight(HybridBlock):
    def __init__(self):
        super().__init__()

    def hybrid_forward(self, F, x):
        return F._image_random_flip_left_right(x)


class RandomFlipTopBottom(HybridBlock):
    def __init__(self):
        super().__init__()

    def hybrid_forward(self, F, x):
        return F._image_random_flip_top_bottom(x)


class RandomBrightness(Block):
    def __init__(self, brightness):
        super().__init__()
        self._brightness = brightness

    def forward(self, x):
        alpha = 1.0 + _pyrandom.uniform(-self._brightness, self._brightness)
        return x * alpha


class RandomContrast(Block):
    def __init__(self, contrast):
        super().__init__()
        self._contrast = contrast

    def forward(self, x):
        alpha = 1.0 + _pyrandom.uniform(-self._contrast, self._contrast)
        gray = x.astype("float32").mean()
        return x.astype("float32") * alpha + gray * (1 - alpha)
