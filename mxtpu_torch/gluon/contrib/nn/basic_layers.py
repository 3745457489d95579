"""Experimental gluon layers of the PyTorch port (counterpart of
``mxtpu/gluon/contrib/nn/basic_layers.py``; MXNet's
``gluon/contrib/nn/basic_layers.py``)."""
from __future__ import annotations

from ... import nn
from ...block import Block, HybridBlock

__all__ = ["Concurrent", "HybridConcurrent", "Identity",
           "SparseEmbedding", "SyncBatchNorm", "PixelShuffle2D"]


class Concurrent(nn.Sequential):
    """Runs the children on the same input and concatenates their
    outputs along ``axis`` (the Inception-branch container)."""

    def __init__(self, axis=-1, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        self.axis = axis

    def forward(self, x):
        from .... import ndarray as nd

        return nd.concat(*[block(x) for block in self._children.values()],
                         dim=self.axis)


class HybridConcurrent(nn.HybridSequential):
    """Hybridizable Concurrent."""

    def __init__(self, axis=-1, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        self.axis = axis

    def hybrid_forward(self, F, x):
        return F.concat(*[block(x) for block in self._children.values()],
                        dim=self.axis)


class Identity(HybridBlock):
    """Pass-through block: the no-op branch of a Concurrent."""

    def hybrid_forward(self, F, x):
        return x


class SparseEmbedding(Block):
    """Embedding whose weight gradient is row-sparse, over
    ``_contrib_SparseEmbedding``: a step touches only the rows present
    in the batch.  The weight is dense."""

    def __init__(self, input_dim, output_dim, dtype="float32",
                 weight_initializer=None, **kwargs):
        super().__init__(**kwargs)
        self._kwargs = {"input_dim": input_dim, "output_dim": output_dim,
                        "dtype": dtype}
        with self.name_scope():
            self.weight = self.params.get(
                "weight", shape=(input_dim, output_dim),
                init=weight_initializer, dtype=dtype,
                grad_stype="row_sparse")

    def forward(self, x):
        from .... import ndarray as nd

        return nd.contrib.SparseEmbedding(x, self.weight.data(),
                                          **self._kwargs)

    def __repr__(self):
        return "SparseEmbedding({input_dim} -> {output_dim}, {dtype})" \
            .format(**self._kwargs)


class SyncBatchNorm(nn.BatchNorm):
    """Cross-device synchronized BatchNorm.  The port runs on one
    device, where it is ``nn.BatchNorm`` over axis 1, as in the JAX
    package; ``num_devices`` is kept and not used (several devices are
    ROADMAP A15b)."""

    def __init__(self, in_channels=0, num_devices=None, momentum=0.9,
                 epsilon=1e-5, center=True, scale=True,
                 use_global_stats=False, beta_initializer="zeros",
                 gamma_initializer="ones",
                 running_mean_initializer="zeros",
                 running_variance_initializer="ones", **kwargs):
        super().__init__(axis=1, momentum=momentum, epsilon=epsilon,
                         center=center, scale=scale,
                         use_global_stats=use_global_stats,
                         beta_initializer=beta_initializer,
                         gamma_initializer=gamma_initializer,
                         running_mean_initializer=running_mean_initializer,
                         running_variance_initializer=
                         running_variance_initializer,
                         in_channels=in_channels, **kwargs)
        self._num_devices = num_devices


class PixelShuffle2D(HybridBlock):
    """Sub-pixel upsampling: (N, C*r^2, H, W) -> (N, C, H*r, W*r)
    (ESPCN superresolution)."""

    def __init__(self, factor, **kwargs):
        super().__init__(**kwargs)
        self._factor = (factor, factor) if isinstance(factor, int) \
            else tuple(factor)

    def hybrid_forward(self, F, x):
        f1, f2 = self._factor
        x = F.Reshape(x, shape=(0, -4, -1, f1 * f2, 0, 0))
        x = F.Reshape(x, shape=(0, 0, -4, f1, f2, 0, 0))
        x = F.transpose(x, axes=(0, 1, 4, 2, 5, 3))
        # merge via two reshapes: interleave factor dims with spatial
        x = F.Reshape(x, shape=(0, 0, -3, -3))
        return x

    def __repr__(self):
        return "PixelShuffle2D(factor=%s)" % (self._factor,)
