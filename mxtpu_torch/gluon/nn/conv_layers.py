"""Convolution and pooling layers of the PyTorch port (counterpart of
``mxtpu/gluon/nn/conv_layers.py``): Conv1D/2D/3D, the max and average
pools and the global pools, channels first.  The transposed
convolutions wait for ``Deconvolution`` and ReflectionPad2D for ``Pad``
(ROADMAP A14).
"""
from __future__ import annotations

from ..block import HybridBlock
from .basic_layers import Activation

__all__ = ["Conv1D", "Conv2D", "Conv3D", "MaxPool1D", "MaxPool2D",
           "MaxPool3D", "AvgPool1D", "AvgPool2D", "AvgPool3D",
           "GlobalMaxPool1D", "GlobalMaxPool2D", "GlobalMaxPool3D",
           "GlobalAvgPool1D", "GlobalAvgPool2D", "GlobalAvgPool3D"]


def _to_tuple(v, n):
    return (v,) * n if isinstance(v, int) else tuple(v)


class _Conv(HybridBlock):
    def __init__(self, channels, kernel_size, strides, padding, dilation,
                 groups, layout, in_channels=0, activation=None,
                 use_bias=True, weight_initializer=None,
                 bias_initializer="zeros", **kwargs):
        super().__init__(**kwargs)
        with self.name_scope():
            self._channels = channels
            self._in_channels = in_channels
            ns = len(kernel_size)
            self._kwargs = {
                "kernel": kernel_size, "stride": strides, "dilate": dilation,
                "pad": padding, "num_filter": channels, "num_group": groups,
                "no_bias": not use_bias, "layout": layout,
            }
            wshape = (channels, in_channels // groups) + tuple(kernel_size) \
                if in_channels else (0,) * (ns + 2)
            self.weight = self.params.get(
                "weight", shape=wshape, init=weight_initializer,
                allow_deferred_init=True)
            self.bias = self.params.get(
                "bias", shape=(channels,), init=bias_initializer,
                allow_deferred_init=True) if use_bias else None
            self.act = Activation(activation, prefix=activation + "_") \
                if activation is not None else None

    def hybrid_forward(self, F, x, weight, bias=None):
        if bias is None:
            out = F.Convolution(x, weight, **self._kwargs)
        else:
            out = F.Convolution(x, weight, bias,
                                **dict(self._kwargs, no_bias=False))
        return self.act(out) if self.act is not None else out


def _conv_class(ns, layout, doc):
    def __init__(self, channels, kernel_size, strides=1, padding=0,
                 dilation=1, groups=1, layout=layout, activation=None,
                 use_bias=True, weight_initializer=None,
                 bias_initializer="zeros", in_channels=0, **kwargs):
        _Conv.__init__(self, channels, _to_tuple(kernel_size, ns),
                       _to_tuple(strides, ns), _to_tuple(padding, ns),
                       _to_tuple(dilation, ns), groups, layout, in_channels,
                       activation, use_bias, weight_initializer,
                       bias_initializer, **kwargs)

    return type("Conv%dD" % ns, (_Conv,), {"__init__": __init__,
                                           "__doc__": doc})


Conv1D = _conv_class(1, "NCW", "1-D convolution over (N, C, W).")
Conv2D = _conv_class(2, "NCHW", "2-D convolution over (N, C, H, W).")
Conv3D = _conv_class(3, "NCDHW", "3-D convolution over (N, C, D, H, W).")


class _Pooling(HybridBlock):
    def __init__(self, pool_size, strides, padding, ceil_mode, global_pool,
                 pool_type, layout, count_include_pad=None, **kwargs):
        super().__init__(**kwargs)
        self._kwargs = {
            "kernel": pool_size, "stride": pool_size if strides is None
            else strides, "pad": padding, "global_pool": global_pool,
            "pool_type": pool_type,
            "pooling_convention": "full" if ceil_mode else "valid",
        }
        if count_include_pad is not None:
            self._kwargs["count_include_pad"] = count_include_pad

    def _alias(self):
        return "pool"

    def hybrid_forward(self, F, x):
        return F.Pooling(x, **self._kwargs)


def _pool_class(ns, pool_type, layout):
    def __init__(self, pool_size=2, strides=None, padding=0, layout=layout,
                 ceil_mode=False, count_include_pad=True, **kwargs):
        _Pooling.__init__(
            self, _to_tuple(pool_size, ns),
            None if strides is None else _to_tuple(strides, ns),
            _to_tuple(padding, ns), ceil_mode, False, pool_type, layout,
            count_include_pad if pool_type == "avg" else None, **kwargs)

    name = "%sPool%dD" % (pool_type.capitalize(), ns)
    return type(name, (_Pooling,), {
        "__init__": __init__,
        "__doc__": "%s pooling over %d spatial dims." % (pool_type, ns)})


def _global_pool_class(ns, pool_type, layout):
    def __init__(self, layout=layout, **kwargs):
        _Pooling.__init__(self, (1,) * ns, None, (0,) * ns, False, True,
                          pool_type, layout, **kwargs)

    name = "Global%sPool%dD" % (pool_type.capitalize(), ns)
    return type(name, (_Pooling,), {
        "__init__": __init__,
        "__doc__": "Global %s pooling over %d spatial dims."
                   % (pool_type, ns)})


_LAYOUTS = {1: "NCW", 2: "NCHW", 3: "NCDHW"}
MaxPool1D, MaxPool2D, MaxPool3D = (_pool_class(n, "max", _LAYOUTS[n])
                                   for n in (1, 2, 3))
AvgPool1D, AvgPool2D, AvgPool3D = (_pool_class(n, "avg", _LAYOUTS[n])
                                   for n in (1, 2, 3))
GlobalMaxPool1D, GlobalMaxPool2D, GlobalMaxPool3D = (
    _global_pool_class(n, "max", _LAYOUTS[n]) for n in (1, 2, 3))
GlobalAvgPool1D, GlobalAvgPool2D, GlobalAvgPool3D = (
    _global_pool_class(n, "avg", _LAYOUTS[n]) for n in (1, 2, 3))
