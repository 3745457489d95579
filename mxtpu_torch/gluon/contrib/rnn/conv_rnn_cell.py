"""Convolutional recurrent cells of the PyTorch port (counterpart of
``mxtpu/gluon/contrib/rnn/conv_rnn_cell.py``; MXNet's
``gluon/contrib/rnn/conv_rnn_cell.py``).

Gates are a convolution over the input plus a convolution over the
hidden state (h2h kernels must be odd, so that SAME padding keeps the
spatial shape).  Layouts are channels-first (``NCW``/``NCHW``/
``NCDHW``) only, as in the JAX package, which has no ``conv_layout``.
Parameter names are the JAX package's, so weights carry across by name.
"""
from __future__ import annotations

from ...rnn.rnn_cell import HybridRecurrentCell

__all__ = ["Conv1DRNNCell", "Conv2DRNNCell", "Conv3DRNNCell",
           "Conv1DLSTMCell", "Conv2DLSTMCell", "Conv3DLSTMCell",
           "Conv1DGRUCell", "Conv2DGRUCell", "Conv3DGRUCell"]


def _tup(v, n):
    return (v,) * n if isinstance(v, int) else tuple(v)


class _ConvCellBase(HybridRecurrentCell):
    """Shared machinery: parameter shapes, SAME h2h padding, the two
    gate convolutions."""

    _num_gates = 1

    def __init__(self, input_shape, hidden_channels, i2h_kernel,
                 h2h_kernel, i2h_pad=0, i2h_dilate=1, h2h_dilate=1,
                 i2h_weight_initializer=None, h2h_weight_initializer=None,
                 i2h_bias_initializer="zeros", h2h_bias_initializer="zeros",
                 dims=2, activation="tanh", prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        self._dims = dims
        self._input_shape = tuple(input_shape)   # (C, *spatial)
        self._hidden_channels = hidden_channels
        self._activation = activation
        self._i2h_kernel = _tup(i2h_kernel, dims)
        self._h2h_kernel = _tup(h2h_kernel, dims)
        if any(k % 2 == 0 for k in self._h2h_kernel):
            raise ValueError("h2h_kernel must be odd (SAME padding "
                             "keeps the state shape); got %s"
                             % (self._h2h_kernel,))
        self._i2h_pad = _tup(i2h_pad, dims)
        self._i2h_dilate = _tup(i2h_dilate, dims)
        self._h2h_dilate = _tup(h2h_dilate, dims)
        self._h2h_pad = tuple(d * (k - 1) // 2 for d, k in
                              zip(self._h2h_dilate, self._h2h_kernel))
        in_c = self._input_shape[0]
        spatial = self._input_shape[1:]
        self._state_spatial = tuple(
            (s + 2 * p - d * (k - 1) - 1) + 1
            for s, p, d, k in zip(spatial, self._i2h_pad,
                                  self._i2h_dilate, self._i2h_kernel))
        total = hidden_channels * self._num_gates
        with self.name_scope():
            self.i2h_weight = self.params.get(
                "i2h_weight", shape=(total, in_c) + self._i2h_kernel,
                init=i2h_weight_initializer, allow_deferred_init=True)
            self.h2h_weight = self.params.get(
                "h2h_weight",
                shape=(total, hidden_channels) + self._h2h_kernel,
                init=h2h_weight_initializer, allow_deferred_init=True)
            self.i2h_bias = self.params.get(
                "i2h_bias", shape=(total,), init=i2h_bias_initializer,
                allow_deferred_init=True)
            self.h2h_bias = self.params.get(
                "h2h_bias", shape=(total,), init=h2h_bias_initializer,
                allow_deferred_init=True)

    def state_info(self, batch_size=0):
        shape = (batch_size, self._hidden_channels) + self._state_spatial
        return [{"shape": shape, "__layout__": "NC" + "DHW"[-self._dims:]}
                for _ in range(self._num_states)]

    _num_states = 1

    def _conv_gates(self, F, inputs, prev_h, i2h_weight, h2h_weight,
                    i2h_bias, h2h_bias):
        total = self._hidden_channels * self._num_gates
        i2h = F.Convolution(inputs, i2h_weight, i2h_bias,
                            kernel=self._i2h_kernel,
                            pad=self._i2h_pad,
                            dilate=self._i2h_dilate,
                            num_filter=total)
        h2h = F.Convolution(prev_h, h2h_weight, h2h_bias,
                            kernel=self._h2h_kernel,
                            pad=self._h2h_pad,
                            dilate=self._h2h_dilate,
                            num_filter=total)
        return i2h, h2h

    def _split(self, F, x):
        return list(F.SliceChannel(x, num_outputs=self._num_gates,
                                   axis=1)) if self._num_gates > 1 \
            else [x]


class _ConvRNNCell(_ConvCellBase):
    _num_gates = 1
    _num_states = 1

    def _alias(self):
        return "conv_rnn"

    def hybrid_forward(self, F, inputs, states, i2h_weight, h2h_weight,
                       i2h_bias, h2h_bias):
        prev = states[0] if isinstance(states, (list, tuple)) else states
        i2h, h2h = self._conv_gates(F, inputs, prev, i2h_weight,
                                    h2h_weight, i2h_bias, h2h_bias)
        out = F.Activation(i2h + h2h, act_type=self._activation)
        return out, [out]


class _ConvLSTMCell(_ConvCellBase):
    _num_gates = 4
    _num_states = 2

    def _alias(self):
        return "conv_lstm"

    def hybrid_forward(self, F, inputs, states, i2h_weight, h2h_weight,
                       i2h_bias, h2h_bias):
        prev_h, prev_c = states
        i2h, h2h = self._conv_gates(F, inputs, prev_h, i2h_weight,
                                    h2h_weight, i2h_bias, h2h_bias)
        gates = i2h + h2h
        in_g, forget_g, cell_g, out_g = self._split(F, gates)
        i = F.sigmoid(in_g)
        f = F.sigmoid(forget_g)
        c_tilde = F.Activation(cell_g, act_type=self._activation)
        o = F.sigmoid(out_g)
        next_c = f * prev_c + i * c_tilde
        next_h = o * F.Activation(next_c, act_type=self._activation)
        return next_h, [next_h, next_c]


class _ConvGRUCell(_ConvCellBase):
    _num_gates = 3
    _num_states = 1

    def _alias(self):
        return "conv_gru"

    def hybrid_forward(self, F, inputs, states, i2h_weight, h2h_weight,
                       i2h_bias, h2h_bias):
        prev = states[0] if isinstance(states, (list, tuple)) else states
        i2h, h2h = self._conv_gates(F, inputs, prev, i2h_weight,
                                    h2h_weight, i2h_bias, h2h_bias)
        i_r, i_z, i_n = self._split(F, i2h)
        h_r, h_z, h_n = self._split(F, h2h)
        reset = F.sigmoid(i_r + h_r)
        update = F.sigmoid(i_z + h_z)
        new = F.Activation(i_n + reset * h_n,
                           act_type=self._activation)
        out = (1.0 - update) * new + update * prev
        return out, [out]


def _make(cls, dims, doc):
    def __init__(self, input_shape, hidden_channels, i2h_kernel,
                 h2h_kernel, i2h_pad=0, i2h_dilate=1, h2h_dilate=1,
                 i2h_weight_initializer=None,
                 h2h_weight_initializer=None,
                 i2h_bias_initializer="zeros",
                 h2h_bias_initializer="zeros", activation="tanh",
                 prefix=None, params=None):
        cls.__init__(self, input_shape, hidden_channels, i2h_kernel,
                     h2h_kernel, i2h_pad=i2h_pad, i2h_dilate=i2h_dilate,
                     h2h_dilate=h2h_dilate,
                     i2h_weight_initializer=i2h_weight_initializer,
                     h2h_weight_initializer=h2h_weight_initializer,
                     i2h_bias_initializer=i2h_bias_initializer,
                     h2h_bias_initializer=h2h_bias_initializer,
                     dims=dims, activation=activation, prefix=prefix,
                     params=params)

    return type(doc, (cls,), {"__init__": __init__, "__doc__":
                              "%s: the %d-D convolutional cell."
                              % (doc, dims)})


Conv1DRNNCell = _make(_ConvRNNCell, 1, "Conv1DRNNCell")
Conv2DRNNCell = _make(_ConvRNNCell, 2, "Conv2DRNNCell")
Conv3DRNNCell = _make(_ConvRNNCell, 3, "Conv3DRNNCell")
Conv1DLSTMCell = _make(_ConvLSTMCell, 1, "Conv1DLSTMCell")
Conv2DLSTMCell = _make(_ConvLSTMCell, 2, "Conv2DLSTMCell")
Conv3DLSTMCell = _make(_ConvLSTMCell, 3, "Conv3DLSTMCell")
Conv1DGRUCell = _make(_ConvGRUCell, 1, "Conv1DGRUCell")
Conv2DGRUCell = _make(_ConvGRUCell, 2, "Conv2DGRUCell")
Conv3DGRUCell = _make(_ConvGRUCell, 3, "Conv3DGRUCell")
