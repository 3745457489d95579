"""The fused recurrent layers of the PyTorch port: ``RNN``, ``LSTM``
and ``GRU``.

Counterpart of ``mxtpu/gluon/rnn/rnn_layer.py``, with its Parameters
and their names: one set per layer and direction (``l0_i2h_weight``,
``l0_h2h_weight``, ``l0_i2h_bias``, ``l0_h2h_bias``, ``r0_...`` for the
reverse direction), concatenated into the flat vector of the ``RNN``
op (``_rnn_param_concat``; every weight, layer by layer, then every
bias), which runs on cuDNN on the card (``ops/rnn_op.py``).

* ``layout`` is ``TNC`` or ``NTC`` (swapped to TNC around the op).
* ``begin_state(batch_size, ctx=...)`` gives zero states of shape
  (layers * directions, batch, hidden), on the caller's device.
* ``input_size=0`` defers the first layer's input width to the first
  call with an array.  A hybridized parent traces the layer with
  symbols and cannot infer it, so such a parent gives ``input_size``
  (as the reference's word language model does), in the JAX package
  as here.
* Called without states, the layer starts from zeros and returns only
  its outputs; with states, (outputs, new states).
"""
from __future__ import annotations

from ...base import MXNetError
from ...ops.rnn_op import _GATES
from ..block import HybridBlock

__all__ = ["RNN", "LSTM", "GRU"]


class _RNNLayer(HybridBlock):
    def __init__(self, hidden_size, num_layers, layout, dropout,
                 bidirectional, input_size, i2h_weight_initializer,
                 h2h_weight_initializer, i2h_bias_initializer,
                 h2h_bias_initializer, mode, **kwargs):
        super().__init__(**kwargs)
        if layout not in ("TNC", "NTC"):
            raise MXNetError("invalid layout %r; must be TNC or NTC" % layout)
        self._hidden_size = hidden_size
        self._num_layers = num_layers
        self._mode = mode
        self._layout = layout
        self._dropout = dropout
        self._dir = 2 if bidirectional else 1
        self._input_size = input_size
        ng, ni, nh = _GATES[mode], input_size, hidden_size
        with self.name_scope():
            for i in range(num_layers):
                for j in "lr"[:self._dir]:
                    self._register_param("%s%d_i2h_weight" % (j, i),
                                         (ng * nh, ni),
                                         i2h_weight_initializer)
                    self._register_param("%s%d_h2h_weight" % (j, i),
                                         (ng * nh, nh),
                                         h2h_weight_initializer)
                    self._register_param("%s%d_i2h_bias" % (j, i),
                                         (ng * nh,), i2h_bias_initializer)
                    self._register_param("%s%d_h2h_bias" % (j, i),
                                         (ng * nh,), h2h_bias_initializer)
                ni = nh * self._dir

    def _register_param(self, name, shape, init):
        setattr(self, name, self.params.get(name, shape=shape, init=init,
                                            allow_deferred_init=True))

    def _ordered_params(self, F):
        """The op's flat layout: every layer's and direction's weights,
        then every bias."""
        get = (lambda p: p.var()) if F.__name__.endswith("symbol") else \
            (lambda p: p.data())
        ws, bs = [], []
        for i in range(self._num_layers):
            for j in "lr"[:self._dir]:
                ws += [get(getattr(self, "%s%d_%s" % (j, i, n)))
                       for n in ("i2h_weight", "h2h_weight")]
                bs += [get(getattr(self, "%s%d_%s" % (j, i, n)))
                       for n in ("i2h_bias", "h2h_bias")]
        return ws + bs

    def state_info(self, batch_size=0):
        shape = (self._num_layers * self._dir, batch_size, self._hidden_size)
        n = 2 if self._mode == "lstm" else 1
        return [{"shape": shape, "__layout__": "LNC"}] * n

    def begin_state(self, batch_size=0, func=None, **kwargs):
        """Zero states (``func``, default ``nd.zeros``, with ``kwargs``
        such as ``ctx``)."""
        from ... import ndarray as _nd

        func = func or _nd.zeros
        states = []
        for info in self.state_info(batch_size):
            info = dict(info)
            info.pop("__layout__", None)
            info.update(kwargs)
            states.append(func(**info))
        return states

    def __call__(self, inputs, states=None):
        if self._input_size == 0 and hasattr(inputs, "shape"):
            self._input_size = inputs.shape[self._layout.find("C")]
            self._finish_shape(self._input_size)
        skip_states = states is None
        if skip_states:
            batch = inputs.shape[self._layout.find("N")]
            states = self.begin_state(batch, ctx=inputs.ctx)
        elif hasattr(states, "shape"):
            states = [states]
        outputs, new_states = super().__call__(inputs, states)
        return outputs if skip_states else (outputs, new_states)

    def hybrid_forward(self, F, inputs, states, **kwargs):
        if self._layout == "NTC":
            inputs = F.SwapAxis(inputs, dim1=0, dim2=1)
        flat = F._rnn_param_concat(*self._ordered_params(F), dim=0)
        outputs, *new_states = F.RNN(
            inputs, flat, *states, state_size=self._hidden_size,
            num_layers=self._num_layers, bidirectional=self._dir == 2,
            mode=self._mode, p=self._dropout, state_outputs=True)
        if self._layout == "NTC":
            outputs = F.SwapAxis(outputs, dim1=0, dim2=1)
        return outputs, new_states

    def _finish_shape(self, input_size):
        ni = input_size
        for i in range(self._num_layers):
            for j in "lr"[:self._dir]:
                getattr(self, "%s%d_i2h_weight" % (j, i)).shape = \
                    (_GATES[self._mode] * self._hidden_size, ni)
            ni = self._hidden_size * self._dir


class RNN(_RNNLayer):
    """Elman RNN, tanh or relu."""

    def __init__(self, hidden_size, num_layers=1, activation="relu",
                 layout="TNC", dropout=0, bidirectional=False,
                 i2h_weight_initializer=None, h2h_weight_initializer=None,
                 i2h_bias_initializer="zeros", h2h_bias_initializer="zeros",
                 input_size=0, **kwargs):
        super().__init__(hidden_size, num_layers, layout, dropout,
                         bidirectional, input_size, i2h_weight_initializer,
                         h2h_weight_initializer, i2h_bias_initializer,
                         h2h_bias_initializer, "rnn_" + activation, **kwargs)


class LSTM(_RNNLayer):
    def __init__(self, hidden_size, num_layers=1, layout="TNC", dropout=0,
                 bidirectional=False, input_size=0,
                 i2h_weight_initializer=None, h2h_weight_initializer=None,
                 i2h_bias_initializer="zeros", h2h_bias_initializer="zeros",
                 **kwargs):
        super().__init__(hidden_size, num_layers, layout, dropout,
                         bidirectional, input_size, i2h_weight_initializer,
                         h2h_weight_initializer, i2h_bias_initializer,
                         h2h_bias_initializer, "lstm", **kwargs)


class GRU(_RNNLayer):
    def __init__(self, hidden_size, num_layers=1, layout="TNC", dropout=0,
                 bidirectional=False, input_size=0,
                 i2h_weight_initializer=None, h2h_weight_initializer=None,
                 i2h_bias_initializer="zeros", h2h_bias_initializer="zeros",
                 **kwargs):
        super().__init__(hidden_size, num_layers, layout, dropout,
                         bidirectional, input_size, i2h_weight_initializer,
                         h2h_weight_initializer, i2h_bias_initializer,
                         h2h_bias_initializer, "gru", **kwargs)
