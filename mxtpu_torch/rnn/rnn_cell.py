"""Symbolic recurrent cells of the PyTorch port.

Counterpart of ``mxtpu/rnn/rnn_cell.py``: ``RNNParams``, ``BaseRNNCell``
(``begin_state``, ``unroll``), ``RNNCell``, ``LSTMCell``, ``GRUCell``,
``FusedRNNCell`` (over the fused ``RNN`` op, cuDNN on the card),
``SequentialRNNCell``, ``DropoutCell`` and ``BidirectionalCell``.
``unroll`` builds the time-unrolled graph node for node as the JAX
package does, names included, so its JSON loads in either package.
As there, a symbolic ``begin_state`` takes an explicit ``batch_size``
(the states are ``_zeros`` nodes of a fixed shape), which
``BucketingModule``'s ``sym_gen`` passes for each bucket.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

from ..base import MXNetError
from .. import symbol as sym

__all__ = ["RNNParams", "BaseRNNCell", "RNNCell", "LSTMCell", "GRUCell",
           "FusedRNNCell", "SequentialRNNCell", "DropoutCell",
           "BidirectionalCell"]


class RNNParams(object):
    """The cells' weight variables, made on first use and shared by
    every cell that holds this container."""

    def __init__(self, prefix: str = ""):
        self._prefix = prefix
        self._params: Dict[str, Any] = {}

    def get(self, name: str, **kwargs):
        name = self._prefix + name
        if name not in self._params:
            self._params[name] = sym.Variable(name, **kwargs)
        return self._params[name]


class BaseRNNCell(object):
    def __init__(self, prefix: str = "", params: Optional[RNNParams] = None):
        if params is None:
            params = RNNParams(prefix)
            self._own_params = True
        else:
            self._own_params = False
        self._prefix = prefix
        self._params = params
        self._modified = False
        self.reset()

    def reset(self):
        self._init_counter = -1
        self._counter = -1

    @property
    def params(self) -> RNNParams:
        self._own_params = False
        return self._params

    @property
    def state_info(self) -> List[Dict]:
        raise NotImplementedError

    @property
    def _gate_names(self) -> Tuple[str, ...]:
        return ()

    def __call__(self, inputs, states):
        raise NotImplementedError

    def begin_state(self, func=None, batch_size: int = 0, **kwargs):
        """Zero states (``_zeros`` nodes, ``func`` by default) of the
        given ``batch_size``."""
        if self._modified:
            raise MXNetError("cannot begin_state on a modified cell")
        if func is None:
            func = sym.zeros
        states = []
        for info in self.state_info:
            self._init_counter += 1
            shape = tuple(batch_size if d == 0 else d
                          for d in info["shape"])
            states.append(func(name="%sbegin_state_%d"
                               % (self._prefix, self._init_counter),
                               shape=shape, **kwargs))
        return states

    def unroll(self, length: int, inputs, begin_state=None,
               layout: str = "NTC", merge_outputs: Optional[bool] = None,
               batch_size: int = 0):
        """The cell applied ``length`` times along ``layout``'s T axis:
        (outputs, final states); ``merge_outputs`` stacks the outputs
        into one symbol."""
        self.reset()
        axis = layout.find("T")
        if not isinstance(inputs, (list, tuple)):
            inputs = list(sym.SliceChannel(inputs, num_outputs=length,
                                           axis=axis, squeeze_axis=True))
        if begin_state is None:
            begin_state = self.begin_state(batch_size=batch_size)
        states = begin_state
        outputs = []
        for i in range(length):
            out, states = self(inputs[i], states)
            outputs.append(out)
        if merge_outputs:
            outputs = sym.stack(*outputs, axis=axis)
        return outputs, states


class RNNCell(BaseRNNCell):
    """Vanilla tanh RNN cell."""

    def __init__(self, num_hidden, activation="tanh", prefix="rnn_",
                 params=None):
        super().__init__(prefix=prefix, params=params)
        self._num_hidden = num_hidden
        self._activation = activation
        self._iW = self.params.get("i2h_weight")
        self._iB = self.params.get("i2h_bias")
        self._hW = self.params.get("h2h_weight")
        self._hB = self.params.get("h2h_bias")

    @property
    def state_info(self):
        return [{"shape": (0, self._num_hidden), "__layout__": "NC"}]

    def __call__(self, inputs, states):
        self._counter += 1
        name = "%st%d_" % (self._prefix, self._counter)
        i2h = sym.FullyConnected(data=inputs, weight=self._iW, bias=self._iB,
                                 num_hidden=self._num_hidden,
                                 name="%si2h" % name)
        h2h = sym.FullyConnected(data=states[0], weight=self._hW,
                                 bias=self._hB,
                                 num_hidden=self._num_hidden,
                                 name="%sh2h" % name)
        output = sym.Activation(data=i2h + h2h, act_type=self._activation,
                                name="%sout" % name)
        return output, [output]


class LSTMCell(BaseRNNCell):
    """LSTM cell (gates i, f, c, o); its i2h bias starts at
    ``forget_bias`` in the forget gate (``LSTMBias``)."""

    def __init__(self, num_hidden, prefix="lstm_", params=None,
                 forget_bias=1.0):
        super().__init__(prefix=prefix, params=params)
        self._num_hidden = num_hidden
        from ..initializer import LSTMBias

        self._iW = self.params.get("i2h_weight")
        self._iB = self.params.get("i2h_bias",
                                   init=LSTMBias(forget_bias=forget_bias))
        self._hW = self.params.get("h2h_weight")
        self._hB = self.params.get("h2h_bias")

    @property
    def state_info(self):
        return [{"shape": (0, self._num_hidden), "__layout__": "NC"},
                {"shape": (0, self._num_hidden), "__layout__": "NC"}]

    @property
    def _gate_names(self):
        return ("_i", "_f", "_c", "_o")

    def __call__(self, inputs, states):
        self._counter += 1
        name = "%st%d_" % (self._prefix, self._counter)
        i2h = sym.FullyConnected(data=inputs, weight=self._iW, bias=self._iB,
                                 num_hidden=self._num_hidden * 4,
                                 name="%si2h" % name)
        h2h = sym.FullyConnected(data=states[0], weight=self._hW,
                                 bias=self._hB,
                                 num_hidden=self._num_hidden * 4,
                                 name="%sh2h" % name)
        gates = i2h + h2h
        slices = sym.SliceChannel(gates, num_outputs=4, axis=1,
                                  name="%sslice" % name)
        in_gate = sym.Activation(slices[0], act_type="sigmoid")
        forget_gate = sym.Activation(slices[1], act_type="sigmoid")
        in_transform = sym.Activation(slices[2], act_type="tanh")
        out_gate = sym.Activation(slices[3], act_type="sigmoid")
        next_c = forget_gate * states[1] + in_gate * in_transform
        next_h = out_gate * sym.Activation(next_c, act_type="tanh",
                                           name="%sstate" % name)
        return next_h, [next_h, next_c]


class GRUCell(BaseRNNCell):
    """GRU cell (gates r, z, n)."""

    def __init__(self, num_hidden, prefix="gru_", params=None):
        super().__init__(prefix=prefix, params=params)
        self._num_hidden = num_hidden
        self._iW = self.params.get("i2h_weight")
        self._iB = self.params.get("i2h_bias")
        self._hW = self.params.get("h2h_weight")
        self._hB = self.params.get("h2h_bias")

    @property
    def state_info(self):
        return [{"shape": (0, self._num_hidden), "__layout__": "NC"}]

    def __call__(self, inputs, states):
        self._counter += 1
        name = "%st%d_" % (self._prefix, self._counter)
        prev_h = states[0]
        i2h = sym.FullyConnected(data=inputs, weight=self._iW, bias=self._iB,
                                 num_hidden=self._num_hidden * 3,
                                 name="%si2h" % name)
        h2h = sym.FullyConnected(data=prev_h, weight=self._hW, bias=self._hB,
                                 num_hidden=self._num_hidden * 3,
                                 name="%sh2h" % name)
        i2h_s = sym.SliceChannel(i2h, num_outputs=3, axis=1)
        h2h_s = sym.SliceChannel(h2h, num_outputs=3, axis=1)
        reset = sym.Activation(i2h_s[0] + h2h_s[0], act_type="sigmoid")
        update = sym.Activation(i2h_s[1] + h2h_s[1], act_type="sigmoid")
        cand = sym.Activation(i2h_s[2] + reset * h2h_s[2], act_type="tanh")
        next_h = (1.0 - update) * cand + update * prev_h
        return next_h, [next_h]


class FusedRNNCell(BaseRNNCell):
    """The fused ``RNN`` op over the whole sequence (cuDNN on the
    card), its weights one flat ``parameters`` variable."""

    def __init__(self, num_hidden, num_layers=1, mode="lstm",
                 bidirectional=False, dropout=0.0, prefix=None, params=None):
        if prefix is None:
            prefix = "%s_" % mode
        super().__init__(prefix=prefix, params=params)
        self._num_hidden = num_hidden
        self._num_layers = num_layers
        self._mode = mode
        self._bidirectional = bidirectional
        self._dropout = dropout
        self._param = self.params.get("parameters")

    @property
    def state_info(self):
        d = 2 if self._bidirectional else 1
        info = [{"shape": (self._num_layers * d, 0, self._num_hidden)}]
        if self._mode == "lstm":
            info.append({"shape": (self._num_layers * d, 0,
                                   self._num_hidden)})
        return info

    def unroll(self, length, inputs, begin_state=None, layout="NTC",
               merge_outputs=None, batch_size: int = 0):
        self.reset()
        if isinstance(inputs, (list, tuple)):
            inputs = sym.stack(*inputs, axis=1 if layout == "NTC" else 0)
        if layout == "NTC":  # RNN op wants TNC
            inputs = sym.SwapAxis(inputs, dim1=0, dim2=1)
        if begin_state is None:
            begin_state = self.begin_state(batch_size=batch_size)
        rnn_args = [inputs, self._param] + list(begin_state)
        out = sym.RNN(*rnn_args, state_size=self._num_hidden,
                      num_layers=self._num_layers, mode=self._mode,
                      bidirectional=self._bidirectional, p=self._dropout,
                      state_outputs=False,
                      name="%srnn" % self._prefix)
        if layout == "NTC":
            out = sym.SwapAxis(out, dim1=0, dim2=1)
        if merge_outputs is False:
            axis = layout.find("T")
            out = list(sym.SliceChannel(out, num_outputs=length,
                                        axis=axis, squeeze_axis=True))
        return out, []


class SequentialRNNCell(BaseRNNCell):
    """Stack of cells applied in sequence."""

    def __init__(self, params=None):
        super().__init__(prefix="", params=params)
        self._cells: List[BaseRNNCell] = []

    def add(self, cell: BaseRNNCell):
        self._cells.append(cell)

    @property
    def state_info(self):
        return sum([c.state_info for c in self._cells], [])

    def begin_state(self, func=None, batch_size: int = 0, **kwargs):
        return sum([c.begin_state(func=func, batch_size=batch_size,
                                  **kwargs) for c in self._cells], [])

    def __call__(self, inputs, states):
        next_states = []
        p = 0
        for cell in self._cells:
            n = len(cell.state_info)
            inputs, st = cell(inputs, states[p:p + n])
            next_states.extend(st)
            p += n
        return inputs, next_states


class DropoutCell(BaseRNNCell):
    def __init__(self, dropout: float, prefix="dropout_", params=None):
        super().__init__(prefix=prefix, params=params)
        self._dropout = dropout

    @property
    def state_info(self):
        return []

    def __call__(self, inputs, states):
        if self._dropout > 0:
            inputs = sym.Dropout(data=inputs, p=self._dropout)
        return inputs, states


class BidirectionalCell(BaseRNNCell):
    """Two cells over the sequence in opposite directions, their
    outputs concatenated (``unroll`` only)."""

    def __init__(self, l_cell, r_cell, params=None, output_prefix="bi_"):
        super().__init__(prefix="", params=params)
        self._l_cell, self._r_cell = l_cell, r_cell
        self._output_prefix = output_prefix

    @property
    def state_info(self):
        return self._l_cell.state_info + self._r_cell.state_info

    def begin_state(self, func=None, batch_size: int = 0, **kwargs):
        return (self._l_cell.begin_state(func=func, batch_size=batch_size,
                                         **kwargs) +
                self._r_cell.begin_state(func=func, batch_size=batch_size,
                                         **kwargs))

    def __call__(self, inputs, states):
        raise MXNetError("BidirectionalCell supports unroll() only")

    def unroll(self, length, inputs, begin_state=None, layout="NTC",
               merge_outputs=None, batch_size: int = 0):
        self.reset()
        axis = layout.find("T")
        if not isinstance(inputs, (list, tuple)):
            inputs = list(sym.SliceChannel(inputs, num_outputs=length,
                                           axis=axis, squeeze_axis=True))
        if begin_state is None:
            begin_state = self.begin_state(batch_size=batch_size)
        nl = len(self._l_cell.state_info)
        l_out, l_states = self._l_cell.unroll(
            length, inputs, begin_state[:nl], layout=layout,
            merge_outputs=False)
        r_out, r_states = self._r_cell.unroll(
            length, list(reversed(inputs)), begin_state[nl:],
            layout=layout, merge_outputs=False)
        outputs = [sym.Concat(l, r, dim=1, name="%st%d" %
                              (self._output_prefix, i))
                   for i, (l, r) in enumerate(zip(l_out,
                                                  reversed(r_out)))]
        if merge_outputs:
            outputs = sym.stack(*outputs, axis=axis)
        return outputs, l_states + r_states
