"""The recurrent cells of the PyTorch port (counterpart of
``mxtpu/gluon/rnn/rnn_cell.py``): ``RNNCell``, ``LSTMCell``, ``GRUCell``
(one step of the fused layers' recurrences, with their Parameter names
``i2h_weight``, ``h2h_weight``, ``i2h_bias``, ``h2h_bias``, so weights
carry across by name; LSTM's gates in the fused layer's order i, f, c,
o), the stacks and modifiers ``SequentialRNNCell``, ``DropoutCell``,
``ResidualCell``, ``ZoneoutCell`` and ``BidirectionalCell`` (which is
only unrolled), over ``RecurrentCell``, ``HybridRecurrentCell`` and
``ModifierCell``.

``unroll(length, inputs, begin_state, layout, merge_outputs)`` steps a
cell over a sequence (``layout`` NTC or TNC; a list of steps, or one
array split along T) and returns the steps' outputs, stacked along T
under ``merge_outputs``, and the last states.  ``valid_length`` is
taken and not read, as in the reference.  Without ``begin_state`` an
imperative unroll starts from zeros on the inputs' device.
``DropoutCell`` and ``ZoneoutCell`` draw their masks from the device's
generator (the draws differ from the JAX package's; the distribution
is the same).
"""
from __future__ import annotations

from ...base import MXNetError
from ..block import Block, HybridBlock

__all__ = ["RecurrentCell", "HybridRecurrentCell", "RNNCell", "LSTMCell",
           "GRUCell", "SequentialRNNCell", "DropoutCell", "ResidualCell",
           "ZoneoutCell", "BidirectionalCell"]


def _cells_state_info(cells, batch_size):
    return sum([c.state_info(batch_size) for c in cells], [])


def _cells_begin_state(cells, **kwargs):
    return sum([c.begin_state(**kwargs) for c in cells], [])


def _format_sequence(length, inputs, layout, merge, F=None):
    """(the steps as a list, or merged along T; the T axis; the ``nd``
    or ``sym`` module of the inputs; the count of steps)."""
    from ... import ndarray as _nd
    from ... import symbol as _sym
    from ...ndarray.ndarray import NDArray

    axis = layout.find("T")
    if isinstance(inputs, (list, tuple)):
        in_list = list(inputs)
        F = _nd if isinstance(in_list[0], NDArray) else _sym
        if merge is True:
            return F.stack(*in_list, axis=axis), axis, F, len(in_list)
        return in_list, axis, F, len(in_list)
    F = _nd if isinstance(inputs, NDArray) else _sym
    if merge is False:
        seq_len = length if length else inputs.shape[axis]
        parts = F.SliceChannel(inputs, num_outputs=seq_len, axis=axis,
                               squeeze_axis=True)
        if not isinstance(parts, list):
            parts = [parts]
        return parts, axis, F, seq_len
    return inputs, axis, F, (length or (inputs.shape[axis]
                                        if hasattr(inputs, "shape") else 0))


class RecurrentCell(Block):
    """The base of the cells: ``state_info``, ``begin_state``,
    ``unroll`` and a step counter."""

    def __init__(self, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        self._modified = False
        self.reset()

    def reset(self):
        self._init_counter = -1
        self._counter = -1
        for cell in self._children.values():
            if hasattr(cell, "reset"):
                cell.reset()

    def state_info(self, batch_size=0):
        raise NotImplementedError

    def begin_state(self, batch_size=0, func=None, **kwargs):
        """The initial states, ``func(shape=..., **kwargs)`` each
        (``nd.zeros`` by default; ``ctx=`` picks the device)."""
        from ... import ndarray as _nd

        func = func or _nd.zeros
        states = []
        for info in self.state_info(batch_size):
            self._init_counter += 1
            info = dict(info or {})
            info.pop("__layout__", None)
            info.update(kwargs)
            states.append(func(**info))
        return states

    def unroll(self, length, inputs, begin_state=None, layout="NTC",
               merge_outputs=None, valid_length=None):
        """Steps the cell ``length`` times; returns (outputs, states)."""
        self.reset()
        inputs_list, axis, F, _ = _format_sequence(length, inputs, layout,
                                                   False)
        states = begin_state if begin_state is not None else \
            self._begin_for(inputs_list[0], F)
        outputs = []
        for i in range(length):
            output, states = self(inputs_list[i], states)
            outputs.append(output)
        if merge_outputs:
            outputs = F.stack(*outputs, axis=axis)
        return outputs, states

    def _begin_for(self, step, F):
        """Zero states for the step ``step`` (N, C): on its device when
        it is an array."""
        from ... import ndarray as _nd

        if F is _nd:
            return self.begin_state(step.shape[0], ctx=step.ctx)
        return self.begin_state(0)

    def __call__(self, inputs, states):
        self._counter += 1
        return super().__call__(inputs, states)

    def forward(self, inputs, states):
        raise NotImplementedError


class HybridRecurrentCell(RecurrentCell, HybridBlock):
    """A cell whose step is a ``hybrid_forward`` (and can be
    hybridized)."""

    def __init__(self, prefix=None, params=None):
        RecurrentCell.__init__(self, prefix=prefix, params=params)
        self._active = False
        self._cached_op = None
        self._flags = []

    def forward(self, inputs, states):
        return HybridBlock.forward(self, inputs, states)

    def hybrid_forward(self, F, x, *args, **kwargs):
        raise NotImplementedError


class _GatedCell(HybridRecurrentCell):
    """The Parameters a cell of ``gates`` gates keeps: ``i2h_weight``
    (gates * hidden, input_size), ``h2h_weight`` (gates * hidden,
    hidden) and their biases."""

    def __init__(self, hidden_size, gates, input_size,
                 i2h_weight_initializer, h2h_weight_initializer,
                 i2h_bias_initializer, h2h_bias_initializer, prefix,
                 params):
        super().__init__(prefix=prefix, params=params)
        self._hidden_size = hidden_size
        self._input_size = input_size
        n = gates * hidden_size
        with self.name_scope():
            self.i2h_weight = self.params.get(
                "i2h_weight", shape=(n, input_size),
                init=i2h_weight_initializer, allow_deferred_init=True)
            self.h2h_weight = self.params.get(
                "h2h_weight", shape=(n, hidden_size),
                init=h2h_weight_initializer, allow_deferred_init=True)
            self.i2h_bias = self.params.get(
                "i2h_bias", shape=(n,), init=i2h_bias_initializer,
                allow_deferred_init=True)
            self.h2h_bias = self.params.get(
                "h2h_bias", shape=(n,), init=h2h_bias_initializer,
                allow_deferred_init=True)

    def state_info(self, batch_size=0):
        return [{"shape": (batch_size, self._hidden_size),
                 "__layout__": "NC"}]


class RNNCell(_GatedCell):
    """``h' = act(W_i x + b_i + W_h h + b_h)``."""

    def __init__(self, hidden_size, activation="tanh", input_size=0,
                 i2h_weight_initializer=None, h2h_weight_initializer=None,
                 i2h_bias_initializer="zeros", h2h_bias_initializer="zeros",
                 prefix=None, params=None):
        super().__init__(hidden_size, 1, input_size, i2h_weight_initializer,
                         h2h_weight_initializer, i2h_bias_initializer,
                         h2h_bias_initializer, prefix, params)
        self._activation = activation

    def _alias(self):
        return "rnn"

    def hybrid_forward(self, F, inputs, states, i2h_weight, h2h_weight,
                       i2h_bias, h2h_bias):
        prev = states[0] if isinstance(states, (list, tuple)) else states
        i2h = F.FullyConnected(inputs, i2h_weight, i2h_bias,
                               num_hidden=self._hidden_size)
        h2h = F.FullyConnected(prev, h2h_weight, h2h_bias,
                               num_hidden=self._hidden_size)
        output = F.Activation(i2h + h2h, act_type=self._activation)
        return output, [output]


class LSTMCell(_GatedCell):
    """One LSTM step; states (h, c)."""

    def __init__(self, hidden_size, input_size=0,
                 i2h_weight_initializer=None, h2h_weight_initializer=None,
                 i2h_bias_initializer="zeros", h2h_bias_initializer="zeros",
                 prefix=None, params=None):
        super().__init__(hidden_size, 4, input_size, i2h_weight_initializer,
                         h2h_weight_initializer, i2h_bias_initializer,
                         h2h_bias_initializer, prefix, params)

    def state_info(self, batch_size=0):
        return 2 * super().state_info(batch_size)

    def _alias(self):
        return "lstm"

    def hybrid_forward(self, F, inputs, states, i2h_weight, h2h_weight,
                       i2h_bias, h2h_bias):
        prev_h, prev_c = states
        i2h = F.FullyConnected(inputs, i2h_weight, i2h_bias,
                               num_hidden=4 * self._hidden_size)
        h2h = F.FullyConnected(prev_h, h2h_weight, h2h_bias,
                               num_hidden=4 * self._hidden_size)
        slices = F.SliceChannel(i2h + h2h, num_outputs=4, axis=1)
        in_gate = F.sigmoid(slices[0])
        forget_gate = F.sigmoid(slices[1])
        in_transform = F.Activation(slices[2], act_type="tanh")
        out_gate = F.sigmoid(slices[3])
        next_c = forget_gate * prev_c + in_gate * in_transform
        next_h = out_gate * F.Activation(next_c, act_type="tanh")
        return next_h, [next_h, next_c]


class GRUCell(_GatedCell):
    """One GRU step (gates r, z, n, as the fused layer)."""

    def __init__(self, hidden_size, input_size=0,
                 i2h_weight_initializer=None, h2h_weight_initializer=None,
                 i2h_bias_initializer="zeros", h2h_bias_initializer="zeros",
                 prefix=None, params=None):
        super().__init__(hidden_size, 3, input_size, i2h_weight_initializer,
                         h2h_weight_initializer, i2h_bias_initializer,
                         h2h_bias_initializer, prefix, params)

    def _alias(self):
        return "gru"

    def hybrid_forward(self, F, inputs, states, i2h_weight, h2h_weight,
                       i2h_bias, h2h_bias):
        prev_h = states[0] if isinstance(states, (list, tuple)) else states
        i2h = F.FullyConnected(inputs, i2h_weight, i2h_bias,
                               num_hidden=3 * self._hidden_size)
        h2h = F.FullyConnected(prev_h, h2h_weight, h2h_bias,
                               num_hidden=3 * self._hidden_size)
        i2h_r, i2h_z, i2h_n = F.SliceChannel(i2h, num_outputs=3, axis=1)
        h2h_r, h2h_z, h2h_n = F.SliceChannel(h2h, num_outputs=3, axis=1)
        reset = F.sigmoid(i2h_r + h2h_r)
        update = F.sigmoid(i2h_z + h2h_z)
        nxt = F.Activation(i2h_n + reset * h2h_n, act_type="tanh")
        next_h = (1.0 - update) * nxt + update * prev_h
        return next_h, [next_h]


class SequentialRNNCell(RecurrentCell):
    """Cells stacked: each step's output feeds the next cell."""

    def __init__(self, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)

    def add(self, cell):
        self.register_child(cell)

    def state_info(self, batch_size=0):
        return _cells_state_info(self._children.values(), batch_size)

    def begin_state(self, batch_size=0, **kwargs):
        return _cells_begin_state(self._children.values(),
                                  batch_size=batch_size, **kwargs)

    def __len__(self):
        return len(self._children)

    def __getitem__(self, i):
        return list(self._children.values())[i]

    def forward(self, inputs, states):
        next_states = []
        p = 0
        for cell in self._children.values():
            n = len(cell.state_info())
            inputs, state = cell(inputs, states[p:p + n])
            p += n
            next_states.extend(state)
        return inputs, next_states


class DropoutCell(HybridRecurrentCell):
    """Dropout of each step's input (``rate``; ``axes`` share a mask);
    no states."""

    def __init__(self, rate, axes=(), prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        self._rate = rate
        self._axes = axes

    def state_info(self, batch_size=0):
        return []

    def _alias(self):
        return "dropout"

    def hybrid_forward(self, F, inputs, states):
        if self._rate > 0:
            inputs = F.Dropout(inputs, p=self._rate, axes=self._axes)
        return inputs, states


class ModifierCell(HybridRecurrentCell):
    """A cell wrapping ``base_cell``, whose states it keeps."""

    def __init__(self, base_cell):
        super().__init__(prefix=None, params=None)
        self.base_cell = base_cell

    def state_info(self, batch_size=0):
        return self.base_cell.state_info(batch_size)

    def begin_state(self, batch_size=0, func=None, **kwargs):
        self.base_cell._modified = False
        begin = self.base_cell.begin_state(batch_size, func=func, **kwargs)
        self.base_cell._modified = True
        return begin


class ResidualCell(ModifierCell):
    """The base cell's output plus its input."""

    def hybrid_forward(self, F, inputs, states):
        output, states = self.base_cell(inputs, states)
        return output + inputs, states


class ZoneoutCell(ModifierCell):
    """Keeps each of the base cell's new outputs (``zoneout_outputs``)
    and states (``zoneout_states``) with probability 1 - p, else the
    previous step's."""

    def __init__(self, base_cell, zoneout_outputs=0.0, zoneout_states=0.0):
        super().__init__(base_cell)
        self.zoneout_outputs = zoneout_outputs
        self.zoneout_states = zoneout_states
        self._prev_output = None

    def _alias(self):
        return "zoneout"

    def reset(self):
        super().reset()
        self._prev_output = None

    def hybrid_forward(self, F, inputs, states):
        next_output, next_states = self.base_cell(inputs, states)
        if self.zoneout_outputs > 0:
            mask = F.Dropout(F.ones_like(next_output),
                             p=self.zoneout_outputs)
            prev = self._prev_output if self._prev_output is not None \
                else F.zeros_like(next_output)
            next_output = F.where(mask, next_output, prev)
        self._prev_output = next_output
        if self.zoneout_states > 0:
            next_states = [
                F.where(F.Dropout(F.ones_like(new_s),
                                  p=self.zoneout_states), new_s, old_s)
                for new_s, old_s in zip(next_states, states)]
        return next_output, next_states


class BidirectionalCell(HybridRecurrentCell):
    """``l_cell`` over the sequence and ``r_cell`` over it reversed,
    their outputs concatenated step by step; only unrolled."""

    def __init__(self, l_cell, r_cell, output_prefix="bi_"):
        super().__init__(prefix="", params=None)
        self.register_child(l_cell, "l_cell")
        self.register_child(r_cell, "r_cell")
        self._output_prefix = output_prefix

    def state_info(self, batch_size=0):
        return _cells_state_info(self._children.values(), batch_size)

    def begin_state(self, batch_size=0, **kwargs):
        return _cells_begin_state(self._children.values(),
                                  batch_size=batch_size, **kwargs)

    def __call__(self, inputs, states):
        raise MXNetError("BidirectionalCell cannot be stepped; use unroll")

    def unroll(self, length, inputs, begin_state=None, layout="NTC",
               merge_outputs=None, valid_length=None):
        self.reset()
        inputs_list, _, F, _ = _format_sequence(length, inputs, layout,
                                                False)
        states = begin_state if begin_state is not None else \
            self._begin_for(inputs_list[0], F)
        l_cell, r_cell = self._children.values()
        n_l = len(l_cell.state_info())
        l_out, l_states = l_cell.unroll(length, inputs_list,
                                        states[:n_l], layout, False)
        r_out, r_states = r_cell.unroll(length, list(reversed(inputs_list)),
                                        states[n_l:], layout, False)
        outputs = [F.concat(lo, ro, dim=1)
                   for lo, ro in zip(l_out, reversed(r_out))]
        return outputs, l_states + r_states
