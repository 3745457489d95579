"""Experimental recurrent cells of the PyTorch port (counterpart of
``mxtpu/gluon/contrib/rnn/rnn_cell.py``; MXNet's
``gluon/contrib/rnn/rnn_cell.py``)."""
from __future__ import annotations

from ...rnn.rnn_cell import HybridRecurrentCell, ModifierCell

__all__ = ["VariationalDropoutCell", "LSTMPCell"]


class VariationalDropoutCell(ModifierCell):
    """Variational (locked) dropout (Gal & Ghahramani 2016): ONE
    dropout mask per sequence, shared across time steps, separately for
    inputs, states and outputs.  Masks are drawn on the first step after
    ``reset()``, on the input's device."""

    def __init__(self, base_cell, drop_inputs=0.0, drop_states=0.0,
                 drop_outputs=0.0):
        super().__init__(base_cell)
        self.drop_inputs = drop_inputs
        self.drop_states = drop_states
        self.drop_outputs = drop_outputs
        self._masks = {}

    def _alias(self):
        return "vardrop"

    def reset(self):
        super().reset()
        self._masks = {}

    def _mask(self, name, rate, like):
        from .... import autograd, random

        if not rate or not autograd.is_training():
            return None
        if name not in self._masks:
            keep = 1.0 - rate
            bern = random.uniform(0, 1, like.shape, ctx=like.ctx) < keep
            self._masks[name] = bern.astype(like.dtype) / keep
        return self._masks[name]

    def hybrid_forward(self, F, inputs, states):
        # the masks are drawn once a sequence, in Python, and kept
        m = self._mask("inputs", self.drop_inputs, inputs)
        if m is not None:
            inputs = inputs * m
        if self.drop_states and states:
            sm = self._mask("states", self.drop_states, states[0])
            if sm is not None:
                states = [states[0] * sm] + list(states[1:])
        output, next_states = self.base_cell(inputs, states)
        om = self._mask("outputs", self.drop_outputs, output)
        if om is not None:
            output = output * om
        return output, next_states

    def unroll(self, length, inputs, begin_state=None, layout="NTC",
               merge_outputs=None, valid_length=None):
        self.reset()  # fresh masks for each sequence
        return super().unroll(length, inputs, begin_state=begin_state,
                              layout=layout, merge_outputs=merge_outputs,
                              valid_length=valid_length)


class LSTMPCell(HybridRecurrentCell):
    """LSTM with a hidden-state projection (LSTMP, Sak et al. 2014): the
    recurrent state is projected to ``projection_size`` < hidden_size,
    shrinking the h2h product."""

    def __init__(self, hidden_size, projection_size, input_size=0,
                 i2h_weight_initializer=None, h2h_weight_initializer=None,
                 h2r_weight_initializer=None,
                 i2h_bias_initializer="zeros", h2h_bias_initializer="zeros",
                 prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        self._hidden_size = hidden_size
        self._projection_size = projection_size
        self._input_size = input_size
        with self.name_scope():
            self.i2h_weight = self.params.get(
                "i2h_weight", shape=(4 * hidden_size, input_size),
                init=i2h_weight_initializer, allow_deferred_init=True)
            self.h2h_weight = self.params.get(
                "h2h_weight", shape=(4 * hidden_size, projection_size),
                init=h2h_weight_initializer, allow_deferred_init=True)
            self.h2r_weight = self.params.get(
                "h2r_weight", shape=(projection_size, hidden_size),
                init=h2r_weight_initializer, allow_deferred_init=True)
            self.i2h_bias = self.params.get(
                "i2h_bias", shape=(4 * hidden_size,),
                init=i2h_bias_initializer, allow_deferred_init=True)
            self.h2h_bias = self.params.get(
                "h2h_bias", shape=(4 * hidden_size,),
                init=h2h_bias_initializer, allow_deferred_init=True)

    def state_info(self, batch_size=0):
        return [{"shape": (batch_size, self._projection_size),
                 "__layout__": "NC"},
                {"shape": (batch_size, self._hidden_size),
                 "__layout__": "NC"}]

    def _alias(self):
        return "lstmp"

    def hybrid_forward(self, F, inputs, states, i2h_weight, h2h_weight,
                       h2r_weight, i2h_bias, h2h_bias):
        prev_r, prev_c = states
        i2h = F.FullyConnected(inputs, i2h_weight, i2h_bias,
                               num_hidden=4 * self._hidden_size)
        h2h = F.FullyConnected(prev_r, h2h_weight, h2h_bias,
                               num_hidden=4 * self._hidden_size)
        gates = i2h + h2h
        in_g, forget_g, cell_g, out_g = F.SliceChannel(
            gates, num_outputs=4, axis=1)
        i = F.sigmoid(in_g)
        f = F.sigmoid(forget_g)
        c_tilde = F.Activation(cell_g, act_type="tanh")
        o = F.sigmoid(out_g)
        next_c = f * prev_c + i * c_tilde
        hidden = o * F.Activation(next_c, act_type="tanh")
        next_r = F.FullyConnected(hidden, h2r_weight, no_bias=True,
                                  num_hidden=self._projection_size)
        return next_r, [next_r, next_c]
