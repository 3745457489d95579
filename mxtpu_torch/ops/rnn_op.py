"""The fused multi-layer ``RNN`` op of the PyTorch port.

Counterpart of ``mxtpu/ops/rnn_op.py``, with the same interface: the
parameters arrive as one flat vector in the reference's cuDNN layout,
every layer's and direction's weights first (``W_x`` (G*H, in), then
``W_h`` (G*H, H)), then every bias (``b_x``, ``b_h``), G gates in the
order i, f, g, o for the LSTM and r, z, n for the GRU (torch's order
too).  ``state`` (and the LSTM's ``state_cell``) are (layers * dirs, N,
H); ``data`` is (T, N, C).  With ``state_outputs`` the op also returns
the final states.

Two versions compute it:

* on the card, :func:`rnn_fused`: torch's fused RNN (cuDNN), called
  once per layer through ``torch._VF.lstm``/``gru``/``rnn_tanh``/
  ``rnn_relu`` (the path ``nn.LSTM.forward`` takes) with the layer's
  weights as views into the flat vector, so gradients reach every
  gluon Parameter through ``_rnn_param_concat``.  cuDNN copies weights
  that are not one buffer in its own layout into one on each call;
* on the CPU, :func:`rnn_plain`, the JAX package's structure: one
  batched input projection over the whole sequence, then a loop over
  the time steps (``_run_direction``).

Either way the dropout between layers (on every layer's output but the
last, only in training) is drawn by the op from the port's generator
(``mxtpu_torch.random``), as ``Dropout`` draws, never by cuDNN.  The
op's float32 runs with TF32 off on the card (``fp32_library``).  The
JAX op accepts ``projection_size`` and the ``lstm_state_clip_*``
attrs and ignores them; the port raises on any value but the default.
"""
from __future__ import annotations

from typing import Optional

import torch

from ..base import MXNetError
from .registry import register

__all__ = ["rnn_param_size", "rnn_plain", "rnn_fused"]

# gates per mode; the modes are also the names of torch's fused calls
_GATES = {"rnn_relu": 1, "rnn_tanh": 1, "lstm": 4, "gru": 3}


def rnn_param_size(input_size: int, state_size: int, num_layers: int,
                   bidirectional: bool, mode: str) -> int:
    """The flat parameter count (the reference's ``GetParamSize``)."""
    g = _GATES[mode]
    d = 2 if bidirectional else 1
    size = 0
    for layer in range(num_layers):
        in_sz = input_size if layer == 0 else state_size * d
        size += d * (g * state_size * (in_sz + state_size) +
                     2 * g * state_size)
    return size


def _unpack_params(params, input_size, state_size, num_layers, bidirectional,
                   mode):
    """Views into the flat vector: ``ws[l][d] = (W_x, W_h)`` and
    ``bs[l][d] = (b_x, b_h)``."""
    g = _GATES[mode]
    d = 2 if bidirectional else 1
    h = state_size
    want = rnn_param_size(input_size, h, num_layers, bidirectional, mode)
    if params.numel() != want:
        raise MXNetError("RNN: %d parameters given, %d wanted for input %d, "
                         "state %d, %d layers, %s" % (
                             params.numel(), want, input_size, h,
                             num_layers, mode))
    ws, bs = [], []
    off = 0
    for layer in range(num_layers):
        in_sz = input_size if layer == 0 else h * d
        dirs = []
        for _ in range(d):
            wx = params[off:off + g * h * in_sz].view(g * h, in_sz)
            off += g * h * in_sz
            wh = params[off:off + g * h * h].view(g * h, h)
            off += g * h * h
            dirs.append((wx, wh))
        ws.append(dirs)
    for layer in range(num_layers):
        dirs = []
        for _ in range(d):
            bx = params[off:off + g * h]
            off += g * h
            bh = params[off:off + g * h]
            off += g * h
            dirs.append((bx, bh))
        bs.append(dirs)
    return ws, bs


def _dropout(x, p, gen):
    keep = 1.0 - p
    mask = torch.empty(x.shape, device=x.device).bernoulli_(
        keep, generator=gen).to(x.dtype)
    return x * mask / keep


# ---------------------------------------------------------------------------
# The plain version: the JAX package's loop
# ---------------------------------------------------------------------------

def _cell_step(mode):
    if mode == "lstm":
        def step(carry, xproj, wh, bh):
            hprev, cprev = carry
            gates = xproj + hprev @ wh.t() + bh
            i, f, g, o = gates.chunk(4, dim=-1)
            c = torch.sigmoid(f) * cprev + torch.sigmoid(i) * torch.tanh(g)
            hnew = torch.sigmoid(o) * torch.tanh(c)
            return (hnew, c), hnew
    elif mode == "gru":
        def step(carry, xproj, wh, bh):
            (hprev,) = carry
            hproj = hprev @ wh.t() + bh
            xr, xz, xn = xproj.chunk(3, dim=-1)
            hr, hz, hn = hproj.chunk(3, dim=-1)
            r = torch.sigmoid(xr + hr)
            z = torch.sigmoid(xz + hz)
            n = torch.tanh(xn + r * hn)
            hnew = (1.0 - z) * n + z * hprev
            return (hnew,), hnew
    else:
        act = torch.relu if mode == "rnn_relu" else torch.tanh

        def step(carry, xproj, wh, bh):
            (hprev,) = carry
            hnew = act(xproj + hprev @ wh.t() + bh)
            return (hnew,), hnew
    return step


def _run_direction(mode, x, h0, c0, wx, wh, bx, bh, reverse):
    """x (T, N, in) -> (outputs (T, N, H), h_T, c_T or None)."""
    t, n, in_sz = x.shape
    gh = wx.shape[0]
    # one product for the whole sequence's input projection
    xproj = (x.reshape(t * n, in_sz) @ wx.t() + bx).reshape(t, n, gh)
    step = _cell_step(mode)
    carry = (h0, c0) if mode == "lstm" else (h0,)
    order = range(t - 1, -1, -1) if reverse else range(t)
    outs = [None] * t
    for i in order:
        carry, outs[i] = step(carry, xproj[i], wh, bh)
    return torch.stack(outs), carry[0], \
        carry[1] if mode == "lstm" else None


def rnn_plain(data, parameters, state, cell, state_size, num_layers,
              bidirectional, mode, p=0.0, is_train=False, gen=None):
    """The op as a loop over time steps; returns (outputs, the final
    states (layers * dirs, N, H), the LSTM's final cells or None)."""
    d = 2 if bidirectional else 1
    ws, bs = _unpack_params(parameters, data.shape[2], state_size,
                            num_layers, bidirectional, mode)
    x = data
    h_finals, c_finals = [], []
    for layer in range(num_layers):
        outs_dir = []
        for di in range(d):
            sidx = layer * d + di
            outs, h_t, c_t = _run_direction(
                mode, x, state[sidx], None if cell is None else cell[sidx],
                *ws[layer][di], *bs[layer][di], reverse=di == 1)
            outs_dir.append(outs)
            h_finals.append(h_t)
            if c_t is not None:
                c_finals.append(c_t)
        x = outs_dir[0] if d == 1 else torch.cat(outs_dir, dim=-1)
        if is_train and p > 0.0 and layer < num_layers - 1:
            x = _dropout(x, p, gen)
    return x, torch.stack(h_finals), \
        torch.stack(c_finals) if c_finals else None


# ---------------------------------------------------------------------------
# The fused version: cuDNN, one layer at a time
# ---------------------------------------------------------------------------

def rnn_fused(data, parameters, state, cell, state_size, num_layers,
              bidirectional, mode, p=0.0, is_train=False, gen=None):
    """The op through torch's fused RNN, a call per layer (cuDNN on the
    card); the same results as :func:`rnn_plain`."""
    d = 2 if bidirectional else 1
    ws, bs = _unpack_params(parameters, data.shape[2], state_size,
                            num_layers, bidirectional, mode)
    fn = getattr(torch._VF, mode)
    # cuDNN keeps what its backward needs only in training mode
    train = torch.is_grad_enabled()
    x = data.contiguous()
    h_finals, c_finals = [], []
    for layer in range(num_layers):
        weights = []
        for di in range(d):
            weights += [*ws[layer][di], *bs[layer][di]]
        h0 = state[layer * d:(layer + 1) * d]
        if mode == "lstm":
            x, h_t, c_t = fn(x, (h0, cell[layer * d:(layer + 1) * d]),
                             weights, True, 1, 0.0, train, bidirectional,
                             False)
            c_finals.append(c_t)
        else:
            x, h_t = fn(x, h0, weights, True, 1, 0.0, train, bidirectional,
                        False)
        h_finals.append(h_t)
        if is_train and p > 0.0 and layer < num_layers - 1:
            x = _dropout(x, p, gen)
    return x, torch.cat(h_finals), torch.cat(c_finals) if c_finals else None


# ---------------------------------------------------------------------------
# The registered op
# ---------------------------------------------------------------------------

def _rnn_num_outputs(attrs):
    if not attrs.get("state_outputs", False):
        return 1
    return 3 if attrs.get("mode", "lstm") == "lstm" else 2


def _check_attrs(mode, projection_size, clip_min, clip_max, clip_nan):
    if mode not in _GATES:
        raise MXNetError("unknown RNN mode %r" % mode)
    if projection_size is not None or clip_min is not None or \
            clip_max is not None or clip_nan:
        raise MXNetError(
            "RNN: projection_size and lstm_state_clip_* are not ported "
            "(the JAX package ignores them; ROADMAP C)")


@register("RNN", num_outputs=_rnn_num_outputs, needs_rng=True,
          train_aware=True, fp32_library=True)
def _rnn(gen, data, parameters, state, *maybe_cell, state_size=0,
         num_layers=1, bidirectional=False, mode="lstm", p=0.0,
         state_outputs=False, projection_size=None, lstm_state_clip_min=None,
         lstm_state_clip_max=None, lstm_state_clip_nan=False, is_train=False):
    _check_attrs(mode, projection_size, lstm_state_clip_min,
                 lstm_state_clip_max, lstm_state_clip_nan)
    state_size, num_layers = int(state_size), int(num_layers)
    bidirectional = bool(bidirectional)
    cell: Optional[torch.Tensor] = None
    if mode == "lstm":
        if not maybe_cell:
            raise MXNetError("RNN(mode='lstm') needs state_cell")
        cell = maybe_cell[0]
    run = rnn_fused if data.is_cuda else rnn_plain
    x, h_out, c_out = run(data, parameters, state, cell, state_size,
                          num_layers, bidirectional, mode, float(p),
                          is_train, gen)
    if not state_outputs:
        return x
    return (x, h_out, c_out) if mode == "lstm" else (x, h_out)
