"""Control-flow ops of the PyTorch port: ``_foreach``, ``_while_loop``
and ``_cond`` (counterpart of ``mxtpu/ops/control_flow.py``).

Each op holds its subgraph Symbols as attributes of one node, with the
node-input layout and the attrs that ``mxtpu_torch/control_flow.py``
builds (the JAX package's contract), and walks them with the
executor's graph walk (``executor._graph_walk``).  The JAX package
lowers them to ``lax.scan``, ``lax.while_loop`` and ``lax.cond``; here
they are Python loops over torch calls, which autograd records:

* ``_foreach`` indexes ``data[t]`` step by step and stacks the step
  outputs; it never reads a value on the host.
* ``_while_loop`` reads its predicate on the host once an iteration,
  as MXNet's imperative path does, and pads the stacked step outputs
  with zero rows to ``max_iterations``.  Inside a CUDA-graph capture
  (``FusedTrainLoop``), where a host read is illegal, and on ``meta``
  tensors (shape inference) it runs ``max_iterations`` masked steps
  instead: a step past the end keeps the loop variables and the aux
  values and writes a zero row.  It has no gradient, as in the JAX
  package (reverse mode through ``lax.while_loop``): called with grad
  enabled on an input that wants a gradient, it raises.
* ``_cond`` reads its predicate on the host once a call and walks the
  branch taken.  Inside a capture and on ``meta`` tensors it walks both
  branches and selects the outputs and aux values with ``torch.where``.
  Each branch's inputs pass through ``_Gate``, whose backward selects
  the gradient of the branch taken and 0 for the other: the branch not
  taken may have an infinite or NaN derivative (a ``sqrt`` at 0, a
  ``log`` below 0), and 0 times it would be NaN in the shared inputs'
  gradients.  So only the branch taken is differentiated, as in the
  eager path and the JAX package's ``lax.cond``.

Every subgraph step draws its random numbers from the device's
generator, so a dropout inside a body draws a fresh mask each step (the
JAX package folds the step index into the node's key).  The subgraph's
updated aux values (a BatchNorm's moving statistics) ride after the
visible outputs; the executor's walk writes them back to the outer aux
slots by name.
"""
from __future__ import annotations

import torch

from ..base import MXNetError
from .registry import register


def _sub_fn(graph, args, aux, is_train, device):
    from .. import amp as _amp
    from ..executor import _graph_walk

    return _graph_walk(graph, list(args), list(aux), bool(is_train),
                       device, _amp.get_compute_dtype())


def _place(n_slots, locs_vals_pairs):
    vals = [None] * n_slots
    for locs, vs in locs_vals_pairs:
        for loc, v in zip(locs, vs):
            vals[loc] = v
    return vals


def _no_host_read(t) -> bool:
    """True where the predicate must not be read on the host: ``meta``
    tensors, and a CUDA-graph capture in progress."""
    return t.device.type == "meta" or (
        t.device.type == "cuda" and torch.cuda.is_current_stream_capturing())


def _select(pred, a, b):
    return torch.where(pred.reshape(()).bool(), a, b)


class _Gate(torch.autograd.Function):
    """Identity forward; backward passes the gradient where ``taken`` and
    0 elsewhere, by a select (not a product), so a NaN stops here."""

    @staticmethod
    def forward(ctx, x, taken):
        ctx.save_for_backward(taken)
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        taken, = ctx.saved_tensors
        return torch.where(taken, g, torch.zeros((), dtype=g.dtype,
                                                 device=g.device)), None


def _gated(xs, taken):
    return [_Gate.apply(x, taken) if x.is_floating_point() else x
            for x in xs]


@register("_foreach", needs_rng=True, train_aware=True,
          num_outputs=lambda attrs: int(attrs["num_out_data"])
          + int(attrs["num_states"]))
def _foreach(gen, *inputs, subgraph, sub_args, sub_aux=(), data_locs=(),
             state_locs=(), free_locs=(), num_out_data=1, num_states=0,
             is_train=False):
    """inputs = [data..., states..., frees..., aux...] in the order the
    attrs' loc tuples describe; loops over axis 0 of the data."""
    nd_, ns_, nf_ = len(data_locs), len(state_locs), len(free_locs)
    data = inputs[:nd_]
    states = list(inputs[nd_:nd_ + ns_])
    frees = inputs[nd_ + ns_:nd_ + ns_ + nf_]
    aux = list(inputs[nd_ + ns_ + nf_:])
    if data[0].shape[0] == 0:
        # no step: the step outputs' shapes from one walk on meta
        # tensors, as lax.scan gives (0, ...) outputs and the states
        meta = [t.to("meta") for t in inputs]
        fn = _sub_fn(subgraph, sub_args, sub_aux, is_train,
                     torch.device("meta"))
        vals = _place(len(sub_args),
                      [(data_locs, [d.new_empty(d.shape[1:])
                                    for d in meta[:nd_]]),
                       (state_locs, meta[nd_:nd_ + ns_]),
                       (free_locs, meta[nd_ + ns_:nd_ + ns_ + nf_])])
        outs, _ = fn(vals, meta[nd_ + ns_ + nf_:])
        return tuple(torch.zeros((0,) + tuple(o.shape), dtype=o.dtype,
                                 device=data[0].device)
                     for o in outs[:num_out_data]) + tuple(states) + \
            tuple(aux)
    fn = _sub_fn(subgraph, sub_args, sub_aux, is_train, data[0].device)
    steps = [[] for _ in range(int(num_out_data))]
    for t in range(data[0].shape[0]):
        vals = _place(len(sub_args), [(data_locs, [d[t] for d in data]),
                                      (state_locs, states),
                                      (free_locs, frees)])
        outs, aux = fn(vals, aux)
        for slot, o in zip(steps, outs[:num_out_data]):
            slot.append(o)
        states = list(outs[num_out_data:])
    return tuple(torch.stack(s) for s in steps) + tuple(states) + tuple(aux)


@register("_while_loop", needs_rng=True, train_aware=True,
          num_outputs=lambda attrs: int(attrs["num_out_data"])
          + int(attrs["num_states"]))
def _while_loop(gen, *inputs, cond_graph, cond_args, body_graph, body_args,
                sub_aux=(), state_locs_cond=(), free_locs_cond=(),
                state_locs_body=(), free_locs_body=(), cond_state_idx=None,
                n_states=0, num_out_data=0, num_states=0, max_iterations=0,
                is_train=False):
    """inputs = [loop_vars..., frees_cond..., frees_body..., aux...]; the
    body returns (step_outputs..., new_loop_vars...); step outputs are
    stacked into (max_iterations, ...), rows past the trip count 0."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in inputs):
        raise MXNetError("_while_loop has no gradient: reverse-mode "
                         "differentiation does not run through a loop "
                         "whose trip count depends on the data (as in "
                         "the JAX package's lax.while_loop); use foreach")
    lv = list(inputs[:n_states])
    off = n_states
    frees_c = list(inputs[off:off + len(free_locs_cond)])
    off += len(free_locs_cond)
    frees_b = list(inputs[off:off + len(free_locs_body)])
    off += len(free_locs_body)
    aux = list(inputs[off:])
    device = lv[0].device
    cond_fn = _sub_fn(cond_graph, cond_args, sub_aux, is_train, device)
    body_fn = _sub_fn(body_graph, body_args, sub_aux, is_train, device)
    idx = cond_state_idx if cond_state_idx is not None \
        else tuple(range(n_states))

    def run_cond(vars_, aux_c):
        vals = _place(len(cond_args), [(state_locs_cond,
                                        [vars_[j] for j in idx]),
                                       (free_locs_cond, frees_c)])
        outs, _ = cond_fn(vals, aux_c)
        return outs[0].reshape(()) != 0

    def run_body(vars_, aux_c):
        vals = _place(len(body_args), [(state_locs_body, vars_),
                                       (free_locs_body, frees_b)])
        outs, aux_n = body_fn(vals, aux_c)
        return (list(outs[:num_out_data]), list(outs[num_out_data:]),
                list(aux_n))

    max_it = int(max_iterations)
    rows = []
    if _no_host_read(lv[0]):
        alive = torch.ones((), dtype=torch.bool, device=device)
        for _ in range(max_it):
            alive = alive & run_cond(lv, aux)
            step, new, aux_n = run_body(lv, aux)
            rows.append([torch.where(alive, o, torch.zeros_like(o))
                         for o in step])
            lv = [torch.where(alive, n, v) for n, v in zip(new, lv)]
            aux = [torch.where(alive, n, a) for n, a in zip(aux_n, aux)]
    else:
        while len(rows) < max_it and bool(run_cond(lv, aux)):
            step, lv, aux = run_body(lv, aux)
            rows.append(step)
    if rows:
        first = rows[0]
    else:  # no iteration: the shapes from one discarded body walk
        first = [torch.zeros_like(o) for o in run_body(lv, aux)[0]]
    bufs = []
    for k, o in enumerate(first):
        stacked = [r[k] for r in rows]
        stacked += [torch.zeros_like(o)] * (max_it - len(rows))
        bufs.append(torch.stack(stacked))
    return tuple(bufs) + tuple(lv[:num_states]) + tuple(aux)


@register("_cond", needs_rng=True, train_aware=True,
          num_outputs=lambda attrs: int(attrs["num_outputs"]))
def _cond(gen, *inputs, then_graph, then_args, else_graph, else_args,
          sub_aux=(), n_then_free=0, num_outputs=1, is_train=False):
    """inputs = [pred, frees_then..., frees_else..., aux...]; both
    branches give outputs of the same shapes and dtypes."""
    pred = inputs[0]
    frees_t = list(inputs[1:1 + n_then_free])
    rest = inputs[1 + n_then_free:]
    frees_e = list(rest[:len(else_args)])
    aux = list(rest[len(else_args):])

    def run(graph, args, frees):
        outs, aux_n = _sub_fn(graph, args, sub_aux, is_train,
                              pred.device)(frees, aux)
        return list(outs) + list(aux_n)

    if _no_host_read(pred):
        taken = pred.reshape(()).bool()
        then = run(then_graph, then_args, _gated(frees_t, taken))
        other = run(else_graph, else_args, _gated(frees_e, ~taken))
        return tuple(_select(pred, a, b) for a, b in zip(then, other))
    if bool(pred.reshape(()) != 0):
        return tuple(run(then_graph, then_args, frees_t))
    return tuple(run(else_graph, else_args, frees_e))
