"""User-facing control flow of the PyTorch port: ``foreach``,
``while_loop`` and ``cond`` over NDArrays and Symbols (counterpart of
``mxtpu/control_flow.py``; MXNet's ``sym.contrib`` and ``nd.contrib``
front ends).

On Symbols the callables are traced with placeholder variables into
subgraph Symbols held by one node of a registered op
(``mxtpu_torch/ops/control_flow.py``), which the executor walks.  Free
variables: the callables may close over outer Symbols; every leaf
variable of a traced subgraph that is not a placeholder becomes an
input of the node, bound by NAME (weights and the like).  On NDArrays
the loop runs imperatively, a Python loop that autograd records;
``while_loop`` and ``cond`` read their predicate on the host.

The shape metas at the end solve the free variables' shapes by the
subgraph's own partial shape inference.  A graph holding such a node
has Symbols among its attributes, so ``tojson`` raises ``TypeError``,
as in the JAX package.
"""
from __future__ import annotations

from typing import Callable, List, Sequence, Tuple

from .base import MXNetError

__all__ = ["foreach", "while_loop", "cond"]


def _is_symbol(x):
    from .symbol.symbol import Symbol

    return isinstance(x, Symbol)


def _as_list(x):
    return list(x) if isinstance(x, (list, tuple)) else [x]


def _sub_io(subgraph, placeholders):
    """Split subgraph arguments into placeholder locs and free-variable
    locs; return (sub_args, locs_per_placeholder, free_names,
    free_locs, aux_names)."""
    sub_args = subgraph.list_arguments()
    pos = {n: i for i, n in enumerate(sub_args)}
    ph_locs = []
    used = set()
    for name in placeholders:
        loc = pos.get(name, -1)
        ph_locs.append(loc)
        if loc >= 0:
            used.add(loc)
    free = [(n, i) for i, n in enumerate(sub_args) if i not in used]
    return (sub_args, ph_locs, [n for n, _ in free],
            [i for _, i in free], subgraph.list_auxiliary_states())


def _outer_vars(names, aux_names=()):
    """Create outer-graph variables resolved by name at bind time."""
    from .symbol.symbol import Variable

    out = []
    for n in names:
        v = Variable(n)
        if n in aux_names:
            v._outputs[0][0].is_aux = True
        out.append(v)
    return out


def _node(op_name, inputs, attrs, name):
    from .symbol.register import invoke_symbol

    return invoke_symbol(op_name, inputs, attrs, name=name)


# ---------------------------------------------------------------------------
# foreach
# ---------------------------------------------------------------------------

def foreach(body: Callable, data, init_states, name: str = "foreach"):
    """Run `body(x_t, states) -> (out_t, new_states)` over axis 0 of
    `data` (a (list of) NDArray/Symbol), carrying `states`.

    Returns (outputs, final_states) — outputs stacked along a new
    axis 0 (reference `sym.contrib.foreach`)."""
    data_list = _as_list(data)
    states = _as_list(init_states)
    data_is_list = isinstance(data, (list, tuple))
    states_is_list = isinstance(init_states, (list, tuple))

    if data_list and _is_symbol(data_list[0]):
        return _foreach_sym(body, data_list, states, data_is_list,
                            states_is_list, name)

    # imperative: a Python loop that autograd records
    from .ndarray import stack

    n = data_list[0].shape[0]
    outs_steps = None
    single_out = False
    for t in range(n):
        xs = [d[t] for d in data_list]
        out, states = body(xs if data_is_list else xs[0],
                           states if states_is_list else states[0])
        states = _as_list(states)
        single_out = not isinstance(out, (list, tuple))
        out = _as_list(out)
        if outs_steps is None:
            outs_steps = [[] for _ in out]
        for slot, o in zip(outs_steps, out):
            slot.append(o)
    outs = [stack(*slot, axis=0) for slot in (outs_steps or [])]
    return (outs[0] if single_out else outs,
            states if states_is_list else states[0])


def _foreach_sym(body, data_list, states, data_is_list, states_is_list,
                 name):
    from .symbol.symbol import Variable
    from .symbol import Group

    data_vars = [Variable("_cf_%s_data%d" % (name, i))
                 for i in range(len(data_list))]
    state_vars = [Variable("_cf_%s_state%d" % (name, i))
                  for i in range(len(states))]
    out, new_states = body(
        data_vars if data_is_list else data_vars[0],
        state_vars if states_is_list else state_vars[0])
    single_out = not isinstance(out, (list, tuple))
    outs = _as_list(out)
    new_states = _as_list(new_states)
    if len(new_states) != len(states):
        raise MXNetError("foreach body returned %d states, expected %d"
                         % (len(new_states), len(states)))
    subgraph = Group(outs + new_states)

    ph_names = [v.name for v in data_vars] + [v.name for v in state_vars]
    sub_args, ph_locs, free_names, free_locs, aux_names = \
        _sub_io(subgraph, ph_names)
    nd_ = len(data_vars)
    data_locs = ph_locs[:nd_]
    state_locs = ph_locs[nd_:]
    if any(l < 0 for l in data_locs):
        raise MXNetError("foreach body must use the data argument")

    # the op aligns the scan carry with the state list positionally, so
    # every state var must appear in the subgraph
    if any(l < 0 for l in state_locs):
        raise MXNetError("every foreach state must be used by the body "
                         "(unused states: pass them through explicitly)")
    inputs = (data_list + list(states)
              + _outer_vars(free_names, aux_names)
              + _outer_vars(aux_names, aux_names))
    attrs = dict(subgraph=subgraph, sub_args=tuple(sub_args),
                 sub_aux=tuple(aux_names),
                 data_locs=tuple(data_locs),
                 state_locs=tuple(state_locs),
                 free_locs=tuple(free_locs),
                 num_out_data=len(outs), num_states=len(new_states))
    node = _node("_foreach", inputs, attrs, name)
    out_syms = [node[i] for i in range(len(outs))]
    st_syms = [node[len(outs) + i] for i in range(len(new_states))]
    return (out_syms[0] if single_out else out_syms,
            st_syms if states_is_list else st_syms[0])


# ---------------------------------------------------------------------------
# while_loop
# ---------------------------------------------------------------------------

def while_loop(cond: Callable, func: Callable, loop_vars,
               max_iterations: int, name: str = "while_loop"):
    """`while cond(*loop_vars): step_out, loop_vars = func(*loop_vars)`
    bounded by max_iterations; step outputs are stacked into
    (max_iterations, ...) buffers, rows past the trip count zero
    (reference `sym.contrib.while_loop` semantics).

    Returns (outputs, final_loop_vars)."""
    lv = _as_list(loop_vars)
    if lv and _is_symbol(lv[0]):
        return _while_loop_sym(cond, func, lv, max_iterations, name)

    import numpy as np

    from .ndarray import stack, zeros

    outs_steps = None
    single_out = False
    n_iter = 0
    vars_ = lv
    while n_iter < max_iterations and \
            bool(np.asarray(cond(*vars_).asnumpy()).reshape(())):
        out, vars_ = func(*vars_)
        vars_ = _as_list(vars_)
        single_out = not isinstance(out, (list, tuple))
        out = _as_list(out)
        if outs_steps is None:
            outs_steps = [[] for _ in out]
        for slot, o in zip(outs_steps, out):
            slot.append(o)
        n_iter += 1
    if outs_steps is None:
        # zero iterations: probe shapes with one (discarded) func call
        out, _ = func(*lv)
        single_out = not isinstance(out, (list, tuple))
        outs = [zeros((max_iterations,) + o.shape, ctx=o.ctx,
                      dtype=o.dtype) for o in _as_list(out)]
    else:
        outs = []
        for slot in outs_steps:
            stacked = stack(*slot, axis=0)
            if n_iter < max_iterations:
                pad = zeros((max_iterations - n_iter,) + slot[0].shape,
                            ctx=slot[0].ctx, dtype=slot[0].dtype)
                from .ndarray import concat

                stacked = concat(stacked, pad, dim=0)
            outs.append(stacked)
    return (outs[0] if single_out else outs, vars_)


def _while_loop_sym(cond, func, lv, max_iterations, name):
    from .symbol.symbol import Variable
    from .symbol import Group

    n_states = len(lv)
    cond_vars = [Variable("_cf_%s_cv%d" % (name, i))
                 for i in range(n_states)]
    body_vars = [Variable("_cf_%s_bv%d" % (name, i))
                 for i in range(n_states)]

    pred = cond(*cond_vars)
    cond_graph = Group([pred])
    out, new_vars = func(*body_vars)
    single_out = not isinstance(out, (list, tuple))
    outs = _as_list(out)
    new_vars = _as_list(new_vars)
    if len(new_vars) != n_states:
        raise MXNetError("while_loop func returned %d loop_vars, "
                         "expected %d" % (len(new_vars), n_states))
    body_graph = Group(outs + new_vars)

    cond_args, cond_ph, cfree_names, cfree_locs, caux = _sub_io(
        cond_graph, [v.name for v in cond_vars])
    body_args, body_ph, bfree_names, bfree_locs, baux = _sub_io(
        body_graph, [v.name for v in body_vars])
    if any(l < 0 for l in body_ph):
        raise MXNetError("every while_loop loop_var must be used by func")
    aux_names = list(dict.fromkeys(list(caux) + list(baux)))

    inputs = (list(lv) + _outer_vars(cfree_names, aux_names)
              + _outer_vars(bfree_names, aux_names)
              + _outer_vars(aux_names, aux_names))
    # cond may not read every loop var: cond_state_idx maps its used
    # placeholder slots back to loop-var positions
    used_cond_states = tuple(i for i, l in enumerate(cond_ph) if l >= 0)
    attrs = dict(cond_graph=cond_graph, cond_args=tuple(cond_args),
                 body_graph=body_graph, body_args=tuple(body_args),
                 sub_aux=tuple(aux_names),
                 state_locs_cond=tuple(cond_ph[i]
                                       for i in used_cond_states),
                 free_locs_cond=tuple(cfree_locs),
                 state_locs_body=tuple(body_ph),
                 free_locs_body=tuple(bfree_locs),
                 cond_state_idx=used_cond_states,
                 n_states=n_states, num_out_data=len(outs),
                 num_states=n_states,
                 max_iterations=int(max_iterations))
    node = _node("_while_loop", inputs, attrs, name)
    out_syms = [node[i] for i in range(len(outs))]
    st_syms = [node[len(outs) + i] for i in range(n_states)]
    return (out_syms[0] if single_out else out_syms, st_syms)


# ---------------------------------------------------------------------------
# cond
# ---------------------------------------------------------------------------

def cond(pred, then_func: Callable, else_func: Callable,
         name: str = "cond"):
    """`then_func() if pred else else_func()` — both branches must
    produce matching shapes/dtypes (reference `sym.contrib.cond`)."""
    if _is_symbol(pred):
        return _cond_sym(pred, then_func, else_func, name)

    import numpy as np

    branch = then_func if bool(
        np.asarray(pred.asnumpy()).reshape(())) else else_func
    return branch()


def _cond_sym(pred, then_func, else_func, name):
    from .symbol import Group

    then_out = then_func()
    single_out = not isinstance(then_out, (list, tuple))
    then_outs = _as_list(then_out)
    else_outs = _as_list(else_func())
    if len(then_outs) != len(else_outs):
        raise MXNetError("cond branches disagree on output count")
    then_graph = Group(then_outs)
    else_graph = Group(else_outs)

    then_args, _, tfree, tlocs, taux = _sub_io(then_graph, [])
    else_args, _, efree, elocs, eaux = _sub_io(else_graph, [])
    aux_names = list(dict.fromkeys(list(taux) + list(eaux)))

    inputs = ([pred] + _outer_vars(tfree, aux_names)
              + _outer_vars(efree, aux_names)
              + _outer_vars(aux_names, aux_names))
    attrs = dict(then_graph=then_graph, then_args=tuple(then_args),
                 else_graph=else_graph, else_args=tuple(else_args),
                 sub_aux=tuple(aux_names),
                 n_then_free=len(tfree),
                 num_outputs=len(then_outs))
    node = _node("_cond", inputs, attrs, name)
    outs = [node[i] for i in range(len(then_outs))]
    return outs[0] if single_out else outs


# ---------------------------------------------------------------------------
# Shape-inference metadata: free-variable (weight) shapes are solved by
# running the SUBGRAPH's own partial shape inference — the analog of the
# reference's subgraph infer-shape forwarding in control_flow.cc.
# ---------------------------------------------------------------------------

def _solve_subgraph(sub, sub_args, known, free_locs, base):
    try:
        arg_shapes, _, aux_shapes = sub.infer_shape_partial(**known)
    except Exception:
        return {}, []
    solved = {}
    for k, loc in enumerate(free_locs):
        if arg_shapes[loc] is not None:
            solved[base + k] = tuple(arg_shapes[loc])
    return solved, list(aux_shapes)


def _foreach_shapes(in_shapes, attrs):
    sub_args = list(attrs["sub_args"])
    data_locs = attrs["data_locs"]
    state_locs = attrs["state_locs"]
    free_locs = attrs["free_locs"]
    nd_, ns_, nf_ = len(data_locs), len(state_locs), len(free_locs)
    known = {}
    for i, loc in enumerate(data_locs):
        if in_shapes[i] is not None:
            known[sub_args[loc]] = tuple(in_shapes[i][1:])
    for j, loc in enumerate(state_locs):
        if in_shapes[nd_ + j] is not None:
            known[sub_args[loc]] = tuple(in_shapes[nd_ + j])
    solved, aux_shapes = _solve_subgraph(
        attrs["subgraph"], sub_args, known, free_locs, nd_ + ns_)
    for a, shp in enumerate(aux_shapes):
        if shp is not None:
            solved[nd_ + ns_ + nf_ + a] = tuple(shp)
    return solved


def _while_loop_shapes(in_shapes, attrs):
    ns_ = attrs["n_states"]
    cfree = attrs["free_locs_cond"]
    bfree = attrs["free_locs_body"]
    cidx = attrs.get("cond_state_idx")
    if cidx is None:
        cidx = tuple(range(ns_))
    known_c = {}
    for slot, loc in zip(cidx, attrs["state_locs_cond"]):
        if in_shapes[slot] is not None:
            known_c[attrs["cond_args"][loc]] = tuple(in_shapes[slot])
    known_b = {}
    for j, loc in enumerate(attrs["state_locs_body"]):
        if in_shapes[j] is not None:
            known_b[attrs["body_args"][loc]] = tuple(in_shapes[j])
    solved, _ = _solve_subgraph(attrs["cond_graph"], attrs["cond_args"],
                                known_c, cfree, ns_)
    s2, aux_shapes = _solve_subgraph(attrs["body_graph"],
                                     attrs["body_args"], known_b, bfree,
                                     ns_ + len(cfree))
    solved.update(s2)
    base = ns_ + len(cfree) + len(bfree)
    for a, shp in enumerate(aux_shapes):
        if shp is not None:
            solved[base + a] = tuple(shp)
    return solved


def _cond_shapes(in_shapes, attrs):
    ntf = attrs["n_then_free"]
    tfree = tuple(range(len(attrs["then_args"])))
    efree = tuple(range(len(attrs["else_args"])))
    solved, _ = _solve_subgraph(attrs["then_graph"], attrs["then_args"],
                                {}, tfree, 1)
    s2, aux_shapes = _solve_subgraph(attrs["else_graph"],
                                     attrs["else_args"], {}, efree,
                                     1 + ntf)
    solved.update(s2)
    base = 1 + ntf + len(efree)
    for a, shp in enumerate(aux_shapes):
        if shp is not None:
            solved[base + a] = tuple(shp)
    return solved
