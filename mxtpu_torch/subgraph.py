"""Subgraph partitioning of the PyTorch port: pluggable graph rewrites
over the Symbol (counterpart of ``mxtpu/subgraph.py``).

The contract is the JAX package's, after MXNet's subgraph framework:

* a ``SubgraphSelector`` grows a candidate region from a seed node
  (``select``, ``select_input``, ``select_output``, ``filter``);
* a ``SubgraphProperty`` turns an accepted region into a replacement
  graph (``create_subgraph_node``) and may rewrite the parameters
  (``transform_params``);
* ``partition_with_property`` drives the selection, refuses a region
  whose contraction would make a cycle (``_is_convex``) and rebuilds
  the graph; ``partition`` applies a backend registered by name
  (``register_backend``), and ``MXTPU_SUBGRAPH_BACKEND`` applies a
  parameter-free backend to every Symbol bound (``apply_bind_hook``,
  called by ``Symbol.bind``/``simple_bind``).

The default replacement wraps a region into one ``_subgraph_exec`` node
whose attribute holds the subgraph as JSON, so a wrapped region
survives ``save``/``load``; the op runs the subgraph node by node in
the executor's walk.  The built-in backend ``"TPU"``
(``ConvBNFoldProperty``, the JAX package's name, which scripts call)
folds an inference BatchNorm into the convolution before it, weights
and bias rewritten offline; the INT8 rewrite of
``mxtpu_torch.contrib.quantization`` rides the same framework with
one-node regions.
"""
from __future__ import annotations

import functools
import logging
import os
import threading
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from . import amp as _amp
from .base import MXNetError
from .ops.registry import invoke, register
from .symbol.op_meta import OpMeta, register_meta
from .symbol.symbol import Symbol, SymbolNode, _topo_order

__all__ = ["SubgraphSelector", "SubgraphProperty", "register_backend",
           "get_backend", "list_backends", "partition",
           "partition_with_property", "apply_bind_hook",
           "ConvBNFoldProperty"]


# ---------------------------------------------------------------------------
# Selector / property interfaces (reference subgraph_property.h)
# ---------------------------------------------------------------------------

class SubgraphSelector(object):
    """Grows one candidate region.  A fresh selector is created per seed
    (reference `SubgraphProperty::CreateSubgraphSelector`)."""

    def select(self, node: SymbolNode) -> bool:
        """Is `node` a seed for a new region?"""
        return False

    def select_input(self, node: SymbolNode, input_node: SymbolNode) -> bool:
        """May `input_node` (a producer feeding `node`, already in the
        region) join the region?"""
        return False

    def select_output(self, node: SymbolNode, output_node: SymbolNode) -> bool:
        """May `output_node` (a consumer of region node `node`) join?"""
        return False

    def filter(self, candidates: List[SymbolNode]) -> List[SymbolNode]:
        """Final say over the grown region (topo order). Return a subset
        (possibly empty to reject)."""
        return candidates


class SubgraphProperty(object):
    """One named graph-rewrite backend.

    Subclasses override `create_selector` and optionally
    `create_subgraph_node` / `filter_region` / `transform_params`.
    """

    #: whether `partition` must be given parameter dicts (passes that
    #: rewrite parameter VALUES, e.g. BN folding). Parameter-free
    #: backends are eligible for the MXTPU_SUBGRAPH_BACKEND bind hook.
    needs_params = False

    def create_selector(self) -> SubgraphSelector:
        raise NotImplementedError

    def filter_region(self, region: List[SymbolNode],
                      consumers: Dict[int, List[Tuple[SymbolNode, int]]],
                      head_ids: set) -> List[SymbolNode]:
        """Structural veto with graph context (consumer map, head set).
        Runs after the selector's own `filter`."""
        return region

    def create_subgraph_node(self, sub_sym: Symbol,
                             region: List[SymbolNode],
                             input_names: List[str],
                             subgraph_id: int) -> Optional[Symbol]:
        """Build the replacement graph.

        `sub_sym`'s variable inputs are placeholders named
        `input_names`; the returned Symbol must (a) produce exactly
        ``len(sub_sym._outputs)`` outputs matching the region's external
        outputs in order, and (b) reference external values ONLY through
        variables named in `input_names` (other variables become new
        graph parameters).  Return None to leave the region unchanged.

        Default: wrap into a `_subgraph_exec` node carrying the
        subgraph as JSON (reference `CreateSubgraphNode` builds a node
        whose attrs hold the packed subgraph the same way).
        """
        from .symbol.register import invoke_symbol
        from .symbol.symbol import Variable

        # the op binds values to subgraph variables in the
        # subgraph's list_inputs() (topo) order, which can be a
        # permutation of the region-discovery order in `input_names`
        placeholders = [Variable(n) for n in sub_sym.list_inputs()]
        n_out = len(sub_sym._outputs)
        return invoke_symbol(
            "_subgraph_exec", placeholders,
            {"subgraph_json": sub_sym.tojson(), "n_out": n_out},
            name="sg%d_%s" % (subgraph_id, self.__class__.__name__.lower()))

    def transform_params(self, applied: List[Dict[str, Any]],
                         arg_params: Dict[str, Any],
                         aux_params: Dict[str, Any]):
        """Rewrite parameter dicts for the partitioned graph. `applied`
        holds one record per replaced region: {"region": [...nodes],
        "replacement": Symbol, "id": int}. Returns (args, aux)."""
        return arg_params, aux_params


# ---------------------------------------------------------------------------
# Backend registry (reference: SubgraphPropertyRegistry +
# MXNET_SUBGRAPH_BACKEND)
# ---------------------------------------------------------------------------

_BACKENDS: Dict[str, Callable[[], SubgraphProperty]] = {}
_bind_hook_tls = threading.local()


def register_backend(name: str, factory: Callable[[], SubgraphProperty]):
    if name in _BACKENDS:
        raise MXNetError("subgraph backend %r already registered" % name)
    _BACKENDS[name] = factory


def get_backend(name: str) -> SubgraphProperty:
    try:
        return _BACKENDS[name]()
    except KeyError:
        raise MXNetError(
            "unknown subgraph backend %r (registered: %s)"
            % (name, sorted(_BACKENDS))) from None


def list_backends() -> List[str]:
    return sorted(_BACKENDS)


# ---------------------------------------------------------------------------
# The generic wrapped-subgraph executor op
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=256)
def _parse_subgraph(js: str) -> Symbol:
    from .symbol.symbol import load_json

    return load_json(js)


@register("_subgraph_exec",
          num_outputs=lambda attrs: int(attrs.get("n_out", 1)),
          needs_rng=True, train_aware=True)
def _subgraph_exec(gen, *inputs, subgraph_json="", n_out=1, is_train=False):
    """Run a packed subgraph node by node, its inputs in the subgraph's
    ``list_inputs()`` order.  Aux states inside it are read, never
    updated (a wrapped region is for inference or stateless); the
    current AMP policy casts each inner node's inputs as the executor
    casts the outer ones; random nodes draw from ``gen`` in turn."""
    sym = _parse_subgraph(subgraph_json)
    names = sym.list_inputs()
    if len(names) != len(inputs):
        raise MXNetError("_subgraph_exec: %d inputs for %d subgraph vars"
                         % (len(inputs), len(names)))
    env: Dict[Tuple[int, int], Any] = {}
    by_name = dict(zip(names, inputs))
    compute_dtype = _amp.get_compute_dtype()
    for node in _topo_order(sym._outputs):
        if node.is_variable:
            env[(id(node), 0)] = by_name[node.name]
            continue
        invals = [env[(id(inode), idx)] for inode, idx in node.inputs]
        if compute_dtype is not None:
            invals = _amp.cast_op_inputs(node.op.name, invals,
                                         compute_dtype)
        attrs = dict(node.attrs)
        if node.op.train_aware:
            attrs["is_train"] = is_train
        if not invals:
            attrs["device"] = inputs[0].device if inputs else None
        out = invoke(node.op, invals, attrs,
                     gen if node.op.needs_rng else None)
        for i, o in enumerate(out):
            env[(id(node), i)] = o
    outs = tuple(env[(id(n), i)] for n, i in sym._outputs)
    return outs if len(outs) > 1 else outs[0]


def _subgraph_input_names(attrs):
    return _parse_subgraph(attrs["subgraph_json"]).list_inputs()


def _subgraph_param_shapes(shapes, attrs):
    """Shapes solved backward through the packed subgraph: its own
    partial inference from the outer shapes known, so that a parameter
    auto-created inside a wrapped region still binds."""
    from .symbol.symbol import _infer_graph

    sub = _parse_subgraph(attrs["subgraph_json"])
    names = sub.list_inputs()
    known = {n: tuple(s) for n, s in zip(names, shapes) if s is not None}
    try:
        solved, _ = _infer_graph(sub, known, partial=True)
    except Exception:
        return {}
    out = {}
    for i, n in enumerate(names):
        if shapes[i] is None and solved.get(n) is not None:
            out[i] = tuple(solved[n])
    return out


def _subgraph_forward(in_shapes, in_dtypes, attrs):
    """The output shapes and dtypes of a ``_subgraph_exec`` node: its
    subgraph's inference (a ``Custom`` inside it cannot run on meta
    tensors)."""
    from .symbol.symbol import _infer_graph

    sub = _parse_subgraph(attrs["subgraph_json"])
    names = sub.list_inputs()
    shapes, dtypes = _infer_graph(
        sub, dict(zip(names, map(tuple, in_shapes))),
        known_dtypes=dict(zip(names, in_dtypes)))

    def key(n, i):
        return n.name if n.is_variable else ("out", id(n), i)

    return ([shapes[key(n, i)] for n, i in sub._outputs],
            [dtypes[key(n, i)] for n, i in sub._outputs])


register_meta("_subgraph_exec", OpMeta(_subgraph_input_names,
                                       param_shapes=_subgraph_param_shapes,
                                       forward=_subgraph_forward))


# ---------------------------------------------------------------------------
# Partitioning (reference partition_graph.cc BuildSubgraph)
# ---------------------------------------------------------------------------

def _consumer_map(nodes: Sequence[SymbolNode]):
    cons: Dict[int, List[Tuple[SymbolNode, int]]] = {}
    for n in nodes:
        if n.is_variable:
            continue
        for (src, idx) in n.inputs:
            cons.setdefault(id(src), []).append((n, idx))
    return cons


def _grow_region(seed: SymbolNode, selector: SubgraphSelector,
                 consumers, claimed: set) -> List[SymbolNode]:
    region = [seed]
    rset = {id(seed)}
    changed = True
    while changed:
        changed = False
        for n in list(region):
            for (src, _idx) in n.inputs:
                if src.is_variable or id(src) in rset or id(src) in claimed:
                    continue
                if selector.select_input(n, src):
                    region.append(src)
                    rset.add(id(src))
                    changed = True
            for (c, _idx) in consumers.get(id(n), ()):
                if id(c) in rset or id(c) in claimed:
                    continue
                if selector.select_output(n, c):
                    region.append(c)
                    rset.add(id(c))
                    changed = True
    return region


def _is_convex(region_ids: set, region: List[SymbolNode], consumers) -> bool:
    """Contracting `region` must not create a cycle: no external
    descendant of the region may feed back into it."""
    ext_desc: set = set()
    stack = []
    for n in region:
        for (c, _i) in consumers.get(id(n), ()):
            if id(c) not in region_ids:
                stack.append(c)
    while stack:
        node = stack.pop()
        if id(node) in ext_desc:
            continue
        ext_desc.add(id(node))
        for (c, _i) in consumers.get(id(node), ()):
            if id(c) not in region_ids and id(c) not in ext_desc:
                stack.append(c)
    for n in region:
        for (src, _i) in n.inputs:
            if id(src) in ext_desc:
                return False
    return True


def _entry_name(src: SymbolNode, idx: int) -> str:
    if src.is_variable:
        return src.name
    if src.num_outputs() == 1:
        return src.name + "_output"
    return "%s_output%d" % (src.name, idx)


def partition_with_property(sym: Symbol, prop: SubgraphProperty,
                            arg_params: Optional[Dict[str, Any]] = None,
                            aux_params: Optional[Dict[str, Any]] = None):
    """Apply one property to `sym`. Returns (new_sym, args, aux) when
    params were given, else new_sym."""
    nodes = sym._topo()
    consumers = _consumer_map(nodes)
    head_ids = {id(n) for n, _ in sym._outputs}
    claimed: set = set()
    regions: List[List[SymbolNode]] = []
    node_pos = {id(n): i for i, n in enumerate(nodes)}

    for node in nodes:
        if node.is_variable or id(node) in claimed:
            continue
        selector = prop.create_selector()
        if not selector.select(node):
            continue
        region = _grow_region(node, selector, consumers, claimed)
        region.sort(key=lambda n: node_pos[id(n)])
        region = selector.filter(region)
        if region:
            region = prop.filter_region(region, consumers, head_ids)
        if not region:
            continue
        rset = {id(n) for n in region}
        if not _is_convex(rset, region, consumers):
            continue
        regions.append(region)
        claimed |= rset

    if not regions:
        if arg_params is not None or aux_params is not None:
            return sym, dict(arg_params or {}), dict(aux_params or {})
        return sym

    region_of: Dict[int, int] = {}
    for ri, region in enumerate(regions):
        for n in region:
            region_of[id(n)] = ri

    # per-region external inputs / outputs (stable order)
    region_inputs: List[List[Tuple[SymbolNode, int]]] = []
    region_outputs: List[List[Tuple[SymbolNode, int]]] = []
    for ri, region in enumerate(regions):
        rset = {id(n) for n in region}
        ins: List[Tuple[SymbolNode, int]] = []
        seen_in = set()
        outs: List[Tuple[SymbolNode, int]] = []
        seen_out = set()
        for n in region:
            for e in n.inputs:
                if id(e[0]) in rset:
                    continue
                k = (id(e[0]), e[1])
                if k not in seen_in:
                    seen_in.add(k)
                    ins.append(e)
            for (c, _i) in consumers.get(id(n), ()):
                if id(c) in rset:
                    continue
                for (src, idx) in c.inputs:
                    if id(src) == id(n):
                        k = (id(src), idx)
                        if k not in seen_out:
                            seen_out.add(k)
                            outs.append((src, idx))
            if id(n) in head_ids:
                for (hn, hi) in sym._outputs:
                    if id(hn) == id(n):
                        k = (id(hn), hi)
                        if k not in seen_out:
                            seen_out.add(k)
                            outs.append((hn, hi))
        region_inputs.append(ins)
        region_outputs.append(outs)

    entry_map: Dict[Tuple[int, int], Tuple[SymbolNode, int]] = {}
    cloned: Dict[int, SymbolNode] = {}
    applied: List[Dict[str, Any]] = []
    instantiating: set = set()

    def clone_plain(node: SymbolNode) -> SymbolNode:
        if id(node) in cloned:
            return cloned[id(node)]
        if node.is_variable:
            new = SymbolNode(None, node.name, {}, [], is_aux=node.is_aux)
            new.ext_attrs = dict(node.ext_attrs)
            cloned[id(node)] = new
            return new
        new_inputs = [map_entry(e) for e in node.inputs]
        new = SymbolNode(node.op, node.name, dict(node.attrs), new_inputs)
        new.ext_attrs = dict(node.ext_attrs)
        cloned[id(node)] = new
        return new

    def map_entry(entry: Tuple[SymbolNode, int]) -> Tuple[SymbolNode, int]:
        node, idx = entry
        key = (id(node), idx)
        if key in entry_map:
            return entry_map[key]
        ri = region_of.get(id(node))
        if ri is None:
            new = clone_plain(node)
            mapped = (new, idx)
            entry_map[key] = mapped
            return mapped
        instantiate_region(ri)
        if key not in entry_map:
            raise MXNetError(
                "subgraph replacement for region %d did not produce "
                "output %s[%d]" % (ri, node.name, idx))
        return entry_map[key]

    def instantiate_region(ri: int):
        if ri in instantiating:
            raise MXNetError("cycle while instantiating subgraph region %d "
                             "(property %s broke convexity)"
                             % (ri, type(prop).__name__))
        if any((id(n), i) in entry_map
               for (n, i) in region_outputs[ri]):
            return
        instantiating.add(ri)
        region = regions[ri]
        ins = region_inputs[ri]
        outs = region_outputs[ri]
        # build the subgraph symbol over placeholder variables
        input_names = []
        ph_nodes: Dict[Tuple[int, int], SymbolNode] = {}
        used = set()
        for (src, idx) in ins:
            nm = _entry_name(src, idx)
            while nm in used:
                nm += "_"
            used.add(nm)
            input_names.append(nm)
            ph = SymbolNode(None, nm, {}, [], is_aux=src.is_aux)
            if src.is_variable:
                ph.ext_attrs = dict(src.ext_attrs)
            ph_nodes[(id(src), idx)] = ph
        sub_cloned: Dict[int, SymbolNode] = {}

        def sub_clone(entry):
            node, idx = entry
            k = (id(node), idx)
            if k in ph_nodes:
                return (ph_nodes[k], 0)
            if id(node) in sub_cloned:
                return (sub_cloned[id(node)], idx)
            new = SymbolNode(node.op, node.name, dict(node.attrs),
                             [sub_clone(e) for e in node.inputs])
            new.ext_attrs = dict(node.ext_attrs)
            sub_cloned[id(node)] = new
            return (new, idx)

        sub_sym = Symbol([sub_clone(e) for e in outs])
        replacement = prop.create_subgraph_node(sub_sym, region,
                                                input_names, ri)
        if replacement is None:
            # leave the region as-is: clone its nodes plainly
            for n in region:
                for i in range(n.num_outputs()):
                    k = (id(n), i)
                    if k not in entry_map:
                        new = clone_plain_region_node(n, ri)
                        entry_map[k] = (new, i)
            instantiating.discard(ri)
            return
        if len(replacement._outputs) != len(outs):
            raise MXNetError(
                "replacement for region %d has %d outputs, region has %d"
                % (ri, len(replacement._outputs), len(outs)))
        # graft the replacement: substitute placeholder variables with
        # the mapped external entries; other variables become new params
        ph_by_name = {nm: map_entry(e) for nm, e in zip(input_names, ins)}
        graft_memo: Dict[int, SymbolNode] = {}

        def graft(entry):
            node, idx = entry
            if node.is_variable and node.name in ph_by_name:
                return ph_by_name[node.name]
            if id(node) in graft_memo:
                return (graft_memo[id(node)], idx)
            if node.is_variable:
                new = SymbolNode(None, node.name, {}, [],
                                 is_aux=node.is_aux)
                new.ext_attrs = dict(node.ext_attrs)
            else:
                new = SymbolNode(node.op, node.name, dict(node.attrs),
                                 [graft(e) for e in node.inputs])
                new.ext_attrs = dict(node.ext_attrs)
            graft_memo[id(node)] = new
            return (new, idx)

        for (src_entry, rep_entry) in zip(outs, replacement._outputs):
            entry_map[(id(src_entry[0]), src_entry[1])] = graft(rep_entry)
        applied.append({"region": region, "replacement": replacement,
                        "id": ri, "input_names": input_names})
        instantiating.discard(ri)

    def clone_plain_region_node(node: SymbolNode, ri: int) -> SymbolNode:
        if id(node) in cloned:
            return cloned[id(node)]
        new_inputs = []
        for e in node.inputs:
            if region_of.get(id(e[0])) == ri:
                inner = clone_plain_region_node(e[0], ri)
                new_inputs.append((inner, e[1]))
            else:
                new_inputs.append(map_entry(e))
        new = SymbolNode(node.op, node.name, dict(node.attrs), new_inputs)
        new.ext_attrs = dict(node.ext_attrs)
        cloned[id(node)] = new
        return new

    new_sym = Symbol([map_entry(e) for e in sym._outputs])

    if arg_params is not None or aux_params is not None:
        args = dict(arg_params or {})
        aux = dict(aux_params or {})
        args, aux = prop.transform_params(applied, args, aux)
        keep_args = set(new_sym.list_arguments())
        keep_aux = set(new_sym.list_auxiliary_states())
        args = {k: v for k, v in args.items() if k in keep_args}
        aux = {k: v for k, v in aux.items() if k in keep_aux}
        return new_sym, args, aux
    return new_sym


def partition(sym: Symbol, backend: str,
              arg_params: Optional[Dict[str, Any]] = None,
              aux_params: Optional[Dict[str, Any]] = None):
    """Apply the named backend (reference: `partition_graph.cc` driven
    by `MXNET_SUBGRAPH_BACKEND` / `Symbol.optimize_for`)."""
    prop = get_backend(backend)
    if prop.needs_params and arg_params is None:
        raise MXNetError(
            "subgraph backend %r rewrites parameter values; call with "
            "arg_params/aux_params (e.g. sym.optimize_for(%r, args, aux))"
            % (backend, backend))
    return partition_with_property(sym, prop, arg_params, aux_params)


def apply_bind_hook(sym: Symbol) -> Symbol:
    """Bind-time hook: MXTPU_SUBGRAPH_BACKEND applies a parameter-free
    backend to every bound Symbol (reference MXNET_SUBGRAPH_BACKEND,
    `graph_executor.cc` init).  Param-rewriting backends are skipped
    with a warning — they need `Symbol.optimize_for`."""
    name = os.environ.get("MXTPU_SUBGRAPH_BACKEND", "")
    if not name:
        return sym
    if getattr(_bind_hook_tls, "active", False):
        return sym  # re-entrant bind (e.g. calibration) — already applied
    if name not in _BACKENDS:
        logging.getLogger(__name__).warning(
            "MXTPU_SUBGRAPH_BACKEND=%r is not a registered backend %s",
            name, sorted(_BACKENDS))
        return sym
    prop = get_backend(name)
    if prop.needs_params:
        logging.getLogger(__name__).warning(
            "MXTPU_SUBGRAPH_BACKEND=%r rewrites parameters; use "
            "Symbol.optimize_for instead — skipping bind-time partition",
            name)
        return sym
    _bind_hook_tls.active = True
    try:
        return partition_with_property(sym, prop)
    finally:
        _bind_hook_tls.active = False


# ---------------------------------------------------------------------------
# Built-in backend "TPU": fold inference BatchNorm into Convolution
# ---------------------------------------------------------------------------

class _ConvBNSelector(SubgraphSelector):
    def select(self, node):
        return (not node.is_variable) and node.op.name == "Convolution"

    def select_output(self, node, output_node):
        return (node.op.name == "Convolution"
                and not output_node.is_variable
                and output_node.op.name == "BatchNorm")


class ConvBNFoldProperty(SubgraphProperty):
    """Inference-time Conv+BN fold (the useful half of the reference's
    MKLDNN conv fusion, `src/operator/subgraph/mkldnn/mkldnn_conv.cc`):

        y = gamma * (conv(x, W) + b - mean) / sqrt(var + eps) + beta
          = conv(x, W * s) + (b - mean) * s + beta,   s = gamma / sqrt(var+eps)

    The BatchNorm node disappears; the convolution's weight/bias are
    rewritten offline by `transform_params`.  Valid only for inference
    semantics (moving statistics) — training graphs keep their BN.
    """

    needs_params = True

    def create_selector(self):
        return _ConvBNSelector()

    def filter_region(self, region, consumers, head_ids):
        if len(region) != 2:
            return []
        conv, bn = region
        if conv.op.name != "Convolution" or bn.op.name != "BatchNorm":
            return []
        # BN must consume the conv's output 0 as data
        if not bn.inputs or id(bn.inputs[0][0]) != id(conv):
            return []
        # channel axis must be the conv's feature axis
        if int(bn.attrs.get("axis", 1)) != 1:
            return []
        if bn.attrs.get("output_mean_var"):
            return []
        # the conv output must feed ONLY this BN (folding changes it)
        cons = consumers.get(id(conv), [])
        if len(cons) != 1 or id(conv) in head_ids:
            return []
        # external consumers may only use BN output 0
        for (c, _i) in consumers.get(id(bn), ()):
            for (src, idx) in c.inputs:
                if id(src) == id(bn) and idx != 0:
                    return []
        # all BN params + conv weight must be variables we can rewrite
        for (src, _i) in bn.inputs[1:]:
            if not src.is_variable:
                return []
        if len(conv.inputs) < 2 or not conv.inputs[1][0].is_variable:
            return []
        if not conv.attrs.get("no_bias", False):
            if len(conv.inputs) < 3 or not conv.inputs[2][0].is_variable:
                return []
        return region

    def create_subgraph_node(self, sub_sym, region, input_names, sid):
        from .symbol.register import invoke_symbol
        from .symbol.symbol import Variable

        conv, bn = region
        attrs = dict(conv.attrs)
        no_bias = attrs.get("no_bias", False)
        attrs["no_bias"] = False
        wname = conv.inputs[1][0].name
        bname = (conv.inputs[2][0].name if not no_bias
                 and len(conv.inputs) >= 3 else conv.name + "_folded_bias")
        data_ph = Variable(input_names[0])
        out = invoke_symbol("Convolution",
                            [data_ph, Variable(wname), Variable(bname)],
                            attrs, name=conv.name)
        return out

    def transform_params(self, applied, arg_params, aux_params):
        for rec in applied:
            conv, bn = rec["region"]
            wname = conv.inputs[1][0].name
            no_bias = conv.attrs.get("no_bias", False)
            bname = (conv.inputs[2][0].name if not no_bias
                     and len(conv.inputs) >= 3
                     else conv.name + "_folded_bias")
            gname, bename = bn.inputs[1][0].name, bn.inputs[2][0].name
            mname, vname = bn.inputs[3][0].name, bn.inputs[4][0].name
            eps = float(bn.attrs.get("eps", 1e-3))
            fix_gamma = bool(bn.attrs.get("fix_gamma", True))

            def host(d, n):
                v = d[n]
                return v.asnumpy() if hasattr(v, "asnumpy") else np.asarray(v)

            W = host(arg_params, wname)
            mean = host(aux_params if mname in aux_params else arg_params,
                        mname)
            var = host(aux_params if vname in aux_params else arg_params,
                       vname)
            beta = host(arg_params, bename)
            gamma = (np.ones_like(beta) if fix_gamma
                     else host(arg_params, gname))
            b = (np.zeros(W.shape[0], W.dtype) if no_bias
                 else host(arg_params, bname))
            s = gamma / np.sqrt(var + eps)
            Wf = W * s.reshape((-1,) + (1,) * (W.ndim - 1))
            bf = (b - mean) * s + beta
            from .ndarray.ndarray import array as nd_array

            ctx = getattr(arg_params[wname], "ctx", None)
            arg_params[wname] = nd_array(Wf.astype(W.dtype), ctx=ctx)
            arg_params[bname] = nd_array(bf.astype(W.dtype), ctx=ctx)
            for gone in (gname, bename):
                arg_params.pop(gone, None)
            for gone in (mname, vname):
                aux_params.pop(gone, None)
                arg_params.pop(gone, None)
        return arg_params, aux_params


register_backend("TPU", ConvBNFoldProperty)
