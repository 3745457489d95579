"""Symbol of the PyTorch port: the declarative graph.

Counterpart of ``mxtpu/symbol/symbol.py``.  A Symbol is a small host-side
DAG of op nodes: ``Variable``, composition by the ``sym.*`` functions and
``__call__``, the graph queries (``list_arguments``,
``list_auxiliary_states``, ``list_outputs``, ``get_internals``),
arithmetic (``+ - * /``, unary minus, ``>``), ``infer_shape`` and
``infer_shape_partial``, ``tojson``/``load_json`` in the JAX package's format
(attrs are JSON-encoded strings: ``"kernel": "[3, 3]"``), and
``simple_bind``/``bind`` to an :class:`mxtpu_torch.executor.Executor`.

Shape inference solves parameter shapes backward from the data shape
(``op_meta``) and forward shapes by running each op on ``meta``
tensors, where the JAX package runs ``jax.eval_shape``.  The graph
passes, subgraph backends and ``group2ctx`` placement are not ported.
"""
from __future__ import annotations

import ast
import json
import os
import tempfile
import threading
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..base import MXNetError, np_dtype, torch_dtype
from ..ops.registry import OpDef, get_op
from . import op_meta as _meta_mod

__all__ = ["Symbol", "Variable", "var", "Group", "load", "load_json",
           "NameManager"]


class NameManager(object):
    """Auto-naming of anonymous ops (``fullyconnected0``...)."""

    _current = threading.local()

    def __init__(self):
        self._counter: Dict[str, int] = {}

    def get(self, name: Optional[str], hint: str) -> str:
        if name:
            return name
        idx = self._counter.get(hint, 0)
        self._counter[hint] = idx + 1
        return "%s%d" % (hint, idx)

    @classmethod
    def current(cls) -> "NameManager":
        if getattr(cls._current, "value", None) is None:
            cls._current.value = NameManager()
        return cls._current.value

    def __enter__(self):
        self._old = NameManager.current()
        NameManager._current.value = self
        return self

    def __exit__(self, *args):
        NameManager._current.value = self._old


class SymbolNode(object):
    __slots__ = ("op", "name", "attrs", "inputs", "is_aux", "ext_attrs",
                 "__weakref__")

    def __init__(self, op: Optional[OpDef], name: str, attrs: Dict[str, Any],
                 inputs: List[Tuple["SymbolNode", int]], is_aux: bool = False):
        self.op = op
        self.name = name
        self.attrs = attrs
        self.inputs = inputs
        self.is_aux = is_aux
        self.ext_attrs: Dict[str, str] = {}

    @property
    def is_variable(self) -> bool:
        return self.op is None

    def num_outputs(self) -> int:
        return 1 if self.op is None else self.op.n_outputs(self.attrs)


def _topo_order(out_entries) -> List[SymbolNode]:
    order: List[SymbolNode] = []
    seen = set()
    stack = [(e[0], False) for e in reversed(out_entries)]
    while stack:
        node, processed = stack.pop()
        if processed:
            order.append(node)
            continue
        if id(node) in seen:
            continue
        seen.add(id(node))
        stack.append((node, True))
        for (inode, _) in reversed(node.inputs):
            if id(inode) not in seen:
                stack.append((inode, False))
    return order


def _node_attrs(node) -> Dict[str, str]:
    d = {k: str(v) for k, v in node.attrs.items()}
    d.update(node.ext_attrs)
    return d


class Symbol(object):
    """Immutable handle to one or more output entries of the graph."""

    __slots__ = ("_outputs",)

    def __init__(self, outputs: Sequence[Tuple[SymbolNode, int]]):
        self._outputs = list(outputs)

    # -- identity ---------------------------------------------------------
    @property
    def name(self) -> str:
        if len(self._outputs) == 1:
            return self._outputs[0][0].name
        return "grouped"

    def __repr__(self):
        return "<Symbol %s>" % ", ".join(
            "%s[%d]" % (n.name, i) for n, i in self._outputs)

    def __len__(self):
        return len(self._outputs)

    def __iter__(self):
        for i in range(len(self)):
            yield self[i]

    def __getitem__(self, index):
        if isinstance(index, str):
            names = self.list_outputs()
            if index not in names:
                raise MXNetError("output %r not found" % index)
            index = names.index(index)
        if isinstance(index, int):
            if index >= len(self._outputs):
                raise MXNetError("output index out of range")
            return Symbol([self._outputs[index]])
        raise TypeError("bad index %r" % (index,))

    # -- graph queries ----------------------------------------------------
    def _topo(self) -> List[SymbolNode]:
        return _topo_order(self._outputs)

    def list_arguments(self) -> List[str]:
        return [n.name for n in self._topo() if n.is_variable and not n.is_aux]

    def list_auxiliary_states(self) -> List[str]:
        return [n.name for n in self._topo() if n.is_variable and n.is_aux]

    def list_outputs(self) -> List[str]:
        names = []
        for node, idx in self._outputs:
            if node.is_variable:
                names.append(node.name)
            elif node.op.n_visible_outputs(node.attrs) == 1:
                names.append(node.name + "_output")
            else:
                names.append("%s_output%d" % (node.name, idx))
        return names

    def list_inputs(self) -> List[str]:
        return [n.name for n in self._topo() if n.is_variable]

    def get_internals(self) -> "Symbol":
        return Symbol([(node, i) for node in self._topo()
                       for i in range(node.num_outputs())])

    # -- attrs ------------------------------------------------------------
    def attr_dict(self) -> Dict[str, Dict[str, str]]:
        out = {}
        for node in self._topo():
            d = _node_attrs(node)
            if d:
                out[node.name] = d
        return out

    # -- shape inference ----------------------------------------------------
    def infer_shape(self, *args, **kwargs):
        """(argument, output, aux) shapes from the given argument
        shapes, by name or in ``list_arguments`` order."""
        return self._infer_shape_impl(False, *args, **kwargs)

    def infer_shape_partial(self, *args, **kwargs):
        """As ``infer_shape``, with None for what cannot be inferred."""
        return self._infer_shape_impl(True, *args, **kwargs)

    def _infer_shape_impl(self, partial, *args, **kwargs):
        arg_names = self.list_arguments()
        known: Dict[str, Tuple[int, ...]] = {}
        for name, shape in zip(arg_names, args):
            if shape is not None:
                known[name] = tuple(shape)
        known.update({k: tuple(v) for k, v in kwargs.items() if v is not None})
        shapes, _ = _infer_graph(self, known, partial)
        arg_shapes = [shapes.get(n) for n in arg_names]
        out_shapes = [shapes.get(node.name) if node.is_variable
                      else shapes.get(("out", id(node), idx))
                      for node, idx in self._outputs]
        aux_shapes = [shapes.get(n) for n in self.list_auxiliary_states()]
        if not partial and any(s is None for s in arg_shapes + out_shapes):
            missing = [n for n, s in zip(arg_names, arg_shapes) if s is None]
            raise MXNetError("infer_shape incomplete; unknown args: %s"
                             % missing)
        return arg_shapes, out_shapes, aux_shapes

    # -- composition ------------------------------------------------------
    def __call__(self, *args, **kwargs) -> "Symbol":
        """Substitute this symbol's variable inputs with other symbols."""
        mapping: Dict[str, Symbol] = dict(zip(self.list_inputs(), args))
        mapping.update(kwargs)
        if not mapping:
            return self
        for s in mapping.values():
            if len(s._outputs) != 1:
                raise MXNetError("can only compose with 1-output symbols")
        memo: Dict[int, Tuple[SymbolNode, Optional[int]]] = {}

        def clone_entry(entry):
            node, idx = entry
            if id(node) in memo:
                n, sub_idx = memo[id(node)]
                return (n, sub_idx if sub_idx is not None else idx)
            if node.is_variable and node.name in mapping:
                sub_entry = mapping[node.name]._outputs[0]
                memo[id(node)] = sub_entry
                return sub_entry
            new = SymbolNode(node.op, node.name, dict(node.attrs),
                             [clone_entry(e) for e in node.inputs],
                             is_aux=node.is_aux)
            new.ext_attrs = dict(node.ext_attrs)
            memo[id(node)] = (new, None)
            return (new, idx)

        return Symbol([clone_entry(e) for e in self._outputs])

    # -- arithmetic -------------------------------------------------------
    def _binary(self, other, op_name, scalar_op, rscalar_op=None,
                swap=False):
        from .register import invoke_symbol

        if isinstance(other, Symbol):
            a, b = (other, self) if swap else (self, other)
            return invoke_symbol(op_name, [a, b], {})
        if isinstance(other, (int, float, np.generic)):
            name = rscalar_op if (swap and rscalar_op) else scalar_op
            return invoke_symbol(name, [self], {"scalar": float(other)})
        return NotImplemented

    def __add__(self, other):
        return self._binary(other, "elemwise_add", "_plus_scalar")

    __radd__ = __add__

    def __sub__(self, other):
        return self._binary(other, "elemwise_sub", "_minus_scalar")

    def __rsub__(self, other):
        return self._binary(other, "elemwise_sub", "_minus_scalar",
                            "_rminus_scalar", swap=True)

    def __mul__(self, other):
        return self._binary(other, "elemwise_mul", "_mul_scalar")

    __rmul__ = __mul__

    def __truediv__(self, other):
        return self._binary(other, "elemwise_div", "_div_scalar")

    def __rtruediv__(self, other):
        return self._binary(other, "elemwise_div", "_div_scalar",
                            "_rdiv_scalar", swap=True)

    def __neg__(self):
        from .register import invoke_symbol

        return invoke_symbol("negative", [self], {})

    def __gt__(self, other):
        return self._binary(other, "_greater", "_greater_scalar")

    # -- serialization ----------------------------------------------------
    def tojson(self) -> str:
        nodes = self._topo()
        node_index = {id(n): i for i, n in enumerate(nodes)}
        jnodes = [{
            "op": "null" if n.is_variable else n.op.name,
            "name": n.name,
            "attrs": {k: json.dumps(_jsonable(v)) for k, v in n.attrs.items()},
            "ext_attrs": dict(n.ext_attrs),
            "inputs": [[node_index[id(i)], idx, 0] for i, idx in n.inputs],
            "is_aux": n.is_aux,
        } for n in nodes]
        heads = [[node_index[id(n)], idx, 0] for n, idx in self._outputs]
        arg_nodes = [i for i, n in enumerate(nodes) if n.is_variable]
        return json.dumps({"nodes": jnodes, "arg_nodes": arg_nodes,
                           "heads": heads,
                           "attrs": {"mxtpu_version": ["str", "0.1.0"]}},
                          indent=2)

    def save(self, fname: str):
        d = os.path.dirname(os.path.abspath(fname))
        fd, tmp = tempfile.mkstemp(dir=d, prefix=".tmp-")
        try:
            with os.fdopen(fd, "w") as f:
                f.write(self.tojson())
            os.replace(tmp, fname)
        except BaseException:
            os.unlink(tmp)
            raise

    # -- binding ------------------------------------------------------------
    def simple_bind(self, ctx=None, grad_req="write", type_dict=None,
                    **kwargs):
        """Bind with arrays made from the shapes in ``kwargs`` on
        ``ctx`` (default: the card)."""
        from ..executor import Executor

        return Executor._simple_bind(self, ctx, grad_req, type_dict, kwargs)

    def bind(self, ctx=None, args=None, args_grad=None, grad_req="write",
             aux_states=None):
        from ..executor import Executor

        return Executor._bind(self, ctx, args, args_grad, grad_req,
                              aux_states)

def _jsonable(v):
    if isinstance(v, np.dtype):
        return v.name
    if isinstance(v, tuple):
        return list(v)
    return v


def _unjson(v):
    if isinstance(v, list):
        return tuple(v)
    return v


def Variable(name: str, attr=None, shape=None, lr_mult=None, wd_mult=None,
             dtype=None, init=None, **kwargs) -> Symbol:
    """A variable symbol; ``attr`` entries and the lr_mult/wd_mult/init
    conveniences persist as node attributes."""
    node = SymbolNode(None, name, {}, [])
    if shape is not None:
        node.ext_attrs["__shape__"] = str(tuple(shape))
    if dtype is not None:
        node.ext_attrs["__dtype__"] = np_dtype(dtype).name
    if attr:
        node.ext_attrs.update({k: str(v) for k, v in attr.items()})
    if lr_mult is not None:
        node.ext_attrs["__lr_mult__"] = str(lr_mult)
    if wd_mult is not None:
        node.ext_attrs["__wd_mult__"] = str(wd_mult)
    if init is not None:
        node.ext_attrs["__init__"] = (init.dumps() if hasattr(init, "dumps")
                                      else str(init))
    return Symbol([(node, 0)])


var = Variable


def Group(symbols: Sequence[Symbol]) -> Symbol:
    return Symbol([e for s in symbols for e in s._outputs])


def load_json(json_str: str) -> Symbol:
    data = json.loads(json_str)
    nodes: List[SymbolNode] = []
    for jn in data["nodes"]:
        attrs = {k: _unjson(json.loads(v))
                 for k, v in jn.get("attrs", {}).items()}
        if jn["op"] == "null":
            node = SymbolNode(None, jn["name"], {}, [],
                              is_aux=jn.get("is_aux", False))
        else:
            inputs = [(nodes[i], idx) for i, idx, _ in jn["inputs"]]
            node = SymbolNode(get_op(jn["op"]), jn["name"], attrs, inputs)
        node.ext_attrs = dict(jn.get("ext_attrs", {}))
        nodes.append(node)
    return Symbol([(nodes[i], idx) for i, idx, _ in data["heads"]])


def load(fname: str) -> Symbol:
    with open(fname) as f:
        return load_json(f.read())


# ---------------------------------------------------------------------------
# Whole-graph shape inference: parameter shapes from op_meta, forward
# shapes from running each op on meta tensors
# ---------------------------------------------------------------------------

def _infer_graph(symbol: Symbol, known_shapes, partial=False):
    shapes: Dict[Any, Optional[Tuple[int, ...]]] = {}
    dtypes: Dict[Any, Any] = {}

    def var_shape(node):
        if node.name in known_shapes:
            return tuple(known_shapes[node.name])
        if "__shape__" in node.ext_attrs:
            return tuple(ast.literal_eval(node.ext_attrs["__shape__"]))
        return None

    def var_dtype(node):
        if "__dtype__" in node.ext_attrs:
            return np.dtype(node.ext_attrs["__dtype__"])
        return np.dtype(np.float32)

    def key(inode, idx):
        return inode.name if inode.is_variable else ("out", id(inode), idx)

    for node in symbol._topo():
        if node.is_variable:
            shapes[node.name] = var_shape(node)
            dtypes[node.name] = var_dtype(node)
            continue
        meta = _meta_mod.get_meta(node.op)
        in_shapes = [shapes.get(key(i, idx)) for i, idx in node.inputs]
        if meta.param_shapes is not None and any(s is None for s in in_shapes):
            solved = meta.param_shapes(in_shapes, node.attrs)
            for i, shp in (solved or {}).items():
                if i < len(node.inputs) and in_shapes[i] is None:
                    inode, _ = node.inputs[i]
                    if inode.is_variable and shapes.get(inode.name) is None:
                        shapes[inode.name] = tuple(shp)
                        in_shapes[i] = tuple(shp)
        if any(s is None for s in in_shapes):
            if partial:
                for i in range(node.num_outputs()):
                    shapes[("out", id(node), i)] = None
                continue
            missing = [node.inputs[i][0].name
                       for i, s in enumerate(in_shapes) if s is None]
            raise MXNetError("cannot infer shape for inputs %s of node %s"
                             % (missing, node.name))
        in_dtypes = [dtypes.get(key(i, idx), np.dtype(np.float32))
                     for i, idx in node.inputs]
        for i, (shp, dt) in enumerate(zip(*_eval_node_shape(
                node, in_shapes, in_dtypes))):
            shapes[("out", id(node), i)] = shp
            dtypes[("out", id(node), i)] = dt
    return shapes, dtypes


def _eval_node_shape(node: SymbolNode, in_shapes, in_dtypes):
    """The output shapes and dtypes of one node: its op run on meta
    tensors (no data, no device)."""
    from ..ops.registry import invoke

    attrs = dict(node.attrs)
    if node.op.train_aware:
        attrs.setdefault("is_train", False)
    if not in_shapes:
        attrs["device"] = torch.device("meta")
    ins = [torch.empty(s, dtype=torch_dtype(d), device="meta")
           for s, d in zip(in_shapes, in_dtypes)]
    with torch.no_grad():
        out = invoke(node.op, ins, attrs, None)
    from ..base import dtype_of_torch

    return [tuple(o.shape) for o in out], [dtype_of_torch(o.dtype)
                                           for o in out]
