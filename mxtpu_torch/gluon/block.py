"""Block, HybridBlock and SymbolBlock of the PyTorch port.

Counterpart of ``mxtpu/gluon/block.py``, with its user model: blocks
compose imperatively, each under a name scope that gives its
Parameters and traced nodes the reference's names (``resnetv10_``,
``stage1_``, ``conv0_weight``...); a HybridBlock's ``hybrid_forward``
runs on NDArrays (``F`` is ``nd``) or, traced with Symbol proxies, on
Symbols (``F`` is ``sym``), and after ``hybridize()`` the first call
traces the whole block once and runs the traced graph as one
:class:`mxtpu_torch.cached_op.CachedOp` from then on.  The traced JSON
equals the JAX package's for the same model built in the same order
(the name counters are per process, as there).

``forward_fused``, ``warmup``, the ``tune`` hook and ``summary``'s
visualisation are not ported (ROADMAP A10b, A17); ``summary`` prints
the plain per-block walk.
"""
from __future__ import annotations

import re
import threading
from collections import OrderedDict
from typing import Dict, List, Optional

import numpy as np

from ..base import MXNetError
from ..context import cpu, current_context
from ..ndarray.ndarray import NDArray
from .. import ndarray as nd_mod
from .. import symbol as sym_mod
from ..symbol.symbol import NameManager, Symbol
from ..cached_op import CachedOp
from .parameter import (Parameter, ParameterDict,
                        DeferredInitializationError)

__all__ = ["Block", "HybridBlock", "SymbolBlock"]


def _flatten(args, fmt_hint="input"):
    """Nested lists/tuples of arrays -> (flat list, format tree)."""
    if isinstance(args, (NDArray, Symbol)):
        return [args], 0
    if isinstance(args, (list, tuple)):
        flat, fmts = [], []
        for a in args:
            f, fmt = _flatten(a, fmt_hint)
            flat.extend(f)
            fmts.append(fmt)
        return flat, fmts
    if args is None:
        return [], -1
    raise MXNetError("cannot flatten argument of type %s in %s"
                     % (type(args), fmt_hint))


def _regroup(flat, fmt):
    """Inverse of _flatten: (structure, the rest of flat)."""
    if fmt == 0:
        return flat[0], flat[1:]
    if fmt == -1:
        return None, flat
    structure = []
    for f in fmt:
        item, flat = _regroup(flat, f)
        structure.append(item)
    return structure, flat


class _TraceNames(NameManager):
    """The NameManager of one block's trace: an anonymous op gets the
    block's prefix (``mlp_fc1_fullyconnected0``), its counter shared
    with the enclosing manager so that a block called twice still
    names its nodes apart; explicit names (Parameter variables, named
    ops) pass through."""

    def __init__(self, prefix):
        super().__init__()
        self._counter = NameManager.current()._counter
        self._prefix = prefix

    def get(self, name, hint):
        if name:
            return name
        return self._prefix + super().get(None, hint)


class _BlockScope(object):
    """The name scope of a block: children made inside it get prefixes
    counted per kind (``conv0_``, ``conv1_``...)."""

    _current = threading.local()

    def __init__(self, block):
        self._block = block
        self._counter = {}
        self._old_scope = None
        self._name_scope = None

    @staticmethod
    def create(prefix, params, hint):
        current = getattr(_BlockScope._current, "value", None)
        if current is None:
            if prefix is None:
                prefix = NameManager.current().get(None, hint) + "_"
            params = ParameterDict(prefix) if params is None else \
                ParameterDict(params.prefix, params)
            return prefix, params
        if prefix is None:
            count = current._counter.get(hint, 0)
            current._counter[hint] = count + 1
            prefix = "%s%d_" % (hint, count)
        if params is None:
            parent = current._block.params
            params = ParameterDict(parent.prefix + prefix, parent._shared)
        else:
            params = ParameterDict(params.prefix, params)
        return current._block.prefix + prefix, params

    def __enter__(self):
        if self._block._empty_prefix:
            return self
        self._old_scope = getattr(_BlockScope._current, "value", None)
        _BlockScope._current.value = self
        self._name_scope = NameManager()
        self._name_scope.__enter__()
        return self

    def __exit__(self, *args):
        if self._block._empty_prefix:
            return
        self._name_scope.__exit__(*args)
        self._name_scope = None
        _BlockScope._current.value = self._old_scope


def _indent(s, num_spaces):
    lines = s.split("\n")
    first = lines.pop(0)
    return first + ("\n" + "\n".join(" " * num_spaces + line
                                     for line in lines) if lines else "")


class Block(object):
    """The base of layers and models: children and Parameters register
    themselves when assigned as attributes."""

    def __init__(self, prefix=None, params=None):
        self._empty_prefix = prefix == ""
        self._prefix, self._params = _BlockScope.create(prefix, params,
                                                        self._alias())
        self._name = self._prefix[:-1] if self._prefix.endswith("_") \
            else self._prefix
        self._scope = _BlockScope(self)
        self._children: "OrderedDict[str, Block]" = OrderedDict()
        self._reg_params: Dict[str, Parameter] = {}
        self._forward_hooks: List = []
        self._forward_pre_hooks: List = []

    def _alias(self):
        return self.__class__.__name__.lower()

    def __repr__(self):
        modstr = "\n".join("  ({key}): {block}".format(
            key=key, block=_indent(str(block), 2))
            for key, block in self._children.items())
        return "%s(\n%s\n)" % (self.__class__.__name__, modstr)

    def __setattr__(self, name, value):
        """Register a Block or Parameter assigned to an attribute;
        reassigning the attribute unregisters the old one."""
        if hasattr(self, "_children"):
            if isinstance(value, Block):
                self._children[name] = value
            elif name in self._children:
                del self._children[name]
        if hasattr(self, "_reg_params"):
            if isinstance(value, Parameter):
                self._reg_params[name] = value
            elif name in self._reg_params:
                del self._reg_params[name]
        super().__setattr__(name, value)

    @property
    def prefix(self):
        return self._prefix

    @property
    def name(self):
        return self._name

    def name_scope(self):
        return self._scope

    @property
    def params(self) -> ParameterDict:
        return self._params

    def collect_params(self, select=None) -> ParameterDict:
        """This block's and its children's Parameters; with ``select``
        (a regular expression) those whose names match it."""
        ret = ParameterDict(self._params.prefix)
        if not select:
            ret.update(self.params)
        else:
            pattern = re.compile(select)
            ret._params = OrderedDict(
                (name, value) for name, value in self.params.items()
                if pattern.match(name))
        for child in self._children.values():
            ret.update(child.collect_params(select))
        return ret

    def child_blocks(self):
        return list(self._children.values())

    def register_child(self, block, name=None):
        if name is None:
            name = str(len(self._children))
        self._children[name] = block

    def register_forward_hook(self, hook):
        self._forward_hooks.append(hook)

    def register_forward_pre_hook(self, hook):
        self._forward_pre_hooks.append(hook)

    def apply(self, fn):
        for child in self._children.values():
            child.apply(fn)
        fn(self)
        return self

    def initialize(self, init=None, ctx=None, verbose=False,
                   force_reinit=False):
        """Initialize every Parameter on ``ctx`` (default: the card)."""
        from .. import initializer as _init_mod

        self.collect_params().initialize(init or _init_mod.Uniform(), ctx,
                                         verbose, force_reinit)

    def cast(self, dtype):
        for child in self._children.values():
            child.cast(dtype)
        for _, param in self.params.items():
            param.cast(dtype)

    def hybridize(self, active=True, **kwargs):
        for child in self._children.values():
            child.hybridize(active, **kwargs)

    # -- persistence ------------------------------------------------------
    def save_parameters(self, filename, deduplicate=False):
        """Every Parameter under its attribute path (``features.0.
        weight``), in ``nd.save``'s container."""
        from ..ndarray import save as nd_save

        nd_save(filename, {k: v.data() for k, v in
                           self._collect_params_with_prefix().items()})

    def load_parameters(self, filename, ctx=None, allow_missing=False,
                        ignore_extra=False, cast_dtype=False,
                        dtype_source="current"):
        """Load what ``save_parameters`` wrote; a Parameter not yet
        initialized is initialized on ``ctx`` (default: the card)."""
        from ..ndarray import load as nd_load

        loaded = nd_load(filename, ctx=cpu())
        params = self._collect_params_with_prefix()
        if not allow_missing:
            for name in params:
                if name not in loaded:
                    raise MXNetError("Parameter %r is missing in file %r"
                                     % (name, filename))
        for name, val in loaded.items():
            if name not in params:
                if not ignore_extra:
                    raise MXNetError("Parameter %r in file %r is not in "
                                     "this Block" % (name, filename))
                continue
            param = params[name]
            if param._data is None and not param._deferred_init:
                if param._shape is None:
                    param._shape = tuple(val.shape)
                param.initialize(ctx=ctx or [current_context()])
            param.set_data(val)

    save_params = save_parameters
    load_params = load_parameters

    def _collect_params_with_prefix(self, prefix="") -> Dict[str, Parameter]:
        if prefix:
            prefix += "."
        ret = {prefix + key: val for key, val in self._reg_params.items()}
        for name, child in self._children.items():
            ret.update(child._collect_params_with_prefix(prefix + name))
        return ret

    # -- execution --------------------------------------------------------
    def __call__(self, *args):
        for hook in self._forward_pre_hooks:
            hook(self, args)
        out = self.forward(*args)
        for hook in self._forward_hooks:
            hook(self, args, out)
        return out

    def forward(self, *args):
        raise NotImplementedError

    def summary(self, *inputs):
        """Print each block with its count of parameters."""
        rows = []

        def walk(block, depth):
            count = sum(int(np.prod(p.shape)) for p in
                        block._reg_params.values() if p._shape_known())
            rows.append(("  " * depth + block.__class__.__name__, count))
            for c in block._children.values():
                walk(c, depth + 1)

        walk(self, 0)
        out = "\n".join("%-40s %12d" % row for row in rows) + \
            "\nTotal params: %d" % sum(r[1] for r in rows)
        print(out)
        return out


class HybridBlock(Block):
    """A Block whose ``hybrid_forward(F, x, ...)`` runs on NDArrays or
    Symbols alike, and so can be traced into one graph."""

    def __init__(self, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        self._active = False
        self._cached_op: Optional[CachedOp] = None
        self._flags = []

    def hybridize(self, active=True, **kwargs):
        """Run as one traced graph from the next call (or again
        imperatively with ``active=False``)."""
        self._active = active
        self._flags = list(kwargs.items())
        self._clear_cached_op()
        super().hybridize(active, **kwargs)

    def _clear_cached_op(self):
        self._cached_op = None

    def cast(self, dtype):
        self._clear_cached_op()
        super().cast(dtype)

    def register_child(self, block, name=None):
        if not isinstance(block, HybridBlock):
            raise MXNetError("children of a HybridBlock must be "
                             "HybridBlocks; got %s" % type(block))
        super().register_child(block, name)
        self._clear_cached_op()

    # -- tracing ----------------------------------------------------------
    def _trace_symbol(self, *args):
        """Trace ``hybrid_forward`` with Symbol proxies ``data0``,
        ``data1``... for the (flattened) arguments; returns (the output
        Symbol, the output format, the input format)."""
        flat, in_fmt = _flatten(list(args), "input")
        data_syms = [sym_mod.var("data%d" % i) for i in range(len(flat))]
        structured, _ = _regroup(list(data_syms), in_fmt)
        with _TraceNames(self.prefix):
            out = self._call_hybrid(sym_mod, structured)
        out_flat, out_fmt = _flatten(out, "output")
        out_sym = out_flat[0] if len(out_flat) == 1 else \
            sym_mod.Group(out_flat)
        return out_sym, out_fmt, in_fmt

    def _build_cache(self, *args):
        """Trace the block and map the graph's arguments to the data
        slots and the Parameters."""
        out_sym, self._out_fmt, self._in_fmt = self._trace_symbol(*args)
        self._cached_op = CachedOp(out_sym, self._flags)
        by_name = {p.name: p for p in self.collect_params().values()}
        self._cached_arg_map = []
        for name in self._cached_op._arg_names:
            m = re.match(r"^data(\d+)$", name)
            if m:
                self._cached_arg_map.append(int(m.group(1)))
            elif name in by_name:
                self._cached_arg_map.append(by_name[name])
            else:
                raise MXNetError("traced graph references unknown "
                                 "parameter %r" % name)
        self._cached_aux = [by_name[name]
                            for name in self._cached_op._aux_names]

    def _collect_all_reg_params(self):
        out = dict(self._reg_params)
        for c in self._children.values():
            if isinstance(c, HybridBlock):
                out.update(c._collect_all_reg_params())
        return out

    def _call_hybrid(self, F, inputs):
        """``hybrid_forward`` with this block's own Parameters as keyword
        arguments: Symbol variables, or the arrays on the inputs'
        device (finishing a deferred initialisation first)."""
        if F is sym_mod:
            kwargs = {name: p.var() for name, p in self._reg_params.items()}
            return self.hybrid_forward(F, *inputs, **kwargs)
        flat = [a for a in _flatten(list(inputs), "input")[0]
                if isinstance(a, NDArray)]
        ctx = flat[0].ctx if flat else None
        try:
            kwargs = {name: p.data(ctx)
                      for name, p in self._reg_params.items()}
        except DeferredInitializationError:
            self._finish_deferred(*inputs)
            kwargs = {name: p.data(ctx)
                      for name, p in self._reg_params.items()}
        return self.hybrid_forward(F, *inputs, **kwargs)

    def _deferred_infer_shape(self, *args):
        """Set the deferred Parameters' shapes from a trace of the block
        and the inputs' shapes."""
        out_sym, _, _ = self._trace_symbol(*args)
        flat_args, _ = _flatten(list(args), "input")
        try:
            arg_shapes, _, aux_shapes = out_sym.infer_shape_partial(
                **{"data%d" % i: a.shape for i, a in enumerate(flat_args)})
        except MXNetError as e:
            raise MXNetError("deferred shape inference failed: %s" % e) \
                from e
        params = {p.name: p for p in self.collect_params().values()}
        for names, shapes in ((out_sym.list_arguments(), arg_shapes),
                              (out_sym.list_auxiliary_states(), aux_shapes)):
            for name, shape in zip(names, shapes):
                if name in params and shape is not None:
                    params[name].shape = shape

    def _finish_deferred(self, *args):
        """Infer and initialize every deferred Parameter of the block
        from a first call's inputs."""
        try:
            for p in self._collect_all_reg_params().values():
                p.data()
        except DeferredInitializationError:
            self._deferred_infer_shape(*args)
            for p in self.collect_params().values():
                p._finish_deferred_init()

    # -- execution --------------------------------------------------------
    def forward(self, x, *args):
        first = x
        while isinstance(first, (list, tuple)) and first:
            first = first[0]
        if isinstance(first, NDArray):
            if not self._active:
                return self._call_hybrid(nd_mod, [x] + list(args))
            if self._cached_op is None:
                self._finish_deferred(x, *args)
                self._build_cache(x, *args)
            return self._run_cached(x, *args)
        if isinstance(first, Symbol):
            with _TraceNames(self.prefix):
                return self._call_hybrid(sym_mod, [x] + list(args))
        raise MXNetError("HybridBlock input must be NDArray or Symbol, "
                         "got %s" % type(first))

    def _run_cached(self, *args):
        flat_args, in_fmt = _flatten(list(args), "input")
        if in_fmt != self._in_fmt:
            self._build_cache(*args)  # the input structure changed
        # each Parameter's current array: mark_variables may have
        # replaced its tensor since the graph was traced
        inputs = [flat_args[slot] if isinstance(slot, int) else slot.data()
                  for slot in self._cached_arg_map]
        out = self._cached_op(inputs, [p.data() for p in self._cached_aux])
        return _regroup(list(out), self._out_fmt)[0]

    def hybrid_forward(self, F, x, *args, **kwargs):
        raise NotImplementedError

    # -- export -----------------------------------------------------------
    def export(self, path, epoch=0):
        """Write ``path-symbol.json`` and ``path-%04d.params`` (``arg:``
        and ``aux:`` keys) from the traced graph."""
        if self._cached_op is None:
            raise MXNetError("run forward at least once under hybridize() "
                             "before export")
        from ..ndarray import save as nd_save

        self._cached_op.symbol.save("%s-symbol.json" % path)
        arg_dict = {"arg:" + slot.name: slot.data()
                    for slot in self._cached_arg_map
                    if isinstance(slot, Parameter)}
        arg_dict.update({"aux:" + p.name: p.data()
                         for p in self._cached_aux})
        nd_save("%s-%04d.params" % (path, epoch), arg_dict)


class SymbolBlock(HybridBlock):
    """A Symbol wrapped as a Block; its Parameters keep the graph's
    names."""

    def __init__(self, outputs, inputs, params=None):
        super().__init__(prefix=None, params=params)
        if isinstance(outputs, (list, tuple)):
            outputs = sym_mod.Group(list(outputs))
        if isinstance(inputs, Symbol):
            inputs = [inputs]
        self._symbol = outputs
        self._input_names = [s.name for s in inputs]
        for name in outputs.list_arguments():
            if name not in self._input_names and \
                    name not in self.params._params:
                self.params._params[name] = Parameter(
                    name, allow_deferred_init=True)
        for name in outputs.list_auxiliary_states():
            if name not in self.params._params:
                self.params._params[name] = Parameter(
                    name, grad_req="null", allow_deferred_init=True)

    @staticmethod
    def imports(symbol_file, input_names, param_file=None, ctx=None):
        """A SymbolBlock from an exported graph, its Parameters loaded
        from ``param_file`` onto ``ctx`` (default: the card)."""
        block = SymbolBlock(sym_mod.load(symbol_file), [
            sym_mod.var(n) for n in ([input_names]
                                     if isinstance(input_names, str)
                                     else input_names)])
        if param_file is not None:
            from ..ndarray import load as nd_load

            by_name = {re.sub(r"^(arg|aux):", "", k): v
                       for k, v in nd_load(param_file, ctx=cpu()).items()}
            for name, p in block.params.items():
                if name in by_name:
                    p._shape = tuple(by_name[name].shape)
                    p.initialize(ctx=ctx or [current_context()])
                    p.set_data(by_name[name])
        return block

    def forward(self, x, *args):
        if not isinstance(x, NDArray):
            raise MXNetError("SymbolBlock input must be NDArray")
        if self._cached_op is None:
            self._build_symbol_cache(len(args) + 1)
        return self._run_cached(x, *args)

    def _build_symbol_cache(self, n_inputs):
        self._cached_op = CachedOp(self._symbol)
        by_name = {p.name: p for p in self.params.values()}
        self._cached_arg_map = [
            self._input_names.index(name) if name in self._input_names
            else by_name[name] for name in self._cached_op._arg_names]
        self._cached_aux = [by_name[n] for n in self._cached_op._aux_names]
        n_out = len(self._symbol.list_outputs())
        self._out_fmt = 0 if n_out == 1 else [0] * n_out
        self._in_fmt = [0] * n_inputs

    def hybrid_forward(self, F, x, *args, **kwargs):
        raise MXNetError("SymbolBlock has no hybrid_forward")
