"""Symbol composer codegen (counterpart of
``mxtpu/symbol/register.py``): every registered op gets a ``sym.*``
function that takes Symbol inputs by position or by input name,
creates the missing input variables (``fc1_weight``,
``bn0_moving_mean``...) and returns a new Symbol."""
from __future__ import annotations

from typing import Any, Dict, Optional, Sequence

from ..base import MXNetError, _Null
from ..ops import registry as _reg
from . import op_meta as _meta_mod
from .symbol import NameManager, Symbol, SymbolNode, Variable


def invoke_symbol(op_name: str, input_syms: Sequence[Symbol],
                  attrs: Dict[str, Any], name: Optional[str] = None) -> Symbol:
    opdef = _reg.get_op(op_name)
    attrs = {k: v for k, v in attrs.items()
             if v is not None and v is not _Null}
    node_name = NameManager.current().get(name, opdef.name.lower().lstrip("_"))
    entries = []
    for s in input_syms:
        if len(s._outputs) != 1:
            raise MXNetError("op inputs must be single-output symbols")
        entries.append(s._outputs[0])
    node = SymbolNode(opdef, node_name, attrs, entries)
    return Symbol([(node, i) for i in range(opdef.n_visible_outputs(attrs))])


def _make_symbol_function(opdef):
    def fn(*args, name=None, attr=None, **kwargs):
        meta = _meta_mod.get_meta(opdef)
        node_name = NameManager.current().get(
            name, opdef.name.lower().lstrip("_"))
        sym_kwargs = {k: v for k, v in kwargs.items() if isinstance(v, Symbol)}
        attrs = {k: v for k, v in kwargs.items()
                 if not isinstance(v, Symbol) and v is not None
                 and v is not _Null}
        for a in args:
            if not isinstance(a, Symbol):
                raise MXNetError(
                    "positional argument %r to %s is not a Symbol; operator "
                    "attributes must be passed by keyword" % (a, opdef.name))
        sym_args = list(args)
        if meta.variadic and not sym_kwargs:
            inputs = sym_args
        else:
            input_names = meta.input_names(attrs)
            # `data=` names any op's first input
            if "data" in sym_kwargs and input_names \
                    and "data" not in input_names and not sym_args \
                    and input_names[0] not in sym_kwargs:
                sym_kwargs[input_names[0]] = sym_kwargs.pop("data")
            inputs = []
            for i, in_name in enumerate(input_names):
                if i < len(sym_args):
                    inputs.append(sym_args[i])
                elif in_name in sym_kwargs:
                    inputs.append(sym_kwargs.pop(in_name))
                else:
                    v = Variable("%s_%s" % (node_name, in_name))
                    if i in meta.aux_indices:
                        v._outputs[0][0].is_aux = True
                    inputs.append(v)
            if sym_kwargs:
                raise MXNetError("unknown symbol inputs %s for op %s"
                                 % (list(sym_kwargs), opdef.name))
        node = SymbolNode(opdef, node_name, attrs,
                          [s._outputs[0] for s in inputs])
        if attr:
            node.ext_attrs.update({k: str(v) for k, v in attr.items()})
        return Symbol([(node, i)
                       for i in range(opdef.n_visible_outputs(attrs))])

    fn.__name__ = opdef.name
    fn.__doc__ = opdef.doc
    fn.__module__ = "mxtpu_torch.symbol"
    return fn


def _init_symbol_module(target_module):
    for op_name, opdef in list(_reg._OP_REGISTRY.items()):
        setattr(target_module, op_name, _make_symbol_function(opdef))
    _reg.add_post_register_hook(
        lambda name, od: setattr(target_module, name,
                                 _make_symbol_function(od)))
