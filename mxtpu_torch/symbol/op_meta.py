"""Per-op metadata for symbolic composition (counterpart of
``mxtpu/symbol/op_meta.py``).

Forward shapes come from running the op on ``meta`` tensors, so this
table carries only what that cannot give: input names (for auto-created
variables such as ``fc1_weight``), which inputs are auxiliary states
(BatchNorm's moving stats), and the parameter shapes solved backward
from the data shape for FullyConnected, Convolution, BatchNorm,
Embedding and RNN (its flat parameter vector and its states).  Ops
not listed take their input names from their function's signature.
"""
from __future__ import annotations

import inspect
from typing import Dict, List

from ..ops.registry import OpDef


class OpMeta(object):
    def __init__(self, input_names, aux_indices=(), param_shapes=None,
                 variadic=False):
        # input_names: list[str] | callable(attrs) -> list[str]
        self._input_names = input_names
        self.aux_indices = tuple(aux_indices)
        # param_shapes: callable(shapes: list[Optional[tuple]], attrs)
        #               -> {input index: shape}
        self.param_shapes = param_shapes
        self.variadic = variadic

    def input_names(self, attrs) -> List[str]:
        if callable(self._input_names):
            return self._input_names(attrs)
        return list(self._input_names)


_META: Dict[str, OpMeta] = {}


def register_meta(op_name: str, meta: OpMeta):
    _META[op_name] = meta


def get_meta(opdef: OpDef) -> OpMeta:
    m = _META.get(opdef.name)
    if m is not None:
        return m
    # from the signature: positional parameters without default are inputs
    names, variadic = [], False
    for p in inspect.signature(opdef.fn).parameters.values():
        if p.kind == inspect.Parameter.VAR_POSITIONAL:
            variadic = True
        elif p.kind in (inspect.Parameter.POSITIONAL_ONLY,
                        inspect.Parameter.POSITIONAL_OR_KEYWORD) \
                and p.default is inspect.Parameter.empty:
            if p.name == "gen" and opdef.needs_rng:
                continue
            names.append(p.name)
    m = _META[opdef.name] = OpMeta(names, variadic=variadic)
    return m


def _prod(xs):
    out = 1
    for x in xs:
        out *= int(x)
    return out


def _bias_inputs(attrs):
    return ["data", "weight"] if attrs.get("no_bias") else \
        ["data", "weight", "bias"]


def _fc_shapes(shapes, attrs):
    data = shapes[0]
    if data is None:
        return {}
    nh = int(attrs["num_hidden"])
    in_units = _prod(data[1:]) if attrs.get("flatten", True) else data[-1]
    out = {1: (nh, in_units)}
    if not attrs.get("no_bias"):
        out[2] = (nh,)
    return out


register_meta("FullyConnected", OpMeta(_bias_inputs, param_shapes=_fc_shapes))


def _conv_shapes(shapes, attrs):
    data = shapes[0]
    if data is None:
        return {}
    nf = int(attrs["num_filter"])
    g = int(attrs.get("num_group", 1))
    out = {1: (nf, data[1] // g) + tuple(attrs["kernel"])}
    if not attrs.get("no_bias"):
        out[2] = (nf,)
    return out


register_meta("Convolution", OpMeta(_bias_inputs, param_shapes=_conv_shapes))
register_meta("Convolution_v1", OpMeta(_bias_inputs,
                                       param_shapes=_conv_shapes))


def _bn_shapes(shapes, attrs):
    data = shapes[0]
    if data is None:
        return {}
    c = data[int(attrs.get("axis", 1)) % len(data)]
    return {1: (c,), 2: (c,), 3: (c,), 4: (c,)}


for _bn in ("BatchNorm", "BatchNorm_v1"):
    register_meta(_bn, OpMeta(
        ["data", "gamma", "beta", "moving_mean", "moving_var"],
        aux_indices=(3, 4), param_shapes=_bn_shapes))

# loss heads: the label is a plain input (not auto-shaped)
register_meta("SoftmaxOutput", OpMeta(["data", "label"]))
register_meta("Softmax", OpMeta(["data", "label"]))


def _emb_shapes(shapes, attrs):
    return {1: (int(attrs["input_dim"]), int(attrs["output_dim"]))}


register_meta("Embedding", OpMeta(["data", "weight"],
                                  param_shapes=_emb_shapes))


def _rnn_inputs(attrs):
    if attrs.get("mode", "lstm") == "lstm":
        return ["data", "parameters", "state", "state_cell"]
    return ["data", "parameters", "state"]


def _rnn_shapes(shapes, attrs):
    from ..ops.rnn_op import rnn_param_size

    data = shapes[0]
    if data is None:
        return {}
    _, n, input_size = data
    h = int(attrs["state_size"])
    layers = int(attrs.get("num_layers", 1))
    bi = bool(attrs.get("bidirectional", False))
    mode = attrs.get("mode", "lstm")
    d = 2 if bi else 1
    out = {1: (rnn_param_size(input_size, h, layers, bi, mode),),
           2: (layers * d, n, h)}
    if mode == "lstm":
        out[3] = (layers * d, n, h)
    return out


register_meta("RNN", OpMeta(_rnn_inputs, param_shapes=_rnn_shapes))
