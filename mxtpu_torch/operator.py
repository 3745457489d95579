"""The custom-operator API of the PyTorch port (counterpart of
``mxtpu/operator.py``): ``CustomOp``, ``CustomOpProp``, ``register`` and
``get_all_registered_operators``.  A registered prop is called by
``nd.Custom``/``sym.Custom`` with ``op_type=`` its name; the op itself
is ``mxtpu_torch/ops/custom_op.py``.

    @mx.operator.register("sigmoid2")
    class Sigmoid2Prop(mx.operator.CustomOpProp):
        def list_arguments(self): return ["data"]
        def list_outputs(self): return ["output"]
        def infer_shape(self, in_shape): return in_shape, [in_shape[0]], []
        def create_operator(self, ctx, shapes, dtypes): return Sigmoid2()

    class Sigmoid2(mx.operator.CustomOp):
        def forward(self, is_train, req, in_data, out_data, aux):
            self.assign(out_data[0], req[0], 1 / (1 + (-in_data[0]).exp()))
        def backward(self, req, out_grad, in_data, out_data, in_grad, aux):
            y = out_data[0]
            self.assign(in_grad[0], req[0], out_grad[0] * y * (1 - y))

    y = mx.nd.Custom(x, op_type="sigmoid2")
"""
from __future__ import annotations

from typing import List

from .base import MXNetError
from .ndarray.ndarray import NDArray
from .ops.custom_op import PROP_REGISTRY

__all__ = ["CustomOp", "CustomOpProp", "register",
           "get_all_registered_operators"]


class CustomOp(object):
    """The body of a user's operator."""

    def forward(self, is_train, req, in_data, out_data, aux):
        raise NotImplementedError

    def backward(self, req, out_grad, in_data, out_data, in_grad, aux):
        raise NotImplementedError

    @staticmethod
    def assign(dst: NDArray, req: str, src):
        """Write ``src`` into ``dst`` as the request ``req`` says
        (``null``, ``write``/``inplace`` or ``add``)."""
        if req in ("null", None):
            return
        if not isinstance(src, NDArray):
            from .ndarray.ndarray import array

            src = array(src, ctx=dst.ctx)
        if req in ("write", "inplace"):
            src.copyto(dst)
        elif req == "add":
            dst._set_data(dst._data + src._data.to(dst._data.device))
        else:
            raise MXNetError("unknown req %r" % req)


class CustomOpProp(object):
    """A user's operator's metadata: its arguments and outputs, shape and
    type inference, and the operator's factory."""

    def __init__(self, need_top_grad: bool = True, **kwargs):
        self.need_top_grad_ = need_top_grad
        self._kwargs = kwargs

    def list_arguments(self) -> List[str]:
        return ["data"]

    def list_outputs(self) -> List[str]:
        return ["output"]

    def list_auxiliary_states(self) -> List[str]:
        return []

    def infer_shape(self, in_shape):
        """Every output shaped like the first input."""
        return in_shape, [in_shape[0]] * len(self.list_outputs()), []

    def infer_type(self, in_type):
        return (in_type, [in_type[0]] * len(self.list_outputs()),
                [in_type[0]] * len(self.list_auxiliary_states()))

    def infer_storage_type(self, in_stype):
        return in_stype, ["default"] * len(self.list_outputs()), []

    def declare_backward_dependency(self, out_grad, in_data, out_data):
        deps = []
        if self.need_top_grad_:
            deps.extend(out_grad)
        deps.extend(in_data)
        deps.extend(out_data)
        return deps

    def create_operator(self, ctx, in_shapes, in_dtypes) -> CustomOp:
        raise NotImplementedError


def register(reg_name: str):
    """Class decorator: register a ``CustomOpProp`` as ``op_type``
    ``reg_name``."""

    def deco(prop_cls):
        if not issubclass(prop_cls, CustomOpProp):
            raise MXNetError("register expects a CustomOpProp subclass")
        PROP_REGISTRY[reg_name] = prop_cls
        return prop_cls
    return deco


def get_all_registered_operators() -> List[str]:
    return list(PROP_REGISTRY)
