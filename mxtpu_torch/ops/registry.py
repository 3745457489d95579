"""Operator registry of the PyTorch port.

Counterpart of ``mxtpu/ops/registry.py``.  An op is a plain function on
``torch.Tensor``s plus a few flags, registered under the reference's
name; the imperative layer (``mxtpu_torch.ndarray``), the symbol
composer and the executor all call it through :func:`invoke`.  torch's
autograd gives the gradient (a ``torch.autograd.Function`` where the
reference defines its own), so the JAX package's per-(op, attrs)
``jax.jit`` cache becomes a plain call.

Ops that take no tensor input (``_zeros``, ``_random_uniform``...) take
a ``device`` keyword, which the caller supplies; ops with ``needs_rng``
take a ``torch.Generator`` as their first argument where the JAX
package's take a PRNG key.

float32 means float32, as in the JAX package: an op that calls cuDNN
or cuBLAS on the card (``fp32_library``: Convolution, FullyConnected,
RNN) turns TF32 off for both libraries (:func:`float32_numerics`)
before it runs on a float32 input, however it is called (``nd``, an
executor, a CachedOp or a gluon block).  The flags are process-wide
and stay off, so the op's backward, which autograd runs later, reads
them off too, and a CUDA graph captured around the op keeps the
float32 kernels.  On the CPU they change nothing.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Sequence

import torch

from ..base import MXNetError

__all__ = ["OpDef", "register", "get_op", "list_ops", "invoke",
           "add_post_register_hook", "float32_numerics"]

_OP_REGISTRY: Dict[str, "OpDef"] = {}

# Called with (name, opdef) for every registration after the hook was
# installed: the nd/sym codegen installs one so that late registrations
# get their nd.*/sym.* functions too.
_POST_REGISTER_HOOKS: List[Callable[[str, "OpDef"], None]] = []


def add_post_register_hook(hook: Callable[[str, "OpDef"], None]):
    _POST_REGISTER_HOOKS.append(hook)


class OpDef(object):
    """A registered operator.

    Parameters
    ----------
    name : registered op name (the reference's, e.g. ``elemwise_add``).
    fn : ``fn(*tensors, **attrs) -> tensor | tuple(tensors)``; with
        ``needs_rng`` the first positional argument is a
        ``torch.Generator``.
    num_outputs : static output count (or a callable ``attrs -> int``).
    visible_outputs : outputs the user sees (BatchNorm computes
        (out, mean, var) but shows ``out``); None is all of them.
    differentiable : if False the op is never recorded (argmax...).
    needs_rng : op draws random numbers (dropout, samplers).
    train_aware : op takes an ``is_train`` attr from the caller's scope.
    mutate_inputs : indices of inputs the op updates (optimizer ops
        return the new values; the caller writes them back).
    fp32_library : op calls cuDNN or cuBLAS, whose float32 must not
        round through TF32 (:func:`float32_numerics`).
    """

    def __init__(self, name: str, fn: Callable, num_outputs: Any = 1,
                 differentiable: bool = True, needs_rng: bool = False,
                 train_aware: bool = False,
                 mutate_inputs: Sequence[int] = (),
                 aliases: Sequence[str] = (), visible_outputs: Any = None,
                 fp32_library: bool = False, doc: Optional[str] = None):
        self.name = name
        self.fn = fn
        self.num_outputs = num_outputs
        self.visible_outputs = visible_outputs
        self.differentiable = differentiable
        self.needs_rng = needs_rng
        self.train_aware = train_aware
        self.mutate_inputs = tuple(mutate_inputs)
        self.aliases = tuple(aliases)
        self.fp32_library = fp32_library
        self.doc = doc or (fn.__doc__ or "")

    def n_outputs(self, attrs: Dict[str, Any]) -> int:
        if callable(self.num_outputs):
            return self.num_outputs(attrs)
        return self.num_outputs

    def n_visible_outputs(self, attrs: Dict[str, Any]) -> int:
        if self.visible_outputs is None:
            return self.n_outputs(attrs)
        if callable(self.visible_outputs):
            return self.visible_outputs(attrs)
        return self.visible_outputs

    def __repr__(self):
        return "OpDef(%s)" % self.name


def register(name: str, num_outputs: Any = 1, differentiable: bool = True,
             needs_rng: bool = False, train_aware: bool = False,
             mutate_inputs: Sequence[int] = (), aliases: Sequence[str] = (),
             visible_outputs: Any = None, fp32_library: bool = False):
    """Decorator registering a torch function as a framework op."""

    def deco(fn):
        opdef = OpDef(name, fn, num_outputs=num_outputs,
                      differentiable=differentiable, needs_rng=needs_rng,
                      train_aware=train_aware, mutate_inputs=mutate_inputs,
                      aliases=aliases, visible_outputs=visible_outputs,
                      fp32_library=fp32_library)
        for n in (name,) + tuple(aliases):
            if n in _OP_REGISTRY:
                raise MXNetError("op %r already registered" % n)
            _OP_REGISTRY[n] = opdef
        for hook in _POST_REGISTER_HOOKS:
            for n in (name,) + tuple(aliases):
                hook(n, opdef)
        return fn

    return deco


def get_op(name: str) -> OpDef:
    try:
        return _OP_REGISTRY[name]
    except KeyError:
        raise MXNetError("operator %r is not registered" % name) from None


def list_ops() -> List[str]:
    return sorted(_OP_REGISTRY)


def float32_numerics(tensors: Sequence[torch.Tensor]):
    """TF32 off for cuDNN and cuBLAS when any of ``tensors`` is float32.
    The flags are set, not read: reading the legacy flag raises once
    the newer per-op precision API has set cuDNN's convolutions and
    RNNs apart."""
    for t in tensors:
        if t.dtype == torch.float32:
            torch.backends.cudnn.allow_tf32 = False
            torch.backends.cuda.matmul.allow_tf32 = False
            return


def invoke(opdef: OpDef, inputs: Sequence, attrs: Dict[str, Any],
           generator=None) -> tuple:
    """Run an op on tensors; always returns a tuple of tensors."""
    if opdef.fp32_library:
        float32_numerics(inputs)
    if opdef.needs_rng:
        out = opdef.fn(generator, *inputs, **attrs)
    else:
        out = opdef.fn(*inputs, **attrs)
    return out if isinstance(out, tuple) else (out,)
