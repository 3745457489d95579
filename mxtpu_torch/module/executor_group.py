"""The executor group of the PyTorch port, on one device.

Counterpart of ``mxtpu/module/executor_group.py``: the group binds the
symbol at the batch's shapes, gives each argument its ``grad_req``
(parameters ``write`` when training and not fixed, data ``write`` only
with ``inputs_need_grad``, labels ``null``), copies each batch into the
bound arrays, and exposes the parameter, gradient and aux arrays as
[per-parameter][per-device] lists, as the JAX package's does.  A group
bound with a ``shared_group`` (``BucketingModule``'s buckets) takes that
group's parameter, gradient and aux arrays for its own: every bucket's
executor holds the same tensors.  ``forward_ragged`` hands an inference
batch of another size (its data and, when it has them, its labels) to
the executor's bucketed forward instead of a rebind.  Slicing a batch
over several devices is not ported.
"""
from __future__ import annotations

import logging
from typing import Dict, List

import torch

from ..base import MXNetError
from ..io.io import DataDesc
from ..ndarray.ndarray import NDArray

__all__ = ["DataParallelExecutorGroup"]


def _desc_list(shapes):
    return [s if isinstance(s, DataDesc) else DataDesc(s[0], s[1])
            for s in shapes or []]


class DataParallelExecutorGroup(object):
    def __init__(self, symbol, contexts, workload, data_shapes, label_shapes,
                 param_names: List[str], for_training: bool,
                 inputs_need_grad: bool, shared_group=None, logger=logging,
                 fixed_param_names=None, grad_req="write"):
        if len(contexts) != 1:
            raise MXNetError("a Module over %d devices is not ported (one "
                             "device only)" % len(contexts))
        self.symbol = symbol
        self.contexts = contexts
        self.param_names = param_names
        self.for_training = for_training
        self.inputs_need_grad = inputs_need_grad
        self.fixed_param_names = set(fixed_param_names or [])
        self.logger = logger
        self.arg_names = symbol.list_arguments()
        self.aux_names = symbol.list_auxiliary_states()
        self.data_shapes = _desc_list(data_shapes)
        self.label_shapes = _desc_list(label_shapes)
        self.data_names = [d.name for d in self.data_shapes]
        self.label_names = [l.name for l in self.label_shapes]
        self.batch_size = self.data_shapes[0].shape[0]

        grad_req_dict: Dict[str, str] = {}
        for name in self.arg_names:
            if name in self.param_names:
                grad_req_dict[name] = "null" if not for_training or \
                    name in self.fixed_param_names else \
                    (grad_req if isinstance(grad_req, str)
                     else grad_req.get(name, "write"))
            elif name in self.data_names:
                grad_req_dict[name] = "write" if inputs_need_grad else "null"
            else:
                grad_req_dict[name] = "null"
        shapes = {d.name: d.shape
                  for d in self.data_shapes + self.label_shapes}
        ex = symbol.simple_bind(ctx=contexts[0], grad_req=grad_req_dict,
                                **shapes)
        if shared_group is not None:
            self._share_arrays(ex, shared_group.execs[0])
        self.execs = [ex]
        self.param_arrays = [[ex.arg_dict[name]] for name in self.param_names
                             if name in self.arg_names]
        self.grad_arrays = [[ex.grad_dict.get(name)]
                            for name in self.param_names
                            if name in self.arg_names]
        self.aux_arrays = [[ex.aux_dict[name]] for name in self.aux_names]

    def _share_arrays(self, ex, src):
        """Put ``src``'s parameter and gradient arrays, and its aux
        arrays, in ``ex`` in place of its own."""
        for name in self.param_names:
            if name not in src.arg_dict or name not in ex.arg_dict:
                continue
            if src.arg_dict[name].shape != ex.arg_dict[name].shape:
                raise MXNetError("shared parameter %r has shape %s here "
                                 "and %s in the shared module" % (
                                     name, ex.arg_dict[name].shape,
                                     src.arg_dict[name].shape))
            i = ex._arg_names.index(name)
            ex.arg_arrays[i] = ex.arg_dict[name] = src.arg_dict[name]
            grad = src.grad_dict.get(name)
            if grad is not None and ex.grad_arrays[i] is not None:
                ex.grad_arrays[i] = ex.grad_dict[name] = grad
        for name, arr in src.aux_dict.items():
            if name in ex.aux_dict:
                ex.aux_arrays[ex._aux_names.index(name)] = \
                    ex.aux_dict[name] = arr

    # -- params -----------------------------------------------------------
    def set_params(self, arg_params, aux_params, allow_extra=False):
        for ex in self.execs:
            ex.copy_params_from(arg_params, aux_params,
                                allow_extra_params=allow_extra)

    def get_params(self, arg_params: Dict[str, NDArray],
                   aux_params: Dict[str, NDArray]):
        """Copy the device's parameters and aux states into the dicts'
        arrays."""
        for name, blocks in zip(self.param_names, self.param_arrays):
            blocks[0].copyto(arg_params[name])
        for name, blocks in zip(self.aux_names, self.aux_arrays):
            blocks[0].copyto(aux_params[name])

    # -- execution --------------------------------------------------------
    def _copy_in(self, arrays, names):
        ex = self.execs[0]
        for name, arr in zip(names, arrays):
            if name in ex.arg_dict:
                ex.arg_dict[name]._set_data(
                    arr._data if isinstance(arr, NDArray)
                    else torch.as_tensor(arr))

    def forward(self, data_batch, is_train=None):
        if is_train is None:
            is_train = self.for_training
        self._copy_in(data_batch.data, self.data_names)
        if self.label_shapes and getattr(data_batch, "label", None):
            self._copy_in(data_batch.label, self.label_names)
        for ex in self.execs:
            ex.forward(is_train=is_train)

    def _ragged_slots(self, data_batch):
        """(name, array) of the batch's data, and of its labels when it
        has them (a graph that reads its labels sees this batch's)."""
        pairs = list(zip(self.data_names, data_batch.data))
        labels = getattr(data_batch, "label", None)
        if labels:
            pairs += list(zip(self.label_names, labels))
        return pairs

    def can_forward_ragged(self, data_batch) -> bool:
        """Whether the executor's bucketed forward can take this batch:
        a bucket policy is on and every slot has one leading dim, with
        the bound trailing dims."""
        from .. import compile_cache as _cc

        if len(self.execs) != 1 or not _cc.bucketing_enabled():
            return False
        ex = self.execs[0]
        leading = set()
        for name, arr in self._ragged_slots(data_batch):
            if name not in ex.arg_dict:
                return False
            bound = ex.arg_dict[name].shape
            if len(arr.shape) != len(bound) or len(arr.shape) == 0 or \
                    tuple(arr.shape[1:]) != tuple(bound[1:]):
                return False
            leading.add(arr.shape[0])
        return len(leading) == 1

    def forward_ragged(self, data_batch):
        """Inference over a batch of another size, without a rebind."""
        ex = self.execs[0]
        ex.forward(is_train=False, **{
            name: arr if isinstance(arr, NDArray)
            else NDArray(torch.as_tensor(arr))
            for name, arr in self._ragged_slots(data_batch)})

    def warmup(self):
        for ex in self.execs:
            ex.warmup()

    def get_input_grads(self, merge_multi_context: bool = True):
        return [self.execs[0].grad_dict.get(name)
                for name in self.data_names]

    def install_monitor(self, mon):
        for ex in self.execs:
            mon.install(ex)

    def backward(self, out_grads=None):
        if not self.for_training:
            raise MXNetError("re-bind with for_training=True to backward")
        for ex in self.execs:
            ex.backward(out_grads=out_grads)

    def get_outputs(self, merge_multi_context: bool = True):
        return list(self.execs[0].outputs)

    def update_metric(self, eval_metric, labels, pre_sliced=False):
        eval_metric.update(list(labels), list(self.execs[0].outputs))
