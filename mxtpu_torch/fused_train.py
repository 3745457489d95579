"""Fused multi-step training of the PyTorch port: K train steps a call.

Counterpart of ``mxtpu/fused_train.py``.  The JAX package traces K
whole steps (forward, backward, optimizer) into one scanned XLA program
with donated buffers, so that a call costs one dispatch.  On the card
the cost to remove is the same, the host's per-operation launches (a
ResNet-50 step is about 2600 kernels), and the torch form is a CUDA
graph of one whole step, captured once and replayed K times a call:

* the graph holds the forward through the executor's own graph fn (its
  AMP policy included), the gradients by ``torch.autograd.grad``, the
  optimizer's scan step (``Optimizer.make_scan_step``) and the
  BatchNorm fold written into the executor's aux tensors;
* its static buffers are the executor's own argument, aux and optimizer
  state tensors, updated in place, so the per-step path and the loop
  share them; the data arguments' own tensors are the input slots, and
  one (n,) float32 tensor holds the step's learning rates;
* before each replay the step's slice of each (K, ...) data stack and
  its row of rates are copied into those slots: a call is K replays
  plus these copies (and one copy of each output when collected);
* the graph is captured on the first call, after warm-up steps on a
  side stream (torch's whole-network capture recipe) whose updates are
  then undone; it is captured again when a tensor behind one of those
  arrays was replaced (its ``data_ptr`` moved), when the parameters
  that share a learning rate change (``optimizer.lr_groups``) or when
  the Module's optimizer was replaced (``init_optimizer(force_init=
  True)``): the optimizer and the updater's states are looked up on
  every call;
* with random ops, the port's generator is registered with the graph,
  so each replay draws fresh numbers.
* a graph that holds an op running Python on the host at each call
  (``Custom``, ``ops.custom_op.HOST_OPS``, inside a ``_subgraph_exec``
  or a control-flow subgraph too) is never captured: a CUDA graph
  cannot call Python.  Its K steps run one by one on the card, with the
  same semantics (``capturable`` is False).
* the graph keeps the kernels chosen at capture: each float32
  convolution and product turns TF32 off before it runs
  (``ops.registry.float32_numerics``), in the warm-up steps and in the
  captured step alike, so the replays run float32 kernels.

On the CPU the same step function runs eagerly K times.  The semantics
are the per-step path's (``mxtpu/fused_train.py:21-25``): the rates of
the K steps are computed up front on the host (scheduler and Adam's
bias correction advance per step), the BatchNorm moving stats advance
per step, random draws are fresh per global step, and the optimizer's
counters advance by K after each call (``commit_scan_steps``).

Usage (a single-device Module, no kvstore)::

    loop = FusedTrainLoop(module, steps_per_program=8)
    for chunk in chunks_of(batches, 8):
        outputs = loop.run(chunk)          # 8 steps, (8, ...) outputs
    loop.finalize()

The health, inspect, perf, xprof, checkpoint and sharding hooks and
``lower_stacked`` are not ported (ROADMAP A17/A18); the bad-step guard
(``MXTPU_MAX_BAD_STEPS`` > 0) raises.
"""
from __future__ import annotations

import time
from typing import Any, List, Optional, Sequence

import numpy as np
import torch

from . import random as _rnd
from .base import MXNetError, getenv_int
from .ndarray.ndarray import NDArray
from .ops.custom_op import HOST_OPS
from .optimizer.optimizer import lr_groups
from .symbol.symbol import Symbol

__all__ = ["FusedTrainLoop"]

# warm-up steps on a side stream before a capture (their updates are
# undone): cuDNN's and cuBLAS's plans and workspaces are settled there
_WARMUP_STEPS = 2
# one warm-up stream per device: torch keeps a cuBLAS workspace for
# each stream it has run a product on, so a stream from torch's pool
# per capture would hold one more each time, up to the pool's size
_WARMUP_STREAMS = {}


def _runs_host_ops(symbol) -> bool:
    """Whether ``symbol`` holds an op of ``HOST_OPS``, looking inside
    packed subgraphs and control-flow subgraphs."""
    for node in symbol._topo():
        if node.is_variable:
            continue
        if node.op.name in HOST_OPS:
            return True
        if node.op.name == "_subgraph_exec":
            from .subgraph import _parse_subgraph

            if _runs_host_ops(_parse_subgraph(node.attrs["subgraph_json"])):
                return True
        if any(isinstance(v, Symbol) and _runs_host_ops(v)
               for v in node.attrs.values()):
            return True
    return False


class FusedTrainLoop(object):
    """Run a Module's whole train step (forward, backward, optimizer) K
    = ``steps_per_program`` times a call; on the card as the replays of
    one captured CUDA graph.

    Requirements: the module is bound for training on ONE device, with
    its parameters initialised and a local (no kvstore) optimizer whose
    type has a scan step (SGD, Adam), every grad_req ``write`` or
    ``null``.  Raises MXNetError otherwise.  ``unroll`` is accepted for
    the JAX package's signature and has no meaning here (it unrolls the
    XLA scan).  ``steps_per_program`` defaults to
    ``MXTPU_STEPS_PER_PROGRAM`` or 8.  ``collect_outputs`` may be changed
    between calls (the graph computes the outputs either way; collecting
    copies each step's into the (K, ...) result).
    """

    def __init__(self, module, steps_per_program: Optional[int] = None,
                 collect_outputs: bool = True, unroll: Optional[int] = None):
        if steps_per_program is None:
            steps_per_program = getenv_int("MXTPU_STEPS_PER_PROGRAM", 8)
        if getenv_int("MXTPU_MAX_BAD_STEPS", 0) > 0:
            raise MXNetError("FusedTrainLoop: the bad-step guard "
                             "(MXTPU_MAX_BAD_STEPS > 0) is not ported "
                             "(ROADMAP A17)")
        if not (module.binded and module.params_initialized and
                module.optimizer_initialized):
            raise MXNetError("FusedTrainLoop: module must be bound, "
                             "initialized and have an optimizer")
        if len(module._context) != 1:
            raise MXNetError("FusedTrainLoop: single-device modules only")
        self._module = module
        self._exec = ex = module._exec_group.execs[0]
        self._K = int(steps_per_program)
        self.collect_outputs = collect_outputs
        if self._K < 1:
            raise MXNetError("steps_per_program must be >= 1")
        if any(r not in ("write", "null") for r in ex._grad_req):
            raise MXNetError("FusedTrainLoop: grad_req 'add' not supported")

        self._arg_names = ex._arg_names
        # a name that several variable nodes share is one parameter: the
        # graph reads its last position, the one trained here
        last = {n: i for i, n in enumerate(self._arg_names)}
        self._diff_idx = [i for i in ex._diff_idx
                          if last[self._arg_names[i]] == i]
        diff = set(self._diff_idx)
        data_names = set(module._data_names) | set(module._label_names)
        # the data and label arguments; the rest (neither trained nor
        # data) the step reads from the executor's tensors as they are
        self._data_idx = [i for i, n in enumerate(self._arg_names)
                          if i not in diff and n in data_names]
        # the updater's index of each trained parameter (one device: its
        # position in the group's param_names, as idx2name)
        pname_pos = {n: i for i, n in
                     enumerate(module._exec_group.param_names)}
        self._opt_indices = [pname_pos[self._arg_names[i]]
                             for i in self._diff_idx]

        self._optimizer = self._scan_step = None
        self._bind_optimizer()
        self._lr_row = torch.zeros(len(self._diff_idx), dtype=torch.float32,
                                   device=ex._ctx)
        #: False where the graph runs Python on the host (``Custom``):
        #: the steps then run one by one, never captured
        self.capturable = not _runs_host_ops(ex._symbol)
        self._graph = None
        self._graph_key = None
        self._static_outs: List[torch.Tensor] = []
        #: seconds of the last capture (warm-up steps included)
        self.capture_seconds: Optional[float] = None
        #: how many times a graph was captured
        self.captures = 0

    def _bind_optimizer(self):
        """The Module's optimizer (its scan step made again when it was
        replaced) and its updater's own states (made on demand), so that
        switching between the per-step path and the loop mid-training is
        seamless."""
        mod = self._module
        if mod._exec_group.execs[0] is not self._exec:
            raise MXNetError("FusedTrainLoop: the module was bound again; "
                             "make a new loop")
        if mod._kvstore is not None:
            raise MXNetError("FusedTrainLoop: kvstore-backed updates not "
                             "supported; init_optimizer(kvstore=None)")
        weights = [self._exec.arg_arrays[i] for i in self._diff_idx]
        if mod._optimizer is not self._optimizer:
            scan_step = mod._optimizer.make_scan_step(self._opt_indices,
                                                      weights)
            if scan_step is None:
                raise MXNetError("FusedTrainLoop: optimizer %r has no scan "
                                 "step form" % type(mod._optimizer).__name__)
            self._optimizer, self._scan_step = mod._optimizer, scan_step
        self._state_objs = [mod._updater._state(idx, w)
                            for idx, w in zip(self._opt_indices, weights)]

    # -- the step -----------------------------------------------------------
    def _states(self):
        return self._scan_step.pack_states(self._state_objs)

    def _step(self, groups):
        """One whole training step on the executor's tensors, in place;
        returns the outputs."""
        ex = self._exec
        vals = [a._data for a in ex.arg_arrays]
        leaves = []
        for i in self._diff_idx:
            vals[i] = vals[i].detach().requires_grad_(True)
            leaves.append(vals[i])
        aux = [a._data for a in ex.aux_arrays]
        with torch.enable_grad():
            outs, aux_new = ex._train_fn(vals, aux)
        grads = torch.autograd.grad(outs, leaves,
                                    [torch.ones_like(o) for o in outs],
                                    allow_unused=True)
        grads = [torch.zeros_like(l) if g is None else g
                 for g, l in zip(grads, leaves)]
        with torch.no_grad():
            self._scan_step.step([ex.arg_arrays[i]._data
                                  for i in self._diff_idx],
                                 self._states(), grads, self._lr_row, groups)
            for a, v in zip(aux, aux_new):
                if v is not a:
                    a.copy_(v)
        return [o.detach() for o in outs]

    # -- the graph ----------------------------------------------------------
    def _mutable_tensors(self):
        """What a step writes: the trained parameters, their states, the
        aux states."""
        ex = self._exec
        states = self._states()
        flat = [t for part in states for t in part] \
            if isinstance(states, tuple) else list(states)
        return [ex.arg_arrays[i]._data for i in self._diff_idx] + flat + \
            [a._data for a in ex.aux_arrays]

    def _ensure_graph(self, groups):
        """Capture the step's graph unless the one held was captured on
        the same tensors by the same scan step with the same groups of
        equal rates."""
        ex = self._exec
        key = (self._scan_step, tuple(groups), tuple(
            t.data_ptr() for t in [a._data for a in ex.arg_arrays]
            + self._mutable_tensors()))
        if self._graph is not None and key == self._graph_key:
            return
        self._graph, self._static_outs = None, []
        t0 = time.monotonic()
        dev = ex._ctx
        mutable = self._mutable_tensors()
        gen = _rnd.generator(dev) if ex._has_rng else None
        with torch.no_grad():
            saved = [t.clone() for t in mutable]
        gen_state = gen.get_state() if gen is not None else None
        side = _WARMUP_STREAMS.get(dev)
        if side is None:
            side = _WARMUP_STREAMS[dev] = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            for _ in range(_WARMUP_STEPS):
                self._step(groups)
        torch.cuda.current_stream(dev).wait_stream(side)
        with torch.no_grad():  # undo the warm-up's updates
            for t, s in zip(mutable, saved):
                t.copy_(s)
        del saved
        if gen is not None:
            gen.set_state(gen_state)
        graph = torch.cuda.CUDAGraph()
        if gen is not None:
            graph.register_generator_state(gen)
        with torch.cuda.graph(graph):
            outs = self._step(groups)
        torch.cuda.synchronize(dev)
        self._graph, self._static_outs = graph, outs
        self._graph_key = key
        self.captures += 1
        self.capture_seconds = time.monotonic() - t0

    # -- data staging -------------------------------------------------------
    def stack_batches(self, batches: Sequence[Any]) -> List[torch.Tensor]:
        """K DataBatches as one (K, ...) tensor per data and label
        argument, on the executor's device in the argument's dtype."""
        if len(batches) != self._K:
            raise MXNetError("expected %d batches, got %d"
                             % (self._K, len(batches)))
        mod = self._module
        stacks = []
        for i in self._data_idx:
            name = self._arg_names[i]
            if name in mod._data_names:
                slot = mod._data_names.index(name)
                vals = [b.data[slot] for b in batches]
            else:
                slot = mod._label_names.index(name)
                vals = [b.label[slot] for b in batches]
            want = self._exec.arg_arrays[i]._data
            stacks.append(torch.stack([
                (v._data if isinstance(v, NDArray)
                 else torch.as_tensor(np.asarray(v))).to(
                     device=want.device, dtype=want.dtype) for v in vals]))
        return stacks

    # -- execution ----------------------------------------------------------
    def run_stacked(self, data_stack: List[Any]):
        """Run K steps over staged (K, ...) stacks (tensors or NDArrays,
        in the order of ``stack_batches``).  Returns the outputs as (K,
        ...) NDArrays when collecting, else None."""
        ex = self._exec
        K = self._K
        self._bind_optimizer()
        slots = [ex.arg_arrays[i]._data for i in self._data_idx]
        stacks = [s._data if isinstance(s, NDArray) else s
                  for s in data_stack]
        if len(stacks) != len(slots) or any(
                tuple(s.shape) != (K,) + tuple(t.shape)
                for s, t in zip(stacks, slots)):
            raise MXNetError("expected stacks of shapes %s, got %s"
                             % ([(K,) + tuple(t.shape) for t in slots],
                                [tuple(s.shape) for s in stacks]))
        rows = self._scan_step.host_sched(K)
        groups = lr_groups(rows)
        lr_rows = torch.from_numpy(rows).to(ex._ctx)
        graphed = ex._ctx.type == "cuda" and self.capturable
        if graphed:
            self._lr_row.copy_(lr_rows[0])
            self._ensure_graph(groups)
        collected = None
        with torch.no_grad():
            for k in range(K):
                for slot, stack in zip(slots, stacks):
                    slot.copy_(stack[k])
                self._lr_row.copy_(lr_rows[k])
                if graphed:
                    self._graph.replay()
                    outs = self._static_outs
                else:
                    outs = self._step(groups)
                if self.collect_outputs:
                    if collected is None:
                        collected = [o.new_empty((K,) + tuple(o.shape))
                                     for o in outs]
                    for c, o in zip(collected, outs):
                        c[k].copy_(o)
        self._optimizer.commit_scan_steps(self._opt_indices, K)
        self._publish()
        return [NDArray(c) for c in collected] \
            if self.collect_outputs else None

    def run(self, batches: Sequence[Any]):
        """Stage K DataBatches and run them as one call."""
        return self.run_stacked(self.stack_batches(batches))

    def _publish(self):
        """The loop writes the executor's and the updater's own tensors
        in place: only the Module's host copies go stale."""
        self._module._params_dirty = True

    def finalize(self):
        """Kept for the JAX package's API: the state is published after
        every call."""
        self._publish()
