"""ShardingPlan: the one partitioning decision the stack reads.

Counterpart of ``mxtpu/sharding/plan.py``.  A plan names the mesh axes
(the data axis for replicas, the model axis for tensor parallelism),
carries per-parameter :class:`~mxtpu_torch.parallel.spmd.PartitionSpec`
overrides, and decides once whether optimizer state is split across
the data-parallel replicas (ZeRO-1, arXiv 2004.13336).  Two modes share
one plan object:

* **host-replica** (a replica count, ``num_shards``): :meth:`shard_dim`
  and :meth:`shard_slice` place each replica's chunk;
* **SPMD** (a port :class:`~mxtpu_torch.parallel.mesh.Mesh`):
  :meth:`spec_for` and :meth:`opt_state_spec` give the specs, and
  :meth:`named_sharding` the layouts ``spmd.device_put`` takes
  (``parallel/transformer.py``).

Environment (as in the JAX package):
  ``MXTPU_SHARD``            ``zero1``/``1``/``on``: a process-wide plan
                             when no scope is active
  ``MXTPU_SHARD_OPT_STATE``  default ``1``: optimizer-state sharding on
  ``MXTPU_SHARD_MIN_SIZE``   default ``4096``: the smallest parameter (in
                             elements) whose state is split
"""
from __future__ import annotations

import copy
import threading
from typing import Any, Dict, Optional, Sequence, Tuple

import numpy as np

from ..base import MXNetError, getenv
from ..parallel.spmd import NamedSharding, PartitionSpec

__all__ = ["ShardingPlan", "current_plan", "plan_scope", "auto_plan",
           "shard_requested", "default_min_shard_elems",
           "opt_state_sharding_default"]

_state = threading.local()


def default_min_shard_elems() -> int:
    """MXTPU_SHARD_MIN_SIZE: the smallest parameter (in elements) whose
    optimizer state is worth splitting."""
    v = getenv("MXTPU_SHARD_MIN_SIZE")
    return int(v) if v else 4096


def opt_state_sharding_default() -> bool:
    """MXTPU_SHARD_OPT_STATE: ZeRO-1 state sharding by default (on)."""
    return (getenv("MXTPU_SHARD_OPT_STATE") or "1").lower() \
        not in ("0", "off", "false", "none")


class ShardingPlan(object):
    """One partitioning decision: axes, per-parameter specs, ZeRO-1 on
    or off.

    Parameters
    ----------
    num_shards : int, optional
        The replica count of host-replica mode.  Defaults to the mesh's
        ``data_axis`` size when a mesh is given; a plan with neither
        resolves later (:meth:`resolved`).
    mesh : Mesh, optional
        The SPMD mesh (None = host-replica mode).
    data_axis / model_axis : str
        The mesh axes of replicas and of tensor parallelism.
    param_specs : dict name -> PartitionSpec, optional
        Model-parallel placements; the other parameters are replicated.
    shard_optimizer_state : bool, optional
        ZeRO-1 on/off; defaults to ``MXTPU_SHARD_OPT_STATE`` (on).
    shard_data : bool
        SPMD mode: split the batch of the data inputs over
        ``data_axis`` (off by default).
    data_names : sequence of str
        Variable names :meth:`spec_for` treats as data and labels.
    min_shard_elems : int, optional
        The element count below which state stays replicated.
    """

    def __init__(self, num_shards: Optional[int] = None, mesh=None,
                 data_axis: str = "dp", model_axis: str = "tp",
                 param_specs: Optional[Dict[str, Any]] = None,
                 shard_optimizer_state: Optional[bool] = None,
                 shard_data: bool = False,
                 data_names: Sequence[str] = ("data", "softmax_label"),
                 min_shard_elems: Optional[int] = None,
                 name: Optional[str] = None):
        self.mesh = mesh
        self.data_axis = data_axis
        self.model_axis = model_axis
        self.param_specs = dict(param_specs or {})
        self.shard_data = bool(shard_data)
        self.data_names = tuple(data_names)
        self.min_shard_elems = (default_min_shard_elems()
                                if min_shard_elems is None
                                else int(min_shard_elems))
        self.shard_optimizer_state = (opt_state_sharding_default()
                                      if shard_optimizer_state is None
                                      else bool(shard_optimizer_state))
        self.name = name
        if num_shards is None and mesh is not None:
            num_shards = int(mesh.shape.get(data_axis, 1))
        self._num_shards = None if num_shards is None else int(num_shards)

    # -- sizing ----------------------------------------------------------
    @property
    def num_shards(self) -> int:
        """The replica count; 1 while unresolved."""
        return self._num_shards if self._num_shards is not None else 1

    @property
    def resolved_explicitly(self) -> bool:
        return self._num_shards is not None

    def resolved(self, num_shards: int) -> "ShardingPlan":
        """This plan bound to a replica count: itself when it matches, a
        pinned copy when it was never pinned; raises on a conflict."""
        num_shards = int(num_shards)
        if self._num_shards is None:
            out = copy.copy(self)
            out._num_shards = num_shards
            return out
        if self._num_shards != num_shards:
            raise MXNetError(
                "ShardingPlan pinned to %d shards cannot drive %d "
                "replicas" % (self._num_shards, num_shards))
        return self

    # -- ZeRO-1 placement -------------------------------------------------
    def shard_dim(self, name: str, shape: Sequence[int]) -> Optional[int]:
        """The dimension to split ``name``'s optimizer state over the
        data axis: the first dim not claimed by the parameter's model
        spec whose size divides ``num_shards``.  None: the state stays
        replicated (ZeRO-1 off, too small, or indivisible)."""
        n = self.num_shards
        if n <= 1 or not self.shard_optimizer_state:
            return None
        shape = tuple(int(s) for s in shape)
        if int(np.prod(shape)) < self.min_shard_elems:
            return None
        spec = self.param_specs.get(name, ())
        for i, size in enumerate(shape):
            ax = spec[i] if i < len(spec) else None
            if ax is None and size % n == 0:
                return i
        return None

    def shard_slice(self, shape: Sequence[int], dim: int,
                    rank: int) -> Tuple[slice, ...]:
        """The index of replica ``rank``'s 1/N chunk of a buffer of
        ``shape`` along ``dim``."""
        n = self.num_shards
        if not 0 <= rank < n:
            raise MXNetError("rank %d out of range for %d shards"
                             % (rank, n))
        step = int(shape[dim]) // n
        idx = [slice(None)] * len(shape)
        idx[dim] = slice(rank * step, (rank + 1) * step)
        return tuple(idx)

    # -- SPMD specs -------------------------------------------------------
    def spec_for(self, name: str, shape: Optional[Sequence[int]] = None):
        """The spec of variable ``name``: its model-parallel override,
        the data axis on the batch for data and labels (with
        ``shard_data``), else replicated."""
        if name in self.param_specs:
            return self.param_specs[name]
        if name in self.data_names and self.shard_data \
                and self.num_shards > 1:
            return PartitionSpec(self.data_axis)
        return PartitionSpec()

    def opt_state_spec(self, name: str, shape: Sequence[int]):
        """The spec of ``name``'s optimizer state: the parameter's, with
        the data axis on :meth:`shard_dim` (the ZeRO-1 placement)."""
        base = self.param_specs.get(name, ())
        spec = list(base) + [None] * (len(shape) - len(base))
        dim = self.shard_dim(name, shape)
        if dim is not None:
            spec[dim] = self.data_axis
        return PartitionSpec(*spec)

    def named_sharding(self, spec) -> NamedSharding:
        """``spec`` over this plan's mesh (SPMD mode only)."""
        if self.mesh is None:
            raise MXNetError("plan has no mesh: named_sharding is for "
                             "SPMD plans")
        return NamedSharding(self.mesh, spec)

    # -- identity ---------------------------------------------------------
    def describe(self) -> str:
        """A compact description of the plan."""
        mode = "zero1" if self.shard_optimizer_state else "repl"
        parts = ["%s:n=%d" % (mode, self.num_shards),
                 "axis=%s" % self.data_axis]
        if self.mesh is not None:
            parts.append("mesh=%s" % "x".join(
                str(s) for s in self.mesh.devices.shape))
        if self.shard_data:
            parts.append("data")
        if self.param_specs:
            parts.append("mp=%d" % len(self.param_specs))
        if self.name:
            parts.insert(0, self.name)
        return ",".join(parts)

    def __repr__(self):
        return "<ShardingPlan %s>" % self.describe()

    # -- activation -------------------------------------------------------
    def activate(self):
        """``with plan.activate():``: this plan is the current one in
        the block."""
        return plan_scope(self)


class plan_scope(object):
    """``with plan_scope(plan):`` pushes ``plan`` onto the thread's
    stack of current plans; ``plan_scope(None)`` masks an outer one."""

    def __init__(self, plan: Optional[ShardingPlan]):
        self._plan = plan

    def __enter__(self):
        if not hasattr(_state, "stack"):
            _state.stack = []
        _state.stack.append(self._plan)
        return self._plan

    def __exit__(self, *exc):
        _state.stack.pop()
        return False


_ENV_PLAN: Optional[ShardingPlan] = None


def current_plan() -> Optional[ShardingPlan]:
    """The innermost active plan.  With no scope ever entered,
    ``MXTPU_SHARD=zero1|1|on`` gives a process-wide plan (unpinned)."""
    global _ENV_PLAN
    stack = getattr(_state, "stack", None)
    if stack:
        return stack[-1]
    if (getenv("MXTPU_SHARD") or "").lower() in ("1", "zero1", "on"):
        if _ENV_PLAN is None:
            _ENV_PLAN = ShardingPlan(name="env")
        return _ENV_PLAN
    return None


def shard_requested() -> bool:
    """True when an active plan could shard anything."""
    return current_plan() is not None


def auto_plan(num_shards: Optional[int] = None, mesh=None,
              **kwargs) -> ShardingPlan:
    """A ZeRO-1 plan over ``num_shards`` replicas (or a mesh's data
    axis)."""
    return ShardingPlan(num_shards=num_shards, mesh=mesh, **kwargs)
