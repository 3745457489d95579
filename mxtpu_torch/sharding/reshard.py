"""reshard: move values between two ShardingPlans' layouts.

Counterpart of ``mxtpu/sharding/reshard.py``: the train <-> serve move
(arXiv 2112.01075).  Each leaf is laid out as ``plan_b`` prescribes, one
:func:`~mxtpu_torch.parallel.spmd.device_put` a leaf; a plan without a
mesh gathers each leaf into one tensor.  The JAX function's
bookkeeping (its ``mx.inspect`` record, the telemetry event and
``profiler``'s ``reshard_bytes``) comes with those modules (ROADMAP
A18).
"""
from __future__ import annotations

from typing import Any, Optional

from ..base import MXNetError
from ..ndarray.ndarray import NDArray
from ..parallel import spmd
from .plan import ShardingPlan

__all__ = ["reshard"]


def reshard(tree: Any, plan_b: ShardingPlan,
            plan_a: Optional[ShardingPlan] = None,
            kind: str = "params", label: str = "default") -> Any:
    """``tree`` (a dict name -> value, or one value: a tensor, a numpy
    array, an NDArray or a :class:`~mxtpu_torch.parallel.spmd.Sharded`)
    laid out as ``plan_b`` prescribes.

    ``kind`` picks the spec family: ``"params"`` uses
    :meth:`ShardingPlan.spec_for`, ``"opt_state"``
    :meth:`ShardingPlan.opt_state_spec`.  With a mesh on ``plan_b`` each
    leaf becomes a ``Sharded``; without one it is gathered into one
    tensor on the device of its first shard (an NDArray stays one).
    ``plan_a`` and ``label`` name the move for the bookkeeping that
    comes with A18.  Returns a new tree; the inputs are not changed."""
    if kind not in ("params", "opt_state"):
        raise MXNetError("reshard kind must be 'params' or 'opt_state'")
    single = not isinstance(tree, dict)
    items = {"_": tree} if single else dict(tree)
    moved = {}
    for name, val in items.items():
        if plan_b.mesh is None:
            if isinstance(val, spmd.Sharded):
                moved[name] = val.gather()
            elif isinstance(val, NDArray):
                moved[name] = NDArray(val._data.clone())
            else:
                moved[name] = spmd._as_tensor(val).clone()
            continue
        raw = val if isinstance(val, spmd.Sharded) else spmd._as_tensor(val)
        spec = (plan_b.spec_for(name, raw.shape) if kind == "params"
                else plan_b.opt_state_spec(name, raw.shape))
        moved[name] = spmd.device_put(raw, plan_b.named_sharding(spec))
    return moved["_"] if single else moved
