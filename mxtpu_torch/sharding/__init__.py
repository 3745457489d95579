"""mx.shard: the sharding plan of the PyTorch port.

Counterpart of ``mxtpu/sharding/__init__.py``.  One
:class:`ShardingPlan` (data and model axes, per-parameter specs,
optimizer-state sharding on by default) is chosen once and read by
``mxtpu_torch.parallel``: the transformer's ZeRO-1 layout and the
collectives' mesh and axis.  :func:`reshard` moves parameters and state
between two plans' layouts.

Module's and Trainer's use of the plan, with ``ZeRO1Updater``, come with
several contexts (ROADMAP A15c); ``hbm_report`` with ``mx.hbm`` (A18).
"""
from __future__ import annotations

from .plan import (ShardingPlan, auto_plan, current_plan,
                   default_min_shard_elems, opt_state_sharding_default,
                   plan_scope, shard_requested)
from .zero1 import ZeRO1Updater, hbm_report, state_nbytes, tree_nbytes
from .reshard import reshard

__all__ = [
    "ShardingPlan", "ZeRO1Updater", "auto_plan", "current_plan",
    "default_min_shard_elems", "hbm_report",
    "opt_state_sharding_default", "plan_scope", "reshard",
    "shard_requested", "state_nbytes", "tree_nbytes",
]
