"""Rematerialization policies of the PyTorch port.

Counterpart of the part of ``mxtpu/executor.py`` that the transformer
uses: ``_REMAT_POLICIES`` and ``apply_remat`` (the rest of that module,
the symbolic executor, is not ported).  ``jax.checkpoint`` with a
policy becomes :func:`torch.utils.checkpoint.checkpoint` (non-reentrant)
with a selective-checkpoint policy: during the forward the policy marks
each ATen op's output as saved or as recomputed in the backward.

* ``"dots"`` (``dots_saveable``): the outputs of the matrix products are
  saved; everything else is recomputed.
* ``"dots_no_batch"`` (``dots_with_no_batch_dims_saveable``): only the
  products without a batch dimension are saved (``bmm`` is recomputed).
* ``"full"``: nothing is saved; the whole function is recomputed from
  its inputs.

Remat changes memory and recomputation, never values.  A hand-written
kernel launched through ctypes is not an ATen op: the policy never sees
it, so its ``torch.autograd.Function`` forward runs again in the
recompute (as ``dots_saveable`` does not save a Pallas call's outputs).
"""
from __future__ import annotations

import functools

import torch
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from .base import MXNetError

__all__ = ["apply_remat"]

_aten = torch.ops.aten
_UNBATCHED = frozenset({_aten.mm.default, _aten.mm.dtype,
                        _aten.addmm.default})
_REMAT_POLICIES = {
    # the ATen ops whose outputs each policy saves
    "dots": _UNBATCHED | {_aten.bmm.default},
    "dots_no_batch": _UNBATCHED,
    "full": frozenset(),
}


def _policy(saveable):
    """The selective-checkpoint policy that saves the outputs of the ops
    in ``saveable`` and recomputes the rest."""
    def policy(ctx, op, *args, **kwargs):
        return CheckpointPolicy.MUST_SAVE if op in saveable \
            else CheckpointPolicy.PREFER_RECOMPUTE
    return policy


def apply_remat(fn, policy_name):
    """``fn`` wrapped so that a differentiated call saves only what the
    named policy keeps ('full' = nothing, 'dots' = product outputs,
    'dots_no_batch' = unbatched product outputs) and recomputes the rest
    in the backward."""
    if policy_name not in _REMAT_POLICIES:
        raise MXNetError("remat policy must be one of %s (got %r)"
                         % (sorted(_REMAT_POLICIES), policy_name))
    saveable = _REMAT_POLICIES[policy_name]

    @functools.wraps(fn)
    def remat(*args):
        return checkpoint(fn, *args, use_reentrant=False,
                          context_fn=lambda: create_selective_checkpoint_contexts(
                              _policy(saveable)))
    return remat
