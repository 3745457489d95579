"""Eager collectives over a device mesh.

Counterpart of ``mxtpu/parallel/collectives.py``: ``all_reduce``,
``all_gather``, ``reduce_scatter``, ``all_to_all``,
``collective_permute``, ``psum_scalar`` and ``microbench``, with its
conventions.  The input's leading dimension stacks the per-device
contributions: it is split over the mesh axis (and the value is
replicated over the others), the group collective of :mod:`.spmd` runs
over the shards, and the result is assembled by the output's layout
(replicated for ``all_reduce`` and ``all_gather``, split over the axis
for the others).  The mesh resolves as in the JAX package: explicit,
then the innermost ``MeshContext``, then the active ShardingPlan's; an
axis of None is the plan's data axis.

Results are tensors on the mesh's first device (NDArrays when the input
was one).  The per-collective byte counters of ``profiler.stats()``
come with ``mx.profiler`` (ROADMAP A18).
"""
from __future__ import annotations

import time
from typing import Optional, Sequence

import numpy as np
import torch

from ..base import MXNetError
from . import spmd
from .mesh import current_mesh

__all__ = ["all_reduce", "all_gather", "reduce_scatter", "all_to_all",
           "collective_permute", "psum_scalar", "microbench"]


def _resolve_mesh(mesh):
    """Explicit mesh > MeshContext > the active ShardingPlan's mesh."""
    m = mesh if mesh is not None else current_mesh()
    if m is None:
        from ..sharding.plan import current_plan

        plan = current_plan()
        m = plan.mesh if plan is not None else None
    if m is None:
        raise MXNetError("no mesh: pass mesh=, enter a MeshContext, or "
                         "activate a ShardingPlan with one")
    return m


def _resolve_axis(axis: Optional[str], fallback: str = "dp") -> str:
    """None -> the active plan's data axis (else ``fallback``)."""
    if axis is not None:
        return axis
    from ..sharding.plan import current_plan

    plan = current_plan()
    return plan.data_axis if plan is not None else fallback


def _run(x, axis, mesh, body, out_split):
    """Split ``x`` over ``axis`` by its leading dimension, run ``body``
    on the shard list, and assemble the result (split over ``axis`` when
    ``out_split``, else replicated)."""
    from ..ndarray.ndarray import NDArray

    raw = spmd._as_tensor(x)
    sharded = spmd.shard(raw, mesh, spmd.P(axis))
    out = spmd.Sharded(body(sharded.shards), mesh,
                       spmd.P(axis) if out_split else spmd.P())
    y = out.gather()
    return NDArray(y) if isinstance(x, NDArray) else y


def all_reduce(x, axis: Optional[str] = "dp", mesh=None):
    """Sum the shards of ``x`` (leading dim = the axis size times the
    shard's) over ``axis``, returning the replicated sum: the eager
    ``psum``.  ``axis=None`` resolves from the active ShardingPlan."""
    mesh = _resolve_mesh(mesh)
    axis = _resolve_axis(axis)
    return _run(x, axis, mesh,
                lambda xs: spmd.psum(mesh, xs, axis), False)


def all_gather(x, axis: Optional[str] = "dp", mesh=None):
    """Gather the shards of ``x`` over ``axis``: the replicated whole."""
    mesh = _resolve_mesh(mesh)
    axis = _resolve_axis(axis)
    return _run(x, axis, mesh,
                lambda xs: spmd.all_gather(mesh, xs, axis), False)


def reduce_scatter(x, axis: Optional[str] = "dp", mesh=None):
    """Sum the n stacked contributions of ``x`` (as ``all_reduce``); the
    result is their elementwise sum, each device holding one tile (the
    global leading dim is ``x.shape[0] // n``)."""
    mesh = _resolve_mesh(mesh)
    axis = _resolve_axis(axis)
    return _run(x, axis, mesh,
                lambda xs: spmd.psum_scatter(mesh, xs, axis), True)


def all_to_all(x, axis: Optional[str] = "ep", mesh=None):
    """Each device's shard is split along dim 1 and block k sent to
    member k, which concatenates what it gets along dim 0."""
    mesh = _resolve_mesh(mesh)
    axis = _resolve_axis(axis, fallback="ep")
    return _run(x, axis, mesh,
                lambda xs: spmd.all_to_all(mesh, xs, axis, 1, 0), True)


def collective_permute(x, perm: Sequence, axis: Optional[str] = "dp",
                       mesh=None):
    """Move the shards of ``x`` along ``axis`` by the ``(src, dst)``
    pairs of ``perm``; a shard that is no destination becomes zeros."""
    mesh = _resolve_mesh(mesh)
    axis = _resolve_axis(axis)
    return _run(x, axis, mesh,
                lambda xs: spmd.ppermute(mesh, xs, axis, perm), True)


def psum_scalar(value: float, axis: Optional[str] = "dp",
                mesh=None) -> float:
    """All-reduce a host scalar (metric aggregation across devices)."""
    mesh = _resolve_mesh(mesh)
    axis = _resolve_axis(axis)
    n = mesh.shape[axis]
    arr = np.full((n,), float(value), dtype=np.float32)
    out = all_reduce(arr, axis=axis, mesh=mesh)
    return float(out.reshape(-1)[0])


def _sync(mesh):
    for dev in {d for d in mesh.devices.flat if d.type == "cuda"}:
        torch.cuda.synchronize(dev)


def microbench(mesh=None, n_bytes: int = 1 << 20, reps: int = 5):
    """Per-axis collective microbenchmark and numeric self-check.

    For every mesh axis of size > 1, runs all_reduce, all_gather,
    reduce_scatter, all_to_all and a ring collective_permute on an
    ``n_bytes`` float32 payload, checks each result (the sum, the
    reassembly, the rotation) and times the steady state on the host's
    clock.  Returns {axis: {collective: {"gb_s", "ms", "ok"}}}; the
    byte count follows the ring formulas (2(n-1)/n for all_reduce).
    A mesh whose devices repeat moves its shards between copies on one
    device: then it prints that the times are same-device copies, which
    measure no interconnect."""
    mesh = _resolve_mesh(mesh)
    if len(set(mesh.devices.flat)) < mesh.size:
        print("microbench: %r repeats devices: these are same-device "
              "copies, not an interconnect" % (mesh,), flush=True)
    n_elem = max(n_bytes // 4, 8)
    results = {}
    for axis, size in mesh.shape.items():
        if size < 2:
            continue
        k = max(n_elem // size, size)
        k -= k % size
        shard = np.arange(size * k, dtype=np.float32).reshape(size, k)
        flat = shard.reshape(-1)
        ka = max(k // size, 1)
        a2a = np.arange(size * size * ka,
                        dtype=np.float32).reshape(size, size, ka)
        ring = [(i, (i + 1) % size) for i in range(size)]
        cases = {
            "all_reduce": (lambda: all_reduce(shard, axis=axis, mesh=mesh),
                           lambda out: np.allclose(out[0], shard.sum(0)),
                           2.0 * (size - 1) / size),
            "all_gather": (lambda: all_gather(flat, axis=axis, mesh=mesh),
                           lambda out: np.array_equal(out, flat),
                           float(size - 1) / size),
            "reduce_scatter": (lambda: reduce_scatter(flat, axis=axis,
                                                      mesh=mesh),
                               lambda out: np.allclose(out, shard.sum(0)),
                               float(size - 1) / size),
            "all_to_all": (lambda: all_to_all(a2a, axis=axis, mesh=mesh),
                           lambda out: np.array_equal(
                               out.reshape(size, size, ka),
                               np.swapaxes(a2a, 0, 1)),
                           float(size - 1) / size),
            "ppermute": (lambda: collective_permute(shard, ring, axis=axis,
                                                    mesh=mesh),
                         lambda out: np.array_equal(
                             out, np.roll(shard, 1, axis=0)),
                         1.0),
        }
        axis_res = {}
        for name, (fn, check, factor) in cases.items():
            out = fn()
            ok = bool(check(out.cpu().numpy()))
            _sync(mesh)
            t0 = time.perf_counter()
            for _ in range(reps):
                out = fn()
            _sync(mesh)
            dt = (time.perf_counter() - t0) / reps
            moved = factor * shard.nbytes
            axis_res[name] = {"ms": dt * 1e3,
                              "gb_s": moved / max(dt, 1e-9) / 1e9,
                              "ok": ok}
        results[axis] = axis_res
    return results
