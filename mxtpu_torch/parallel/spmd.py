"""One controller driving every shard of a mesh: the port's stand-in for
``shard_map`` and ``jax.lax.p*``.

A program over a mesh keeps, for each value, a list with one tensor per
mesh coordinate (``mesh.coords`` order), each on that coordinate's
device.  Its body runs in lock-step: each stage maps a function over
the coordinates (:func:`pmap`), and the group collectives sit between
stages.  A collective over a mesh axis takes the list and returns the
list of results; it is made of ``.to(device)`` copies and torch ops, so
autograd flows through it, and the gradient of a :func:`psum` is the
psum of the cotangents, as in JAX.  Nothing runs on streams of its own.

A global value laid out on a mesh is a :class:`Sharded`: the shard
list, the mesh and the :class:`PartitionSpec` that says which mesh axes
split which dimensions (a dimension split over several axes takes them
in row-major order, outermost first, as in JAX).  :func:`shard` splits
a global tensor by a spec, :func:`gather` assembles it back, and
:func:`device_put` with a :class:`NamedSharding` does the former for
arrays and the relayout for sharded values.
"""
from __future__ import annotations

from typing import Iterable, List, Sequence, Tuple

import numpy as np
import torch

from ..base import MXNetError
from .mesh import Mesh

__all__ = ["PartitionSpec", "P", "NamedSharding", "Sharded", "shard",
           "gather", "device_put", "zeros", "pmap", "groups", "axis_index",
           "psum", "pmax", "all_gather", "psum_scatter", "ppermute",
           "all_to_all", "sub_mesh"]


class PartitionSpec(tuple):
    """Per dimension: None (not split), a mesh axis name, or a tuple of
    names; trailing dimensions absent from the spec are not split."""

    def __new__(cls, *parts):
        return tuple.__new__(cls, parts)

    def __repr__(self):
        return "P(%s)" % ", ".join(repr(p) for p in self)


P = PartitionSpec


class NamedSharding(object):
    """A layout: ``spec`` over ``mesh``."""

    def __init__(self, mesh: Mesh, spec):
        self.mesh = mesh
        self.spec = PartitionSpec(*spec)

    def __repr__(self):
        return "NamedSharding(%r, %r)" % (self.mesh, self.spec)


def _axes(part) -> Tuple[str, ...]:
    if part is None:
        return ()
    return (part,) if isinstance(part, str) else tuple(part)


def _blocks(mesh: Mesh, spec, shape) -> List[Tuple[slice, ...]]:
    """Each coordinate's block of a global array of ``shape``."""
    spec = tuple(spec)
    if len(spec) > len(shape):
        raise MXNetError("spec %r has more dimensions than shape %s"
                         % (spec, tuple(shape)))
    split = []
    for dim, size in enumerate(shape):
        axes = _axes(spec[dim]) if dim < len(spec) else ()
        n = int(np.prod([mesh.shape[a] for a in axes])) if axes else 1
        if size % n:
            raise MXNetError("dimension %d of %s does not divide over %r "
                             "(%d shards)" % (dim, tuple(shape), axes, n))
        split.append((axes, size // n))
    pos = {a: mesh.axis_position(a) for a in mesh.axis_names}
    out = []
    for coord in mesh.coords:
        idx = []
        for axes, chunk in split:
            k = 0
            for a in axes:
                k = k * mesh.shape[a] + coord[pos[a]]
            idx.append(slice(k * chunk, (k + 1) * chunk))
        out.append(tuple(idx))
    return out


class Sharded(object):
    """A global array laid out on ``mesh`` by ``spec``: ``shards[i]`` is
    the block at ``mesh.coords[i]``, on that coordinate's device."""

    def __init__(self, shards: Sequence[torch.Tensor], mesh: Mesh, spec,
                 shape=None):
        if len(shards) != mesh.size:
            raise MXNetError("%d shards for a mesh of %d"
                             % (len(shards), mesh.size))
        self.shards = list(shards)
        self.mesh = mesh
        self.spec = PartitionSpec(*spec)
        if shape is None:
            local = tuple(self.shards[0].shape)
            shape = tuple(s * _split_count(mesh, self.spec, d)
                          for d, s in enumerate(local))
        self.shape = tuple(int(s) for s in shape)

    @property
    def dtype(self) -> torch.dtype:
        return self.shards[0].dtype

    @property
    def nbytes(self) -> int:
        """Bytes of the global array (as a sharded ``jax.Array``'s
        ``nbytes``)."""
        return int(np.prod(self.shape)) * self.shards[0].element_size()

    def device_nbytes(self) -> List[int]:
        """Bytes each coordinate holds."""
        return [t.numel() * t.element_size() for t in self.shards]

    def gather(self, device=None) -> torch.Tensor:
        return gather(self, device)

    def __repr__(self):
        return "Sharded(%s %s, %r over %r)" % (
            tuple(self.shape), str(self.dtype).replace("torch.", ""),
            self.spec, self.mesh)


def _split_count(mesh, spec, dim):
    axes = _axes(spec[dim]) if dim < len(spec) else ()
    return int(np.prod([mesh.shape[a] for a in axes])) if axes else 1


def _as_tensor(x) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x
    data = getattr(x, "_data", None)  # an NDArray
    if isinstance(data, torch.Tensor):
        return data
    arr = np.asarray(x)
    if arr.dtype.name == "bfloat16":
        return torch.from_numpy(arr.view(np.int16).copy()).view(
            torch.bfloat16)
    return torch.from_numpy(np.ascontiguousarray(arr))


def shard(x, mesh: Mesh, spec) -> Sharded:
    """``x`` (a tensor, a numpy array or an NDArray) split by ``spec``:
    each coordinate gets its own contiguous copy of its block on its
    device, so no two shards share memory."""
    x = _as_tensor(x)
    shards = []
    for coord, blk in zip(mesh.coords, _blocks(mesh, spec, x.shape)):
        part = x[blk]
        shards.append(torch.empty(part.shape, dtype=part.dtype,
                                  device=mesh.device_at(coord)).copy_(part))
    return Sharded(shards, mesh, spec, shape=x.shape)


def zeros(shape, dtype, mesh: Mesh, spec) -> Sharded:
    """A zero array of global ``shape`` laid out by ``spec``."""
    shards = []
    for coord, blk in zip(mesh.coords, _blocks(mesh, spec, shape)):
        local = [s.stop - s.start for s in blk]
        shards.append(torch.zeros(local, dtype=dtype,
                                  device=mesh.device_at(coord)))
    return Sharded(shards, mesh, spec, shape=shape)


def gather(s: Sharded, device=None) -> torch.Tensor:
    """The global array of ``s`` on ``device`` (default the mesh's first
    device); a block held by several coordinates is read from the first
    of them."""
    device = s.mesh.device if device is None else device
    out = torch.empty(s.shape, dtype=s.dtype, device=device)
    seen = set()
    for t, blk in zip(s.shards, _blocks(s.mesh, s.spec, s.shape)):
        key = tuple((b.start, b.stop) for b in blk)
        if key not in seen:
            seen.add(key)
            out[blk] = t.to(device)
    return out


def device_put(x, sharding: NamedSharding) -> Sharded:
    """``x`` laid out as ``sharding`` says: an array is split; a
    :class:`Sharded` value is gathered and split again."""
    if isinstance(x, Sharded):
        x = gather(x)
    return shard(x, sharding.mesh, sharding.spec)


# -- the lock-step body -------------------------------------------------------

def pmap(fn, *args):
    """``[fn(*a) for a in zip(*args)]``: ``fn`` at every coordinate.  A
    function returning a tuple gives a tuple of lists."""
    out = [fn(*a) for a in zip(*args)]
    if out and isinstance(out[0], tuple):
        return tuple(list(x) for x in zip(*out))
    return out


def groups(mesh: Mesh, axes) -> List[List[int]]:
    """The coordinates (indices into ``mesh.coords``) that differ only
    along ``axes`` (a name or a tuple), each group ordered by its index
    along ``axes`` (row-major, in the order given)."""
    axes = _axes(axes)
    pos = [mesh.axis_position(a) for a in axes]
    found = {}
    for i, coord in enumerate(mesh.coords):
        key = tuple(c for d, c in enumerate(coord) if d not in pos)
        found.setdefault(key, []).append(i)
    out = []
    for members in found.values():
        members.sort(key=lambda i: tuple(mesh.coords[i][p] for p in pos))
        out.append(members)
    return out


def axis_index(mesh: Mesh, axis: str) -> List[int]:
    """Each coordinate's index along ``axis``."""
    p = mesh.axis_position(axis)
    return [coord[p] for coord in mesh.coords]


def _per_device(xs, members, make):
    """``make(device)`` once for each distinct device of the group's
    members; returns {device: result}."""
    done = {}
    for i in members:
        dev = xs[i].device
        if dev not in done:
            done[dev] = make(dev)
    return done


def psum(mesh: Mesh, xs, axes) -> list:
    """Sum over each group along ``axes``; every member gets the sum
    (computed once per device, in group order, and shared by the
    members on that device)."""
    out = list(xs)
    for members in groups(mesh, axes):
        if len(members) == 1:
            continue

        def total(dev, members=members):
            acc = xs[members[0]].to(dev)
            for j in members[1:]:
                acc = acc + xs[j].to(dev)
            return acc

        sums = _per_device(xs, members, total)
        for i in members:
            out[i] = sums[xs[i].device]
    return out


def pmax(mesh: Mesh, xs, axes) -> list:
    """Elementwise max over each group along ``axes`` (for values that
    carry no gradient, as ``lax.pmax`` has no AD rule)."""
    out = list(xs)
    for members in groups(mesh, axes):
        def most(dev, members=members):
            acc = xs[members[0]].to(dev)
            for j in members[1:]:
                acc = torch.maximum(acc, xs[j].to(dev))
            return acc

        maxes = _per_device(xs, members, most)
        for i in members:
            out[i] = maxes[xs[i].device]
    return out


def all_gather(mesh: Mesh, xs, axis: str, dim: int = 0,
               tiled: bool = True) -> list:
    """Every member gets the group's values in axis order, concatenated
    along ``dim`` (``tiled``) or stacked on a new ``dim``."""
    out = list(xs)
    for members in groups(mesh, axis):
        def joined(dev, members=members):
            parts = [xs[j].to(dev) for j in members]
            return torch.cat(parts, dim) if tiled else torch.stack(parts, dim)

        res = _per_device(xs, members, joined)
        for i in members:
            out[i] = res[xs[i].device]
    return out


def psum_scatter(mesh: Mesh, xs, axis: str, dim: int = 0,
                 tiled: bool = True) -> list:
    """The group's sum, split along ``dim`` into one block per member:
    member k keeps block k (``tiled``; otherwise ``dim`` has the group's
    size and member k keeps index k)."""
    summed = psum(mesh, xs, axis)
    out = list(xs)
    for members in groups(mesh, axis):
        n = len(members)
        for k, i in enumerate(members):
            t = summed[i]
            if tiled:
                c = t.shape[dim] // n
                out[i] = t.narrow(dim, k * c, c)
            else:
                out[i] = t.select(dim, k)
    return out


def ppermute(mesh: Mesh, xs, axis: str, perm: Iterable) -> list:
    """``(src, dst)`` pairs of indices along ``axis``: the member at
    ``dst`` gets the value of the member at ``src`` on its own device; a
    member that is no destination gets zeros.  A source that holds None
    (a pipeline stage with nothing to send) sends None."""
    sent = {int(d): int(s) for s, d in perm}
    out = list(xs)
    for members in groups(mesh, axis):
        for k, i in enumerate(members):
            dev = mesh.device_at(mesh.coords[i])
            if k not in sent:
                out[i] = None if xs[i] is None else torch.zeros_like(xs[i])
                continue
            src = xs[members[sent[k]]]
            out[i] = None if src is None else src.to(dev)
    return out


def sub_mesh(mesh: Mesh, axis: str, index: int):
    """The coordinates whose index along ``axis`` is ``index``: (their
    indices into ``mesh.coords``, and the mesh of them, with ``axis`` at
    size 1, whose coordinates come in the same order)."""
    p = mesh.axis_position(axis)
    members = [i for i, c in enumerate(mesh.coords) if c[p] == index]
    return members, Mesh(mesh.devices.take([index], axis=p),
                         mesh.axis_names)


def all_to_all(mesh: Mesh, xs, axis: str, split_axis: int,
               concat_axis: int, tiled: bool = True) -> list:
    """Member k gets block k of every member's value split along
    ``split_axis``, concatenated along ``concat_axis`` in axis order
    (``tiled``; otherwise ``split_axis`` has the group's size, and the
    blocks are stacked on a new ``concat_axis``)."""
    out = list(xs)
    for members in groups(mesh, axis):
        n = len(members)
        for k, i in enumerate(members):
            dev = xs[i].device
            if tiled:
                parts = [xs[j].to(dev).chunk(n, split_axis)[k]
                         for j in members]
                out[i] = torch.cat(parts, concat_axis)
            else:
                parts = [xs[j].to(dev).select(split_axis, k)
                         for j in members]
                out[i] = torch.stack(parts, concat_axis)
    return out
