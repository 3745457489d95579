"""The PyTorch port's dgl graph ops (`mxtpu_torch/ops/dgl.py`) against
the JAX package's (`mxtpu/ops/dgl.py`) on the CPU, in the dense edge-id
layout both keep (`A[u, v] = edge id + 1`).

The neighbor sampler is fed the JAX package's own draws: the uniform
(V, V) arrays `jax.random.uniform(minval=1e-6)` makes from the split
keys, one a hop.  With them the port's sampler (`neighbor_sample`) and
both sampling ops (their draws replaced by the same arrays) must give
`mxtpu`'s vertices, subgraphs, layers and weights exactly, for one and
for several seed arrays, with the vertex list cut at and padded past
`max_num_vertices`.  Without them the ops are held by their contracts
and their pick frequencies (`test_torch_op_cases.dgl_contracts`), and
the other ops (edge ids, adjacency, induced subgraphs, compaction,
`_copyto`, `_scatter_elemwise_div`) are held equal to `mxtpu`'s.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mxtpu as jmx
import mxtpu_torch as tmx
from mxtpu.ops import dgl as jdgl
from mxtpu_torch.ops import dgl as tdgl
from test_torch_op_cases import dgl_contracts, edge_id_graph

torch.set_num_threads(1)


def jax_draws(key, hops, n):
    """The draws of mxtpu's `_neighbor_sample` from ``key``."""
    out = []
    for _ in range(hops):
        key, sub = jax.random.split(key)
        out.append(np.asarray(jax.random.uniform(sub, (n, n), minval=1e-6,
                                                 maxval=1.0)))
    return out


def ids(values):
    return np.asarray(values, np.int32)


CASES = [  # (V, p, seeds, hops, num_neighbor, max_num_vertices, weighted)
    (60, 0.08, [0, 7, 13, -1, -1], 2, 3, 40, False),
    (60, 0.08, [0, 7, 13, -1, -1], 2, 3, 40, True),
    (30, 0.2, [4, -1], 3, 2, 40, False),
    (80, 0.1, [1, 2, 3, 4, 5, 6], 2, 4, 12, True),
]


@pytest.mark.parametrize("case", range(len(CASES)))
def test_sampler_with_mxtpus_draws_is_exact(case):
    V, p, seeds, hops, k, M, weighted = CASES[case]
    g = edge_id_graph(V, p, seed=case)
    prob = np.random.RandomState(10 + case).uniform(0.05, 1.0, V) \
        .astype(np.float32) if weighted else None
    key = jax.random.PRNGKey(case)
    # one compiled program: mxtpu's sampler is jittable (static shapes)
    want = jax.jit(jdgl._neighbor_sample, static_argnums=(4, 5, 6))(
        key, jnp.asarray(g), jnp.asarray(ids(seeds)),
        None if prob is None else jnp.asarray(prob), hops, k, M)
    got = tdgl.neighbor_sample(
        torch.from_numpy(g), torch.from_numpy(ids(seeds)),
        None if prob is None else torch.from_numpy(prob),
        [torch.from_numpy(r) for r in jax_draws(key, hops, V)], k, M)
    for name, t, j in zip(("vertices", "subgraph", "layers"), got, want):
        t, j = t.numpy(), np.asarray(j)
        assert t.shape == j.shape, (name, t.shape, j.shape)
        np.testing.assert_array_equal(t, j, err_msg=name)
    assert (got[0] >= 0).sum() > len([s for s in seeds if s >= 0])


@pytest.mark.parametrize("weighted", [False, True])
def test_sampling_ops_with_mxtpus_draws(weighted, monkeypatch):
    """Both ops, two seed arrays: the outputs' count, order, dtypes'
    kinds and values."""
    V = 50
    g = edge_id_graph(V, 0.1, seed=3)
    prob = np.random.RandomState(4).uniform(0.1, 1.0, V).astype(np.float32)
    seeds = [ids([0, 5, -1]), ids([9, 11, 20])]
    attrs = dict(num_args=len(seeds) + 1 + weighted, num_hops=2,
                 num_neighbor=3, max_num_vertices=25)
    key = jax.random.PRNGKey(7)
    extra = [prob] if weighted else []
    fn = jdgl._dgl_neighbor_non_uniform if weighted \
        else jdgl._dgl_neighbor_uniform
    want = jax.jit(lambda *a: fn(*a, **attrs))(
        key, jnp.asarray(g), *[jnp.asarray(x) for x in extra + seeds])
    draws = [torch.from_numpy(r) for r in jax_draws(key, 2, V)]
    monkeypatch.setattr(tdgl, "sample_draws", lambda *a: draws)
    name = "dgl_csr_neighbor_%suniform_sample" % ("non_" if weighted else "")
    got = getattr(tmx.nd.contrib, name)(
        *[tmx.nd.array(x, ctx=tmx.cpu(), dtype=x.dtype)
          for x in [g] + extra + seeds], **attrs)
    assert len(got) == len(want) == (4 if weighted else 3) * len(seeds)
    for t, j in zip(got, want):
        t, j = t.asnumpy(), np.asarray(j)
        assert t.shape == j.shape and t.dtype.kind == j.dtype.kind
        np.testing.assert_array_equal(t, j)


def test_sampling_ops_hold_their_contracts():
    tmx.random.seed(11)
    for name, bad in dgl_contracts(tmx, tmx.cpu()):
        assert bad is None, (name, bad)


def both(op, *inputs, **attrs):
    outs = []
    for M in (jmx, tmx):
        res = getattr(M.nd, op)(*[M.nd.array(x, ctx=M.cpu(), dtype=x.dtype)
                                  for x in inputs], **attrs)
        outs.append([o.asnumpy() for o in
                     (res if isinstance(res, list) else [res])])
    assert len(outs[0]) == len(outs[1])
    for j, t in zip(*outs):
        assert t.shape == j.shape
        np.testing.assert_array_equal(t, j)
    return outs[1]


def test_graph_ops_match():
    g = edge_id_graph(12, 0.3, seed=1)
    u, v = ids([0, 1, 2, 11, 5, 5]), ids([1, 3, 0, 11, 6, 7])
    eid, = both("_contrib_edge_id", g, u, v)
    np.testing.assert_array_equal(eid, g[u, v] - 1)
    adj, = both("_contrib_dgl_adjacency", g)
    np.testing.assert_array_equal(adj, (g != 0).astype(np.float32))
    vids = [ids([0, 2, 3, 7, -1]), ids([11, 4, -1, -1, -1])]
    subs = both("_contrib_dgl_subgraph", g, *vids, num_args=3,
                return_mapping=True)
    assert len(subs) == 4
    np.testing.assert_array_equal(subs[2][:4, :4], g[[0, 2, 3, 7]][
        :, [0, 2, 3, 7]])
    g2 = edge_id_graph(12, 0.5, seed=2)
    both("_contrib_dgl_graph_compact", g, g2, num_args=3,
         return_mapping=True, graph_sizes=(5, 9))
    x = np.random.RandomState(0).uniform(-1, 1, (3, 4)).astype(np.float32)
    y = np.random.RandomState(1).uniform(0.5, 2, (3, 4)).astype(np.float32)
    both("_scatter_elemwise_div", x, y)
    a = tmx.nd.array(x, ctx=tmx.cpu())
    c = tmx.nd._copyto(a)
    c[:] = 0
    np.testing.assert_array_equal(a.asnumpy(), x)  # a copy, not an alias
    both("_copyto", x)


def test_symbolic_shapes_match():
    """The ops in a Symbol: shapes inferred by running them on meta
    tensors equal `mxtpu`'s."""
    got = []
    for M in (jmx, tmx):
        s = M.sym
        g = s.Variable("g", shape=(30, 30))
        seeds = s.Variable("seeds", shape=(4,), dtype=np.int32)
        prob = s.Variable("prob", shape=(30,))
        out = s.Group(list(s.contrib.dgl_csr_neighbor_uniform_sample(
            g, seeds, num_args=2, num_hops=2, num_neighbor=3,
            max_num_vertices=12)) + list(
            s.contrib.dgl_csr_neighbor_non_uniform_sample(
                g, prob, seeds, num_args=3, num_hops=1, num_neighbor=2,
                max_num_vertices=9)) + [
            s.contrib.dgl_adjacency(g),
            s.contrib.edge_id(g, seeds, seeds),
            s.contrib.dgl_subgraph(g, seeds, num_args=2,
                                   return_mapping=True)[1]])
        _, shapes, _ = out.infer_shape()
        got.append([tuple(x) for x in shapes])
    assert got[1] == got[0]
    assert got[1][:3] == [(12,), (12, 12), (12,)]
