"""DGL graph ops of the PyTorch port (counterpart of ``mxtpu/ops/dgl.py``):
``_contrib_edge_id``, ``_contrib_dgl_adjacency``,
``_contrib_dgl_subgraph``, ``_contrib_dgl_csr_neighbor_uniform_sample``,
``_contrib_dgl_csr_neighbor_non_uniform_sample``,
``_contrib_dgl_graph_compact``, ``_copyto`` and
``_scatter_elemwise_div``.

The layout is the JAX package's: a dense (V, V) adjacency ``A`` with
``A[u, v] = edge_id + 1`` and 0 for no edge; vertex lists are padded
with -1 to ``max_num_vertices``; sampled subgraphs are vertex-induced;
``_contrib_dgl_graph_compact`` masks past each graph's size.

The neighbor sampler (:func:`neighbor_sample`) is a plain function of
the uniform draws ``r``, one (V, V) array a hop in [1e-6, 1): the ops
draw them from the device's generator, and a caller may pass the JAX
package's draws to compare vertices, layers and subgraphs exactly.  Per
hop each frontier vertex keeps its ``num_neighbor`` largest race keys
among its edges (``r``, or ``r ** (1 / w)`` with weights: the
exponential race), the winners marked by a scatter-max; ``topk`` ties
only at the zeros of non-edges, which the ``> 0`` test drops.  Vertices
are ordered seeds first, then by (hop, id), by a stable sort.  Vertex
ids and layers are int64.
"""
from __future__ import annotations

import torch

from .registry import register

__all__ = ["neighbor_sample", "sample_draws"]


@register("_contrib_edge_id", differentiable=False)
def _edge_id(data, u, v):
    """Edge ids of the (u, v) pairs; -1 where there is no edge."""
    return (data[u.long(), v.long()] - 1.0).to(data.dtype)


@register("_contrib_dgl_adjacency", differentiable=False)
def _dgl_adjacency(data):
    """The 0/1 adjacency of an edge-id graph."""
    return (data != 0).to(torch.float32)


def _induced(graph, vids):
    """The edge-id submatrix induced by a -1-padded vertex list."""
    vi = vids.long()
    valid = vi >= 0
    vc = vi.clamp(0, graph.shape[0] - 1)
    sub = graph[vc[:, None], vc[None, :]]
    mask = valid[:, None] & valid[None, :]
    return sub * mask.to(graph.dtype)


@register("_contrib_dgl_subgraph",
          num_outputs=lambda attrs: (int(attrs.get("num_args", 2)) - 1) *
          (2 if attrs.get("return_mapping") else 1),
          differentiable=False)
def _dgl_subgraph(graph, *vids, num_args=2, return_mapping=False):
    """Vertex-induced subgraphs of -1-padded vertex lists (0/1), and with
    ``return_mapping`` the parent's edge-id matrices."""
    subs, maps = [], []
    for v in vids:
        eid = _induced(graph, v)
        subs.append((eid != 0).to(torch.float32))
        if return_mapping:
            maps.append(eid)
    return tuple(subs + maps)


def sample_draws(gen, num_hops, n, device):
    """The sampler's draws: ``num_hops`` uniform (n, n) float32 arrays in
    [1e-6, 1), as the JAX package's ``jax.random.uniform(minval=1e-6)``."""
    return [torch.rand((n, n), generator=gen, device=device)
            * (1.0 - 1e-6) + 1e-6 for _ in range(int(num_hops))]


def neighbor_sample(graph, seeds, prob, draws, num_neighbor,
                    max_num_vertices):
    """The BFS sampler over the draws ``draws`` (one (V, V) array a hop):
    (vertices padded with -1, the induced subgraph, each vertex's hop)."""
    V = graph.shape[0]
    M = int(max_num_vertices)
    dev = graph.device
    si = seeds.long()
    sc = si.clamp(0, V - 1)
    selected = torch.zeros(V, dtype=torch.uint8, device=dev).scatter_reduce(
        0, sc, (si >= 0).to(torch.uint8), reduce="amax").bool()
    layer = torch.where(selected, 0, -1)
    frontier = selected
    adj = graph != 0
    k = min(int(num_neighbor), V)
    if prob is not None:
        w = prob.to(torch.float32).clamp(min=1e-9)
    for hop, r in enumerate(draws, start=1):
        if prob is not None:
            r = r ** (1.0 / w[None, :])
        race = torch.where(adj & frontier[:, None], r, 0.0)
        vals, idx = torch.topk(race, k, dim=1)
        won = vals > 0.0
        picked = torch.zeros(V, dtype=torch.uint8, device=dev).scatter_reduce(
            0, torch.where(won, idx, 0).reshape(-1),
            won.reshape(-1).to(torch.uint8), reduce="amax").bool()
        newly = picked & ~selected
        selected = selected | newly
        layer = torch.where(newly, hop, layer)
        frontier = newly
    ids = torch.arange(V, device=dev)
    order_key = torch.where(selected, layer * V + ids, 2 * V * V)
    take = min(M, V)
    verts = torch.argsort(order_key, stable=True)[:take]
    vvalid = selected[verts]
    if take < M:
        verts = torch.cat([verts, verts.new_zeros(M - take)])
        vvalid = torch.cat([vvalid, vvalid.new_zeros(M - take)])
    verts = torch.where(vvalid, verts, -1)
    sub = _induced(graph, verts)
    vlayer = torch.where(vvalid, layer[verts.clamp(min=0)], -1)
    return verts, sub, vlayer


def _interleave(outs):
    """One array a seed list: the outputs as is; several: all first
    outputs, then all second outputs..., as the JAX package orders them."""
    return tuple(x for group in zip(*outs) for x in group) \
        if len(outs) > 1 else outs[0]


@register("_contrib_dgl_csr_neighbor_uniform_sample",
          num_outputs=lambda attrs: 3 * (int(attrs.get("num_args", 2)) - 1),
          needs_rng=True, differentiable=False)
def _dgl_neighbor_uniform(gen, graph, *seeds, num_args=2, num_hops=1,
                          num_neighbor=2, max_num_vertices=100):
    """Uniform neighbor sampling: for each seed array, (vertices padded
    with -1, the sampled subgraph, each vertex's hop).  Every seed array
    reads the same draws, as the JAX package's reads the same key."""
    draws = sample_draws(gen, num_hops, graph.shape[0], graph.device)
    return _interleave([neighbor_sample(graph, s, None, draws, num_neighbor,
                                        max_num_vertices) for s in seeds])


@register("_contrib_dgl_csr_neighbor_non_uniform_sample",
          num_outputs=lambda attrs: 4 * (int(attrs.get("num_args", 3)) - 2),
          needs_rng=True, differentiable=False)
def _dgl_neighbor_non_uniform(gen, graph, prob, *seeds, num_args=3,
                              num_hops=1, num_neighbor=2,
                              max_num_vertices=100):
    """Weighted neighbor sampling: per seed array, (vertices, subgraph,
    layer, each vertex's weight)."""
    draws = sample_draws(gen, num_hops, graph.shape[0], graph.device)
    outs = []
    for s in seeds:
        v, sub, lay = neighbor_sample(graph, s, prob, draws, num_neighbor,
                                      max_num_vertices)
        pv = torch.where(v >= 0, prob[v.clamp(0, graph.shape[0] - 1)],
                         torch.zeros((), dtype=prob.dtype, device=v.device))
        outs.append((v, sub, lay, pv))
    return _interleave(outs)


@register("_contrib_dgl_graph_compact",
          num_outputs=lambda attrs: (int(attrs.get("num_args", 2)) - 1) *
          (2 if attrs.get("return_mapping") else 1),
          differentiable=False)
def _dgl_graph_compact(*graphs, num_args=2, return_mapping=False,
                       graph_sizes=()):
    """Each graph masked past its recorded size (0/1), and with
    ``return_mapping`` the masked edge-id matrices."""
    sizes = tuple(int(s) for s in (graph_sizes if graph_sizes else
                                   (graphs[0].shape[0],) * len(graphs)))
    outs, maps = [], []
    for g, n in zip(graphs, sizes):
        keep = torch.arange(g.shape[0], device=g.device) < n
        mask = (keep[:, None] & keep[None, :]).to(g.dtype)
        outs.append((g != 0).to(torch.float32) * mask)
        if return_mapping:
            maps.append(g * mask)
    return tuple(outs + maps)


@register("_copyto")
def _copyto(data):
    """A copy of ``data`` (never an alias of it)."""
    return data.clone()


@register("_scatter_elemwise_div")
def _scatter_elemwise_div(lhs, rhs):
    """Elementwise division (the JAX package divides densely too)."""
    return lhs / rhs
