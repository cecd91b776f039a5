"""Synthetic hypergraph generators.

Port of ``hypergef_tpu/data/synthetic.py`` (``:18-109``) and of
the SBM generator of ``experiments/clustered_bench.py`` (``:30-55``): the
same NumPy RNG calls in the same order, so a seed gives the same graph and
features in both packages.
"""

from __future__ import annotations

import numpy as np

from hypergef_tpu_torch.sparse.hypergraph import Hypergraph


def random_hypergraph(
    num_nodes: int,
    num_edges: int,
    avg_edge_size: float = 6.0,
    seed: int = 0,
    name: str = "random",
) -> Hypergraph:
    """Uniform random membership: each hyperedge draws a Poisson-sized
    vertex set uniformly at random (≥1 member)."""
    rng = np.random.default_rng(seed)
    sizes = np.maximum(rng.poisson(avg_edge_size, size=num_edges), 1)
    sizes = np.minimum(sizes, num_nodes)
    edge = np.repeat(np.arange(num_edges, dtype=np.int64), sizes)
    vertex = rng.integers(0, num_nodes, size=edge.shape[0], dtype=np.int64)
    return Hypergraph.from_coo(
        vertex, edge, num_nodes=num_nodes, num_edges=num_edges, name=name
    )


def powerlaw_hypergraph(
    num_nodes: int,
    num_edges: int,
    alpha: float = 2.0,
    max_edge_size: int | None = None,
    seed: int = 0,
    name: str = "powerlaw",
) -> Hypergraph:
    """Heavy-tailed hyperedge sizes (Zipf exponent ``alpha``, capped at
    ``max_edge_size``, by default a quarter of the vertices) and members
    drawn with heavy-tailed vertex popularity (``:37-60``): the Zipf sizes
    first, then the popularity, then the members, as JAX draws them."""
    rng = np.random.default_rng(seed)
    if max_edge_size is None:
        max_edge_size = max(num_nodes // 4, 2)
    sizes = np.minimum(rng.zipf(alpha, size=num_edges), max_edge_size)
    edge = np.repeat(np.arange(num_edges, dtype=np.int64), sizes)
    pop = rng.zipf(alpha, size=num_nodes).astype(np.float64)
    pop /= pop.sum()
    vertex = rng.choice(num_nodes, size=edge.shape[0], p=pop).astype(np.int64)
    return Hypergraph.from_coo(
        vertex, edge, num_nodes=num_nodes, num_edges=num_edges, name=name
    )


def homophilic_hypergraph(
    num_nodes: int,
    num_edges: int,
    num_classes: int,
    avg_edge_size: float = 6.0,
    noise: float = 0.1,
    seed: int = 0,
    name: str = "homophilic",
):
    """Hypergraph whose hyperedges draw their members mostly from one class
    (``noise`` of them from anywhere). Returns ``(Hypergraph, labels)``."""
    rng = np.random.default_rng(seed)
    y = rng.integers(0, num_classes, size=num_nodes)
    by_class = [np.nonzero(y == c)[0] for c in range(num_classes)]
    sizes = np.maximum(rng.poisson(avg_edge_size, size=num_edges), 2)
    vs, es = [], []
    for e in range(num_edges):
        c = rng.integers(0, num_classes)
        pool = by_class[c]
        if pool.size == 0:
            pool = np.arange(num_nodes)
        k = int(min(sizes[e], pool.size))
        members = rng.choice(pool, size=k, replace=False)
        flip = rng.random(k) < noise
        members[flip] = rng.integers(0, num_nodes, size=int(flip.sum()))
        vs.append(members)
        es.append(np.full(k, e, dtype=np.int64))
    vertex = np.concatenate(vs)
    edge = np.concatenate(es)
    hg = Hypergraph.from_coo(
        vertex, edge, num_nodes=num_nodes, num_edges=num_edges, name=name
    )
    return hg, y.astype(np.int32)


def community_hypergraph(n_nodes, n_edges, n_comm, avg, noise, seed):
    """Community-structured (SBM-style) hypergraph with vertices already
    numbered by community, contiguous id ranges per community
    (``experiments/clustered_bench.py:30-55``; ``bench.py``'s clustered leg
    is ``(60000, 30000, 240, 12, 0.02, 0)``). Each hyperedge draws
    max(Poisson(avg), 2) members from one community, ``noise`` of them from
    anywhere."""
    rng = np.random.default_rng(seed)
    comm_of = np.sort(rng.integers(0, n_comm, size=n_nodes))  # contiguous
    starts = np.searchsorted(comm_of, np.arange(n_comm)).tolist()
    ends = np.searchsorted(comm_of, np.arange(n_comm), side="right").tolist()
    # JAX's draws in JAX's order; a draw of no values takes nothing from the
    # stream, and from_coo drops an edge's repeated members as np.unique did
    integers, poisson, random = rng.integers, rng.poisson, rng.random
    vs, sizes = [], np.empty(n_edges, dtype=np.int64)
    for e in range(n_edges):
        c = integers(0, n_comm)
        lo, hi = starts[c], ends[c]
        if hi - lo < 2:
            lo, hi = 0, n_nodes
        k = max(int(poisson(avg)), 2)
        members = integers(lo, hi, size=k)
        flip = random(k) < noise
        if flip.any():
            members[flip] = integers(0, n_nodes, size=int(flip.sum()))
        vs.append(members)
        sizes[e] = k
    return Hypergraph.from_coo(
        np.concatenate(vs), np.repeat(np.arange(n_edges, dtype=np.int64), sizes),
        num_nodes=n_nodes, num_edges=n_edges, name=f"sbm{n_comm}",
    )


def random_features(
    num_nodes: int, num_features: int, num_classes: int, seed: int = 0
):
    """Random features + class-correlated labels (NumPy f32 / int32)."""
    rng = np.random.default_rng(seed)
    y = rng.integers(0, num_classes, size=num_nodes)
    centers = rng.normal(size=(num_classes, num_features))
    x = centers[y] + 0.5 * rng.normal(size=(num_nodes, num_features))
    return x.astype(np.float32), y.astype(np.int32)
