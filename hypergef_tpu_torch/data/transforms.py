"""Hypergraph transforms.

Port of ``hypergef_tpu/data/transforms.py`` (``:19-53``), as the same NumPy
code over the port's :class:`~hypergef_tpu_torch.sparse.hypergraph.Hypergraph`,
so a transformed graph is bit-identical to the JAX package's:

* :func:`add_self_loops` (the reference's ``Add_Self_Loops``): a new
  singleton hyperedge {v} for every vertex v that is not already alone in
  a hyperedge;
* :func:`extract_v2e` (the reference's ``ExtractV2E``): the V→E half of an
  AllSet-style symmetric bipartite ``edge_index``.
"""

from __future__ import annotations

import numpy as np

from hypergef_tpu_torch.sparse.hypergraph import Hypergraph


def add_self_loops(hg: Hypergraph) -> Hypergraph:
    """Append singleton self-loop hyperedges for vertices lacking one."""
    sizes = hg.edge_sizes()
    singleton_members = set()
    for e in np.nonzero(sizes == 1)[0]:
        singleton_members.add(int(hg.ht_indices[hg.ht_indptr[e]]))
    new_vs = [v for v in range(hg.num_nodes) if v not in singleton_members]
    v_all = [hg.ht_indices.astype(np.int64)]
    e_all = [np.repeat(np.arange(hg.num_edges, dtype=np.int64), sizes)]
    if new_vs:
        v_all.append(np.asarray(new_vs, dtype=np.int64))
        e_all.append(hg.num_edges + np.arange(len(new_vs), dtype=np.int64))
    return Hypergraph.from_coo(
        np.concatenate(v_all),
        np.concatenate(e_all),
        num_nodes=hg.num_nodes,
        num_edges=hg.num_edges + len(new_vs),
        name=hg.name + "+selfloops",
    )


def extract_v2e(edge_index: np.ndarray, num_nodes: int) -> np.ndarray:
    """Keep only the V→E half of a symmetric bipartite edge_index (sorted
    by row 0; split at the first entry equal to ``num_nodes``)."""
    edge_index = np.asarray(edge_index)
    order = np.argsort(edge_index[0], kind="stable")
    edge_index = edge_index[:, order]
    split = np.nonzero(edge_index[0] == num_nodes)[0]
    c_idx = int(split.min()) if split.size else edge_index.shape[1]
    return edge_index[:, :c_idx]
