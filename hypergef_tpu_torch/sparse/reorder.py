"""Community reordering: locality-creating vertex/hyperedge renumbering.

Port of ``hypergef_tpu/sparse/reorder.py``, as the same NumPy code, so an
order and a reordered graph are bit-identical to the JAX package's. The
aligned route needs a community-sorted graph (``planner.plan_aligned``
refuses others); :func:`community_reorder` makes one from raw input.

Two methods:

* ``labelprop`` (:func:`community_order_numpy`, ``:68-80``): synchronous
  hypergraph label propagation;
* ``coarsen`` (:func:`coarsen_order`, ``:174-230``): multilevel best-friend
  star coarsening, the default.

Each runs in the port's native host library
(:mod:`hypergef_tpu_torch.sparse.native`) by default, as the JAX package
runs them in its own, and in NumPy with ``use_native=False``; the two are
bit-identical (``tests/test_torch_port_native.py``). Where the JAX package
falls back to NumPy when its library is not built, the port builds the
library and raises if the build fails.
"""

from __future__ import annotations

import numpy as np

from hypergef_tpu_torch.sparse.hypergraph import Hypergraph


def _segment_mode(labels_per_entry: np.ndarray, seg_ids: np.ndarray,
                  num_segments: int, default: np.ndarray) -> np.ndarray:
    """Per-segment mode with (max count, then smallest label) tie rule
    (``:30-65``). ``seg_ids`` must be sorted; empty segments keep
    ``default``."""
    if labels_per_entry.size == 0:
        return default.copy()
    order = np.lexsort((labels_per_entry, seg_ids))
    s = seg_ids[order]
    l = labels_per_entry[order]
    new_run = np.ones(len(s), dtype=bool)
    new_run[1:] = (s[1:] != s[:-1]) | (l[1:] != l[:-1])
    run_start = np.nonzero(new_run)[0]
    run_seg = s[run_start]
    run_lab = l[run_start]
    run_len = np.diff(np.append(run_start, len(s)))
    # per segment the longest run; runs are label-sorted within a segment,
    # so the first longest run holds the smallest label
    best_len = np.zeros(num_segments, dtype=np.int64)
    np.maximum.at(best_len, run_seg, run_len)
    is_best = run_len == best_len[run_seg]
    first_best = np.full(num_segments, len(s) + 1, dtype=np.int64)
    np.minimum.at(first_best, run_seg[is_best], np.nonzero(is_best)[0])
    mode = default.copy()
    has = first_best <= len(s)
    mode[has] = run_lab[first_best[has]]
    return mode


def community_order_numpy(hg, iters: int = 8) -> np.ndarray:
    """Label-propagation vertex order (``:68-80``): ``order[i]`` is the old
    id at new position i."""
    n, e = hg.num_nodes, hg.num_edges
    vlab = np.arange(n, dtype=np.int32)
    elab_default = np.arange(e, dtype=np.int32)
    ht_vertex = np.asarray(hg.ht_indices, dtype=np.int64)
    ht_seg = np.repeat(np.arange(e, dtype=np.int64), np.diff(hg.ht_indptr))
    h_edge = np.asarray(hg.h_indices, dtype=np.int64)
    h_seg = np.repeat(np.arange(n, dtype=np.int64), np.diff(hg.h_indptr))
    for _ in range(iters):
        elab = _segment_mode(vlab[ht_vertex], ht_seg, e, elab_default)
        vlab = _segment_mode(elab[h_edge], h_seg, n, vlab)
    return np.argsort(vlab, kind="stable").astype(np.int32)


def community_order(hg, iters: int = 8, method: str = "labelprop",
                    use_native: bool = True) -> np.ndarray:
    """Vertex order (``order[i]`` = old id at new position i; ``:83-101``).

    ``method="labelprop"``: synchronous label propagation, fast but it
    floods across noise links on weakly separated graphs.
    ``method="coarsen"``: multilevel best-friend star coarsening
    (:func:`coarsen_order`), slower but it recovers planted SBM structure.
    ``use_native`` runs either in the native host library (the default, as
    JAX's ``:98``) or, when False, in NumPy.
    """
    if method == "coarsen":
        return coarsen_order(hg, use_native=use_native)
    if use_native:
        from hypergef_tpu_torch.sparse import native

        return native.community_order_native(hg, iters)
    return community_order_numpy(hg, iters)


def _pair_weights(indptr, indices, edge_cap: int = 64):
    """All ordered intra-hyperedge vertex pairs (u, v) with clique-expansion
    weight 1/(k-1); hyperedges larger than ``edge_cap`` are skipped
    (``:104-130``)."""
    indptr = np.asarray(indptr, dtype=np.int64)
    indices = np.asarray(indices, dtype=np.int64)
    k = np.diff(indptr)
    use = (k >= 2) & (k <= edge_cap)
    eids = np.nonzero(use)[0]
    if len(eids) == 0:
        z = np.zeros(0, np.int64)
        return z, z, np.zeros(0)
    ks = k[eids]
    starts = indptr[eids]
    offs = np.repeat(starts, ks) + (
        np.arange(ks.sum()) - np.repeat(np.cumsum(ks) - ks, ks))
    mem = indices[offs]  # used edges' members, concatenated
    seg = np.repeat(np.arange(len(eids)), ks)
    ku = np.repeat(ks, ks)  # per member: its edge's size
    u = np.repeat(mem, ku)
    estart = np.cumsum(ks) - ks
    base = np.repeat(estart[seg], ku)
    within = np.arange(len(u)) - np.repeat(np.cumsum(ku) - ku, ku)
    v = mem[base + within]
    w = 1.0 / (np.repeat(ku, ku) - 1.0)
    keep = u != v
    return u[keep], v[keep], w[keep]


def _best_friend(u, v, w, n):
    """p[x] = argmax_y Σw(x, y) (ties → smallest y); p[x] = x if isolated
    (``:133-156``)."""
    p = np.arange(n, dtype=np.int64)
    if len(u) == 0:
        return p
    order = np.lexsort((v, u))
    u, v, w = u[order], v[order], w[order]
    new = np.ones(len(u), bool)
    new[1:] = (u[1:] != u[:-1]) | (v[1:] != v[:-1])
    idx = np.nonzero(new)[0]
    uu, vv = u[idx], v[idx]
    # per-run sums as sequential prefix-sum differences, the float
    # expression the JAX package's native twin computes too
    csum = np.cumsum(w)
    ends = np.append(idx[1:], len(w)) - 1
    ww = csum[ends] - np.where(idx > 0, csum[idx - 1], 0.0)
    order2 = np.lexsort((-ww, uu))  # stable: ties keep smaller v
    uu2, vv2 = uu[order2], vv[order2]
    first = np.ones(len(uu2), bool)
    first[1:] = uu2[1:] != uu2[:-1]
    p[uu2[first]] = vv2[first]
    return p


def _bf_components(p):
    """Connected components of the undirected best-friend graph by min-label
    propagation (``:159-171``)."""
    lab = np.arange(len(p), dtype=np.int64)
    for _ in range(64):
        new = lab.copy()
        np.minimum.at(new, p, lab)
        new = np.minimum(new, lab[p])
        if np.array_equal(new, lab):
            break
        lab = new
    return np.unique(lab, return_inverse=True)[1]


def coarsen_order(hg, edge_cap: int = 64, max_levels: int = 40,
                  use_native: bool = True) -> np.ndarray:
    """Multilevel best-friend star-coarsening vertex order (``:174-230``).

    Per level: clique-expansion pair weights → per-vertex best friend →
    collapse every connected component of the best-friend graph into one
    supernode → rebuild the coarse hypergraph. The order is the dendrogram
    leaf order: by top-level ancestor, then recursively by each lower level.

    ``use_native`` (the default) runs it in the native host library
    (``hg_coarsen_order``), bit-identical to the NumPy below.
    """
    if use_native:
        from hypergef_tpu_torch.sparse import native

        return native.coarsen_order_native(hg, edge_cap, max_levels)
    indptr = np.asarray(hg.ht_indptr, dtype=np.int64)
    indices = np.asarray(hg.ht_indices, dtype=np.int64)
    n = hg.num_nodes
    parents = []
    while True:
        u, v, w = _pair_weights(indptr, indices, edge_cap)
        comp = _bf_components(_best_friend(u, v, w, n))
        k = int(comp.max()) + 1 if n else 0
        parents.append(comp)
        if k <= 1 or k >= n * 0.95 or len(parents) >= max_levels:
            n = k
            break
        seg = np.repeat(np.arange(len(indptr) - 1), np.diff(indptr))
        key = seg * np.int64(k) + comp[indices]
        uk = np.unique(key)
        cseg, cmem = uk // k, uk % k
        cnt = np.bincount(cseg, minlength=len(indptr) - 1)
        sel = (cnt >= 2)[cseg]  # drop collapsed (single-supernode) edges
        cseg, cmem = cseg[sel], cmem[sel]
        _, cseg = np.unique(cseg, return_inverse=True)
        e2 = int(cseg.max()) + 1 if len(cseg) else 0
        order = np.argsort(cseg, kind="stable")
        cseg, cmem = cseg[order], cmem[order]
        indptr = np.zeros(e2 + 1, dtype=np.int64)
        np.cumsum(np.bincount(cseg, minlength=e2), out=indptr[1:])
        indices = cmem
        n = k
    pos = np.arange(n, dtype=np.int64)
    for comp in reversed(parents):
        m = len(comp)
        order = np.lexsort((np.arange(m), pos[comp]))
        pos = np.empty(m, dtype=np.int64)
        pos[order] = np.arange(m)
    return np.argsort(pos, kind="stable").astype(np.int32)


def apply_vertex_order(hg, order: np.ndarray, sort_edges: bool = True):
    """Renumber vertices by ``order`` and, with ``sort_edges``, sort the
    hyperedges by median new member id, so contiguous edge ranges align
    with communities (``:233-264``). Returns ``(new_hypergraph, rank)``
    with ``rank[old_id] = new_id``."""
    n, e = hg.num_nodes, hg.num_edges
    rank = np.empty(n, dtype=np.int64)
    rank[np.asarray(order, dtype=np.int64)] = np.arange(n)
    new_vertex = rank[np.asarray(hg.ht_indices, dtype=np.int64)]
    seg = np.repeat(np.arange(e, dtype=np.int64), np.diff(hg.ht_indptr))
    if sort_edges and len(new_vertex):
        o = np.lexsort((new_vertex, seg))
        sv, ss = new_vertex[o], seg[o]
        cnt = np.bincount(ss, minlength=e)
        start = np.cumsum(cnt) - cnt
        key = np.zeros(e, dtype=np.int64)
        nz = cnt > 0
        key[nz] = sv[(start + cnt // 2)[nz]]
        eorder = np.argsort(key, kind="stable")
        erank = np.empty(e, dtype=np.int64)
        erank[eorder] = np.arange(e)
        seg = erank[seg]
    hg2 = Hypergraph.from_coo(
        new_vertex, seg, num_nodes=n, num_edges=e,
        name=f"{getattr(hg, 'name', 'graph')}-reordered",
    )
    return hg2, rank


def community_reorder(hg, iters: int = 8, sort_edges: bool = True,
                      method: str = "coarsen", use_native: bool = True):
    """One-call locality pass: ``(reordered_hg, vertex_rank)``
    (``:267-273``)."""
    return apply_vertex_order(hg, community_order(hg, iters, method, use_native), sort_edges)
