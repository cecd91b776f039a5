"""The record-routed sum's host layout and its two passes, on the CPU.

The max backward ``dx[v, f] = Σ_{e ∋ v} g[e, f]·[arg[e, f] == v]`` runs on
the card in two passes over ``segment_sum.record_layout`` (a slot for each
member of each edge: its edge, its member, its entry in the vertex-major
CSR): pass A writes, for each slot, the words of the features its member
won through the permutation; pass B sums the won values over the CSR in
CSR order. Here:

* the layout: every Hᵀ entry (e, v) maps to its H entry (v, e), the k-th
  duplicate of a member (``from_coo(dedup=False)``) to its k-th; empty
  edges own no slot;
* both passes emulated in NumPy (the layout's plain twin): bitwise equal
  to the strictly sequential CSR-order sum, in NumPy and in
  ``segment_sum.record_routed_dx_sequential`` (the card tests' order
  reference), and within rtol 1e-6 of JAX's ``_v2e_max_bwd`` called on the
  same record table, with ids that are no member of their edge and ids of
  -1, at F = 1, 3, 32, 33 and 64. Cotangents are integers in [-2, 2], so
  JAX's prefix-difference sums are exact too.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import hypergef_tpu.sparse.hypergraph as jhypergraph
from hypergef_tpu.ops import maxops as jmaxops

import hypergef_tpu_torch.sparse.hypergraph as thypergraph
from hypergef_tpu_torch.ops import segment_sum


def _coo(name):
    """(vertex, edge, num_nodes, num_edges) of a small graph."""
    rng = np.random.default_rng(len(name))
    if name == "duplicates":  # repeated (v, e) pairs, some three times
        v = rng.integers(0, 40, size=300)
        e = rng.integers(0, 25, size=300)
        v = np.concatenate([v, v[:60], v[:15]])
        e = np.concatenate([e, e[:60], e[:15]])
        return v, e, 40, 25
    if name == "empty_edges":  # edges with no member and vertices of no edge
        v = rng.integers(0, 60, size=150)
        e = rng.choice(np.arange(0, 90, 3), size=150)
        return v, e, 70, 90
    # long edges among short ones
    v = np.concatenate([rng.permutation(300)[:150], rng.permutation(300)[:70],
                        rng.integers(0, 300, size=400)])
    e = np.concatenate([np.zeros(150, np.int64), np.ones(70, np.int64),
                        rng.integers(2, 120, size=400)])
    return v, e, 300, 120


GRAPHS = ["duplicates", "empty_edges", "long_edges"]


@functools.lru_cache(maxsize=None)
def _graphs(name):
    v, e, n, m = _coo(name)
    return (jhypergraph.Hypergraph.from_coo(v, e, n, m, dedup=False),
            thypergraph.Hypergraph.from_coo(v, e, n, m, dedup=False))


def won_words(arg, edge, members, perm):
    """Pass A in NumPy: uint32 [nnz, ceil(F/32)], bit f % 32 of word f // 32
    of a slot's vertex-major entry set where the slot's member won feature f
    of its edge."""
    f = arg.shape[1]
    nw = -(-f // 32)
    hit = np.zeros((members.size, nw * 32), dtype=np.uint64)
    hit[:, :f] = arg[edge] == members[:, None]
    bits = (hit.reshape(-1, nw, 32) << np.arange(32, dtype=np.uint64)).sum(axis=2)
    words = np.empty((members.size, nw), dtype=np.uint32)
    words[perm] = bits.astype(np.uint32)
    return words


def sequential(g, h_indptr, h_edge, won):
    """The sum over the vertex-major CSR in CSR order, f32, from +0.0: for
    each vertex one add an entry where ``won(k, v, e)`` (a bool [.., F]
    row) holds, nothing where it does not."""
    deg = np.diff(h_indptr)
    out = np.zeros((deg.size, g.shape[1]), dtype=np.float32)
    for r in range(int(deg.max()) if deg.size else 0):
        v = np.flatnonzero(deg > r)
        k = h_indptr[v] + r
        e = h_edge[k]
        out[v] = np.where(won(k, v, e), out[v] + g[e], out[v])
    return out


def _record(thg, f, seed):
    """(g, arg) [E, F] for the graph: g integers in [-2, 2], NaN where no
    member wins; arg a member of each edge, an id of no member, or -1."""
    rng = np.random.default_rng(seed)
    e = thg.num_edges
    size = np.diff(thg.ht_indptr)
    pick = thg.ht_indptr[:-1, None] + (rng.random((e, f)) * size[:, None]).astype(np.int64)
    arg = np.where(size[:, None] > 0, thg.ht_indices[np.minimum(pick, thg.nnz - 1)], -1)
    draw = rng.random((e, f))
    arg = np.where(draw < 0.1, rng.integers(0, thg.num_nodes, size=(e, f)), arg)
    arg = np.where(draw > 0.95, -1, arg).astype(np.int32)
    g = rng.integers(-2, 3, size=(e, f)).astype(np.float32)
    return g, arg


@pytest.mark.parametrize("graph", GRAPHS)
def test_record_layout_maps_each_ht_entry_to_its_h_entry(graph):
    _, thg = _graphs(graph)
    edge, members, perm = segment_sum.record_layout(thg.h_indptr, thg.h_indices)
    assert edge.dtype == members.dtype == perm.dtype == np.int32
    # the Hᵀ CSR's entries: its edges and its member table
    np.testing.assert_array_equal(edge, np.repeat(np.arange(thg.num_edges),
                                                  np.diff(thg.ht_indptr)))
    np.testing.assert_array_equal(members, thg.ht_indices)
    np.testing.assert_array_equal(np.sort(perm), np.arange(thg.nnz))
    vertex = np.repeat(np.arange(thg.num_nodes), np.diff(thg.h_indptr))
    np.testing.assert_array_equal(thg.h_indices[perm], edge)
    np.testing.assert_array_equal(vertex[perm], members)
    # duplicates of a member: the k-th slot to the k-th entry
    same = (edge[1:] == edge[:-1]) & (members[1:] == members[:-1])
    assert (perm[1:][same] > perm[:-1][same]).all()
    if graph == "duplicates":
        assert same.sum() >= 60
    if graph == "empty_edges":
        assert (np.diff(thg.ht_indptr) == 0).sum() > 0 and (np.diff(thg.h_indptr) == 0).sum() > 0


@pytest.mark.parametrize("graph", GRAPHS)
@pytest.mark.parametrize("f", [1, 3, 32, 33, 64])
def test_two_passes_are_the_sequential_sum_and_jax(graph, f):
    jhg, thg = _graphs(graph)
    g, arg = _record(thg, f, seed=f + len(graph))
    edge, members, perm = segment_sum.record_layout(thg.h_indptr, thg.h_indices)
    words = won_words(arg, edge, members, perm)
    cols = np.arange(f)
    h_indptr, h_edge = thg.h_indptr, thg.h_indices.astype(np.int64)
    # NaN in every other edge's values that no member wins: never added
    won_any = np.zeros(arg.shape, dtype=bool)
    np.logical_or.at(won_any, edge, arg[edge] == members[:, None])
    g0 = g
    g = np.where(~won_any & (np.arange(thg.num_edges)[:, None] % 2 == 0), np.float32(np.nan), g)
    assert np.isnan(g).any()
    got = sequential(g, h_indptr, h_edge,
                     lambda k, v, e: ((words[k][:, cols // 32] >> (cols % 32)) & 1) == 1)
    want = sequential(g, h_indptr, h_edge, lambda k, v, e: arg[e] == v[:, None])
    assert np.isfinite(got).all()
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))
    rec = thg.device_data("cpu").record
    assert rec.layout is None and rec.e2v is thg.device_data("cpu").e2v
    seq = segment_sum.record_routed_dx_sequential(torch.as_tensor(g), torch.as_tensor(arg), rec)
    np.testing.assert_array_equal(seq.numpy().view(np.uint32), got.view(np.uint32))
    jd = jhg.device_data()  # without the NaN: JAX's product with the 0/1 mask keeps it
    jdx, *_ = jmaxops._v2e_max_bwd((jnp.asarray(arg), jd.h_edge, jd.h_segids, jd.h_indptr),
                                   jnp.asarray(g0))
    np.testing.assert_allclose(got, np.asarray(jdx), rtol=1e-6, atol=1e-6)
    plain = segment_sum.record_routed_dx(torch.as_tensor(g0), torch.as_tensor(arg), rec)
    np.testing.assert_allclose(plain.numpy(), np.asarray(jdx), rtol=1e-6, atol=1e-6)


def test_record_table_builds_its_layout_only_on_the_card():
    _, thg = _graphs("duplicates")
    hgd = thg.device_data("cpu")
    assert hgd.record is hgd.record  # built once
    assert hgd.record.layout is None and hgd.record.device == torch.device("cpu")
