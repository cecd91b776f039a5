"""What the scale drivers share: their graph generators and the link model
of the exchanges they do not run.

Generators (each gives the JAX driver's graph draw for draw: the same
``np.random.default_rng`` calls in the same order):

* :func:`big_sbm`: ``experiments/scale_aligned.py:36-56`` (also the graph
  of ``scale_projection`` and ``scale_serialized``);
* :func:`big_homophilic`, :func:`class_features`:
  ``experiments/minibatch_scale.py:43-101``;
* :func:`clustered_hypergraph`: ``experiments/weak_scaling.py:44-77`` (also
  ``halo_overlap``'s).

``clustered_e2e`` and ``dense_shard_scale`` take
``data/synthetic.py::community_hypergraph``, ``clustered_bench.py:30``'s.

The link model. One card cannot run the collectives of a world of cards,
so the drivers measure one card's compute and model the exchanges:

* :data:`V5E_ICI` is the JAX drivers' model, term for term: a TPU v5e ICI
  link at 45 GB/s one way. An ``all_to_all`` costs its largest (src, dst)
  pair's bytes over one link; the serialized layer's real halo and return
  bytes are spread over D links; a ring all-reduce moves ``2(d-1)/d`` of
  its bytes over one link. It is kept for the parity tests and for
  ``--links v5e``, never as the card's.
* :func:`nvlink4_links` is the NVIDIA H100 SXM5's NVLink 4 from its data
  sheet: 18 links, 900 GB/s both ways a card, so 450 GB/s a direction,
  the cards of a world on one NVSwitch board. An ``all_to_all`` costs the
  largest bytes any card sends or receives over 450 GB/s; a ring
  all-reduce ``2(d-1)/d`` of its bytes over the same rate; where a driver
  has no per-pair bytes (``scale_serialized``, ``scale_projection``) its
  own form of the bytes is kept, at this rate.

Both are models from a data sheet, not measurements: a machine of one
card cannot check them. Every row a driver derives from them says
MODELED, with the model's name and its rate (:meth:`LinkModel.label`).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np

from hypergef_tpu_torch.sparse.hypergraph import Hypergraph

# the JAX drivers' compute constants (TPU v5e), kept for the parity tests
# of weak_scaling.analyze: ns an incidence of the tree route
# (``weak_scaling.py:131``) and of the aligned stage (``:107``)
V5E_NS_PER_NNZ = 16.0
V5E_NS_ALIGNED = 4.0


class LinkModel(NamedTuple):
    """A model of the links between the cards (or chips) of a world."""

    name: str
    gbps: float  # GB/s one way: a link (``pairwise``) or a card's share
    pairwise: bool  # True: a link a (src, dst) pair (ICI); False: a card's
    source: str

    @property
    def bytes_per_s(self) -> float:
        return self.gbps * 1e9

    def a2a_rows(self, *pair_rows: np.ndarray) -> float:
        """The rows on the critical path of the ``all_to_all``s whose [D, D]
        (src, dst) row counts are given (the diagonals zeroed): summed over
        the exchanges, each its largest pair's rows (a link a pair) or the
        most rows any card sends or receives (a card's links)."""
        if self.pairwise:
            return float(sum(m.max() for m in pair_rows))
        return float(sum(max(m.sum(axis=1).max(), m.sum(axis=0).max()) for m in pair_rows))

    def a2a_us(self, nbytes: float) -> float:
        """µs to move a critical path of ``nbytes`` (``weak_scaling.py:116``,
        ``halo_overlap.py:96``)."""
        return nbytes / (self.gbps * 1e9) * 1e6

    def ring_allreduce_us(self, nbytes: float, d: int) -> float:
        """µs of a ring all-reduce of ``nbytes`` over ``d`` ranks
        (``dense_shard_scale.py:46-47``)."""
        return 2.0 * (d - 1) / d * nbytes / (self.gbps * 1e9) * 1e6

    def exchange_s(self, halo_bytes: float, return_bytes: float, d: int) -> float:
        """Seconds of a halo layer's two exchanges from their real bytes,
        spread over ``d`` ranks' links (``scale_serialized.py:188-190``)."""
        return (halo_bytes + return_bytes) / (d * self.gbps * 1e9)

    def halo_a2a_s(self, comm_frac: float, n_owned: int, feat: int) -> float:
        """Seconds of one halo ``all_to_all`` of ``comm_frac`` of a shard's
        owned f32 rows (``scale_projection.py:127``)."""
        return comm_frac * n_owned * feat * 4 / (self.gbps * 1e9)

    def label(self) -> str:
        """What a modeled row says of its model."""
        unit = "a link" if self.pairwise else "a card, one way"
        return f"MODELED {self.name} {self.gbps:g} GB/s {unit} ({self.source})"


V5E_ICI = LinkModel("v5e_ici", 45.0, True,
                    "the JAX drivers' TPU v5e ICI link; not the card's")

NVLINK4_GBPS = 450.0  # 900 GB/s both ways a card (18 NVLink 4 links)


def nvlink4_links(gbps: Optional[float] = None) -> LinkModel:
    """The H100 SXM5's NVLink 4 (data sheet: 18 links, 900 GB/s both ways a
    card), the cards on one NVSwitch board: each card sends and receives
    at 450 GB/s. A model, unverified on a machine of one card."""
    return LinkModel("nvlink4", NVLINK4_GBPS if gbps is None else float(gbps), False,
                     "H100 SXM5 data sheet, NVSwitch; unverified on one card")


LINKS = ("nvlink4", "v5e")


def add_link_flags(ap) -> None:
    ap.add_argument("--links", choices=LINKS, default="nvlink4",
                    help="the link model of the exchanges not run: nvlink4 (the H100 "
                    "SXM5's data sheet, the default) or v5e (the JAX drivers' ICI)")
    ap.add_argument("--ici-gbps", type=float, default=None,
                    help="GB/s one way; overrides the link model's rate")


def link_model(name: str, gbps: Optional[float] = None) -> LinkModel:
    if name == "nvlink4":
        return nvlink4_links(gbps)
    if name == "v5e":
        return V5E_ICI if gbps is None else V5E_ICI._replace(gbps=float(gbps))
    raise ValueError(f"--links must be one of {LINKS}, got {name!r}")


# ------------------------------------------------------------------ graphs


def big_sbm(n_nodes, n_edges, n_comm, avg, noise, seed) -> Hypergraph:
    """Vectorized SBM hypergraph, vertices contiguous a community
    (``experiments/scale_aligned.py:36-56``): each hyperedge draws
    max(Poisson(avg), 2) members from its community's id range, ``noise``
    of them from anywhere."""
    rng = np.random.default_rng(seed)
    bounds = np.linspace(0, n_nodes, n_comm + 1).astype(np.int64)
    lo_c, hi_c = bounds[:-1], bounds[1:]
    ecomm = rng.integers(0, n_comm, size=n_edges)
    k = np.maximum(rng.poisson(avg, size=n_edges), 2)
    seg = np.repeat(np.arange(n_edges, dtype=np.int64), k)
    lo, hi = lo_c[ecomm][seg], hi_c[ecomm][seg]
    mem = lo + (rng.random(k.sum()) * (hi - lo)).astype(np.int64)
    flip = rng.random(k.sum()) < noise
    mem[flip] = rng.integers(0, n_nodes, size=int(flip.sum()))
    return Hypergraph.from_coo(mem, seg, num_nodes=n_nodes, num_edges=n_edges,
                               name=f"sbm{n_comm}")


def big_homophilic(n, e, ncls, avg, noise, seed):
    """Vectorized homophilic generator (``experiments/minibatch_scale.py:
    43-89``): each class's members drawn as consecutive slices of repeated
    shuffles of its pool, an edge a contiguous slice, (v, e) pairs deduped
    at the end. Returns ``(Hypergraph, labels)``."""
    rng = np.random.default_rng(seed)
    y = rng.integers(0, ncls, size=n).astype(np.int32)
    sizes = np.maximum(rng.poisson(avg, size=e), 2).astype(np.int64)
    ecls = rng.integers(0, ncls, size=e)
    order = np.argsort(ecls, kind="stable")
    ecls_sorted = ecls[order]
    vs = np.empty(int(sizes.sum()), np.int64)
    es = np.empty(int(sizes.sum()), np.int64)
    pos = 0
    for c in range(ncls):
        lo = np.searchsorted(ecls_sorted, c)
        hi = np.searchsorted(ecls_sorted, c, side="right")
        esel = order[lo:hi]
        if len(esel) == 0:
            continue
        need = int(sizes[esel].sum())
        pool = np.nonzero(y == c)[0]
        if pool.size == 0:
            pool = np.arange(n)
        draws = np.empty(need, np.int64)
        got = 0
        while got < need:
            perm = rng.permutation(pool)
            take = min(len(perm), need - got)
            draws[got:got + take] = perm[:take]
            got += take
        vs[pos:pos + need] = draws
        es[pos:pos + need] = np.repeat(esel, sizes[esel])
        pos += need
    flip = rng.random(len(vs)) < noise
    vs[flip] = rng.integers(0, n, size=int(flip.sum()))
    uk = np.unique(es * np.int64(n) + vs)  # dedup (v, e) incidences
    return Hypergraph.from_coo(uk % n, uk // n, num_nodes=n, num_edges=e,
                               name="big_homophilic"), y


def class_features(y, nfeat, sigma, seed) -> np.ndarray:
    """``x = prototype[y] + sigma·noise`` (``minibatch_scale.py:92-101``)."""
    rng = np.random.default_rng(seed)
    ncls = int(y.max()) + 1
    proto = rng.normal(size=(ncls, nfeat)).astype(np.float32)
    return proto[y] + sigma * rng.normal(size=(len(y), nfeat)).astype(np.float32)


def clustered_hypergraph(n_nodes, n_edges, avg, seed) -> Hypergraph:
    """Homophilic graph (32 classes) with vertices renumbered a class at a
    time and hyperedges sorted by their members' mean new id, so the
    contiguous hyperedge partition follows the communities
    (``experiments/weak_scaling.py:44-77``)."""
    from hypergef_tpu_torch.data.synthetic import homophilic_hypergraph

    hg, labels = homophilic_hypergraph(n_nodes, n_edges, 32, avg_edge_size=avg, noise=0.05,
                                       seed=seed)
    vperm = np.argsort(labels, kind="stable")
    vrank = np.empty_like(vperm)
    vrank[vperm] = np.arange(len(vperm))
    ptr, idx = np.asarray(hg.ht_indptr), np.asarray(hg.ht_indices)
    vertex, keys = [], []
    for e in range(hg.num_edges):
        mem = vrank[idx[int(ptr[e]):int(ptr[e + 1])]]
        keys.append(mem.mean() if len(mem) else 0.0)
        vertex.append(mem)
    order = np.argsort(np.asarray(keys), kind="stable")
    vs = [vertex[old] for old in order]
    es = [np.full(len(vertex[old]), new, dtype=np.int64) for new, old in enumerate(order)]
    return Hypergraph.from_coo(np.concatenate(vs), np.concatenate(es), num_nodes=hg.num_nodes,
                               num_edges=hg.num_edges, name="clustered")


def sorted_edges(hg) -> Hypergraph:
    """The JAX drivers' ``apply_vertex_order(hg, arange, sort_edges=True)``:
    vertex ids kept, hyperedges renumbered by their median member."""
    from hypergef_tpu_torch.sparse.reorder import apply_vertex_order

    return apply_vertex_order(hg, np.arange(hg.num_nodes), sort_edges=True)[0]
