"""Hyperedge-sampled minibatches of a large hypergraph.

Port of ``hypergef_tpu/data/sampling.py`` (``:32-253``), with the same
NumPy calls in the same order, so one seed draws the same hyperedges and
builds the same padded batches and pad shapes as the JAX package:

* the host sampler draws a set of hyperedges a step (uniform, or weighted
  by size), induces the subgraph (the drawn edges and their members) and
  relabels its vertices compactly;
* every batch is padded to bucketed shapes (the next power of two of each
  dimension, or fixed ``pad_to`` shapes), so a run meets few shapes;
* each CSR's pad entries all sit in its last ("ghost") row and point at
  the *other* side's ghost row, so the two CSRs stay exact transposes and
  the ``cumsum`` route's adjoint (the same op over the transposed CSR) is
  exact on a padded batch (``:58-86``);
* degrees come from the full graph, with the Horvitz-Thompson factor E/b
  on degV where a batch holds b of the E hyperedges (``:190-195``).

A batch is host arrays. Its ``data`` is the port's
:class:`~hypergef_tpu_torch.sparse.hypergraph.HypergraphData` on the
sampler's device (the card unless the caller asks for the CPU), built on
first use, its segment tables from the host arrays
(``HypergraphData.from_host``), so nothing is read back from the card. The
trainers instead copy each batch into the tensors of its pad shape (a
:class:`~hypergef_tpu_torch.sparse.hypergraph.StaticTables`), which a
recorded step reads at every replay.

Known fault of the reference, kept (ROADMAP.md queue 3): ``weighted=True``
draws edges with probability proportional to their size but still applies
the uniform E/b factor, which is biased for a non-uniform draw
(``ADVICE.md:3``).
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Iterator, Optional

import numpy as np
import torch

from hypergef_tpu_torch.sparse.hypergraph import Hypergraph, HypergraphData, StaticTables


def _bucket(n: int, minimum: int = 16) -> int:
    """Next power-of-two bucket (≥ minimum)."""
    b = minimum
    while b < n:
        b *= 2
    return b


@dataclasses.dataclass
class HyperedgeBatch:
    """A padded minibatch at bucketed shapes (``:43-57``), held as host
    arrays.

    The padded CSRs of the *local* (relabelled) subgraph, with one ghost
    vertex row and one ghost hyperedge row, and its degrees are NumPy;
    ``vertex_ids`` maps local rows to global vertex ids (ghost → 0); masks
    select real rows. ``nnz`` counts the real incidences: the ghost row of
    each CSR holds the other ``ghost_entries`` entries. ``data`` (JAX's
    ``HypergraphData``, here the port's on ``device``), ``rows`` and
    ``row_mask`` (``vertex_ids`` as int64 and ``vertex_mask`` on ``device``)
    are built on first use; a trainer copies the batch into the tensors of
    its pad shape instead (:meth:`write`), and builds none of them.
    """

    ht_indptr: np.ndarray  # [E_pad+1] int64, Hᵀ CSR (edge-major)
    ht_indices: np.ndarray  # [nnz_pad] int32 member vertices
    h_indptr: np.ndarray  # [N_pad+1] int64, H CSR (vertex-major)
    h_indices: np.ndarray  # [nnz_pad] int32 incident edges
    degV: np.ndarray  # [N_pad, 1] f32
    degE: np.ndarray  # [E_pad, 1] f32
    vertex_ids: np.ndarray  # [N_pad] int32 global ids
    vertex_mask: np.ndarray  # [N_pad] f32 (0 for padding/ghost)
    edge_ids: np.ndarray  # [E_pad] int32 global ids
    num_real_vertices: int
    num_real_edges: int
    nnz: int
    device: torch.device

    @property
    def pad_shape(self) -> tuple:
        """(N_pad, E_pad, nnz_pad)."""
        return len(self.h_indptr) - 1, len(self.ht_indptr) - 1, len(self.ht_indices)

    @property
    def ghost_entries(self) -> int:
        """The pad entries, all in the ghost segment of each CSR."""
        return self.pad_shape[2] - self.nnz

    @functools.cached_property
    def data(self) -> HypergraphData:
        n, e, _ = self.pad_shape
        return HypergraphData.from_host(self.ht_indptr, self.ht_indices, self.h_indptr,
                                        self.h_indices, self.degV, self.degE, num_nodes=n,
                                        num_edges=e, device=self.device)

    @functools.cached_property
    def rows(self) -> torch.Tensor:
        return torch.as_tensor(self.vertex_ids.astype(np.int64), device=self.device)

    @functools.cached_property
    def row_mask(self) -> torch.Tensor:
        return torch.as_tensor(self.vertex_mask, device=self.device)

    def write(self, tables: StaticTables) -> None:
        """Copy the batch into ``tables`` (``StaticTables(*pad_shape,
        device)``) in place: its CSRs, degrees, rows and row mask."""
        tables.write(self.ht_indptr, self.ht_indices, self.h_indptr, self.h_indices,
                     self.degV, self.degE, rows=self.vertex_ids, row_mask=self.vertex_mask)


def _padded_csr(indptr, indices, rows_pad, nnz_pad, pad_index):
    """Pad a CSR to (rows_pad rows, nnz_pad entries): real rows first,
    ghost last row absorbs the padded entries (``:58-86``). ``pad_index``
    must be the *other side's ghost row*, so that the two padded CSRs are
    exact transposes: the extra mass is a closed ghost↔ghost loop that never
    touches a real row in value or gradient."""
    rows = len(indptr) - 1
    nnz = len(indices)
    out_ptr = np.zeros(rows_pad + 1, dtype=np.int64)
    out_ptr[1 : rows + 1] = indptr[1:]
    out_ptr[rows + 1 :] = nnz  # empty padding rows
    out_ptr[-1] = nnz_pad  # ghost row holds the padded slots
    out_idx = np.full(nnz_pad, pad_index, dtype=np.int32)
    out_idx[:nnz] = indices
    return out_ptr, out_idx


class HyperedgeSampler:
    """Iterates hyperedge-sampled minibatches of a large hypergraph
    (``:89-253``), each on ``device`` (the card unless ``device="cpu"``;
    without a card the default raises).

    ``deg_correction`` (default on) applies the Horvitz-Thompson 1/p
    estimator to the E→V stage: a batch of b of E hyperedges sums only a
    p = b/E share of each vertex's incident edges, so degV is scaled by E/b
    (factor 1 when the batch covers every edge). With ``weighted=True`` the
    factor stays uniform, as in the reference (its known fault).
    """

    def __init__(
        self,
        hg: Hypergraph,
        batch_edges: int,
        weighted: bool = False,
        seed: int = 0,
        drop_last: bool = True,
        deg_correction: bool = True,
        *,
        device="cuda",
    ):
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("no CUDA device: the sampler puts its batches on the card "
                               "unless it is given device='cpu'")
        self.hg = hg
        self.batch_edges = batch_edges
        self.weighted = weighted
        self.rng = np.random.default_rng(seed)
        self.drop_last = drop_last
        self.deg_correction = deg_correction
        sizes = hg.edge_sizes().astype(np.float64)
        self._probs = sizes / sizes.sum() if weighted else None

    def sample_batch(self, pad_to: Optional[tuple] = None) -> HyperedgeBatch:
        hg = self.hg
        edges = self.rng.choice(
            hg.num_edges, size=min(self.batch_edges, hg.num_edges),
            replace=False, p=self._probs,
        )
        edges = np.sort(edges)
        return self.induce(edges, pad_to=pad_to)

    def induce(self, edges: np.ndarray, pad_to: Optional[tuple] = None) -> HyperedgeBatch:
        """Build the padded batch for an explicit sorted hyperedge set.

        ``pad_to=(n_pad, e_pad, nnz_pad)`` forces fixed shapes; raises
        ``ValueError`` if the batch exceeds them."""
        hg = self.hg
        sizes = hg.edge_sizes()[edges]
        member_lists = [
            hg.ht_indices[hg.ht_indptr[e] : hg.ht_indptr[e + 1]] for e in edges
        ]
        members = (
            np.concatenate(member_lists) if member_lists else np.zeros(0, np.int32)
        )
        verts = np.unique(members)
        local_of = np.full(hg.num_nodes, -1, dtype=np.int64)
        local_of[verts] = np.arange(len(verts))
        nnz = int(members.shape[0])

        # bucketed static shapes (+1 ghost row each side)
        if pad_to is not None:
            n_pad, e_pad, nnz_pad = pad_to
            if len(verts) + 1 > n_pad or len(edges) + 1 > e_pad or nnz > nnz_pad:
                raise ValueError(
                    f"batch ({len(verts)}v/{len(edges)}e/{nnz}nnz) exceeds "
                    f"pad_to={pad_to}"
                )
        else:
            n_pad = _bucket(len(verts) + 1)
            e_pad = _bucket(len(edges) + 1)
            nnz_pad = _bucket(max(nnz, 1), minimum=64)

        # local Hᵀ CSR (edge-major)
        ht_indptr = np.zeros(len(edges) + 1, dtype=np.int64)
        np.cumsum(sizes, out=ht_indptr[1:])
        ht_indices = local_of[members].astype(np.int32)
        ht_ptr_p, ht_idx_p = _padded_csr(ht_indptr, ht_indices, e_pad,
                                         nnz_pad, pad_index=n_pad - 1)

        # local H CSR (vertex-major) from the COO
        e_local = np.repeat(np.arange(len(edges), dtype=np.int64), sizes)
        v_local = local_of[members]
        order = np.lexsort((e_local, v_local))
        h_indices = e_local[order].astype(np.int32)
        h_indptr = np.zeros(len(verts) + 1, dtype=np.int64)
        np.add.at(h_indptr, v_local + 1, 1)
        np.cumsum(h_indptr, out=h_indptr)
        h_ptr_p, h_idx_p = _padded_csr(h_indptr, h_indices, n_pad,
                                       nnz_pad, pad_index=e_pad - 1)

        # degrees sliced from the full graph (ghost rows → 1)
        degV = np.ones((n_pad, 1), dtype=np.float32)
        degV[: len(verts)] = hg.degV[verts]
        if self.deg_correction and len(edges) < hg.num_edges:
            # Horvitz-Thompson 1/p on the E→V sum (see the class)
            degV[: len(verts)] *= hg.num_edges / len(edges)
        degE = np.ones((e_pad, 1), dtype=np.float32)
        degE[: len(edges)] = hg.degE[edges]

        vertex_ids = np.zeros(n_pad, dtype=np.int32)
        vertex_ids[: len(verts)] = verts
        vertex_mask = np.zeros(n_pad, dtype=np.float32)
        vertex_mask[: len(verts)] = 1.0
        edge_ids = np.zeros(e_pad, dtype=np.int32)
        edge_ids[: len(edges)] = edges
        return HyperedgeBatch(
            ht_indptr=ht_ptr_p,
            ht_indices=ht_idx_p,
            h_indptr=h_ptr_p,
            h_indices=h_idx_p,
            degV=degV,
            degE=degE,
            vertex_ids=vertex_ids,
            vertex_mask=vertex_mask,
            edge_ids=edge_ids,
            num_real_vertices=len(verts),
            num_real_edges=len(edges),
            nnz=nnz,
            device=self.device,
        )

    def epoch(self, shuffle: bool = True,
              pad_to: Optional[tuple] = None) -> Iterator[HyperedgeBatch]:
        """One pass over all hyperedges in batches."""
        order = (
            self.rng.permutation(self.hg.num_edges)
            if shuffle
            else np.arange(self.hg.num_edges)
        )
        bs = self.batch_edges
        for i in range(0, len(order), bs):
            chunk = order[i : i + bs]
            if len(chunk) < bs and self.drop_last and i > 0:
                return
            yield self.induce(np.sort(chunk), pad_to=pad_to)

    def probe_pad_shapes(self, k: int = 8, margin: float = 1.5) -> tuple:
        """Conservative fixed bucket shapes for ``pad_to``: the max over
        ``k`` sampled batches × ``margin``, re-bucketed to powers of two."""
        n = e = z = 1
        for _ in range(k):
            b = self.sample_batch()
            n = max(n, b.num_real_vertices + 1)
            e = max(e, b.num_real_edges + 1)
            z = max(z, b.pad_shape[2])
        return (_bucket(int(n * margin)), _bucket(int(e * margin)),
                _bucket(int(z * margin), minimum=64))
