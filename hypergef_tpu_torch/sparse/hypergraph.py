"""Hypergraph data layer: incidence matrix in CSR both ways + degree vectors.

Port of ``hypergef_tpu/sparse/hypergraph.py``. The host side is the same
NumPy code (``:87-303``), so every host array is bit-identical to the JAX
package's for the same input; the device view :class:`HypergraphData`
(``:33-61``) holds torch tensors on a device the caller names.

Semantics (those of the reference, ``HyperGsys/hypergraph.py``):

* ``H`` is the |V|×|E| incidence matrix built from a bipartite COO
  (vertex, hyperedge) list.
* ``degV = (Σ_e H[v,e])^(-1/2)`` with ``inf → 1`` for isolated vertices.
* ``degE = (Σ_v H[v,e])^(-1)`` per hyperedge, with ``inf → 1`` for empty
  hyperedges so synthetic graphs stay finite.
* ``degD = degV^(-1)`` is kept for API parity.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Dict, Optional

import numpy as np
import torch

from hypergef_tpu_torch.ops.segment_sum import (
    RecordTable, SegmentTable, check_host_csr, max_warp_runs, warp_runs,
)


@dataclasses.dataclass(frozen=True)
class HypergraphData:
    """Device-side view of a hypergraph (``hypergraph.py:33-61``).

    Index tensors are int64, torch's index type; degrees are f32 columns.
    ``ht_*`` tensors enumerate nnz in hyperedge-major (Hᵀ CSR) order and
    feed the V→E stage; ``h_*`` tensors enumerate nnz in vertex-major
    (H CSR) order and feed the E→V stage.
    """

    ht_vertex: torch.Tensor  # [nnz] member vertex ids
    ht_segids: torch.Tensor  # [nnz] owning hyperedge ids (non-decreasing)
    ht_indptr: torch.Tensor  # [E+1] CSR row pointer of Hᵀ
    h_edge: torch.Tensor  # [nnz] incident hyperedge ids
    h_segids: torch.Tensor  # [nnz] owning vertex ids (non-decreasing)
    h_indptr: torch.Tensor  # [N+1] CSR row pointer of H
    degV: torch.Tensor  # [N, 1] f32
    degE: torch.Tensor  # [E, 1] f32
    num_nodes: int = 0
    num_edges: int = 0

    # The same two CSRs as tables of the segment-sum kernel (the cumsum
    # route), built on first use over the int64 tensors above plus their
    # int32 copies: V→E gathers vertices per hyperedge, E→V hyperedges per
    # vertex; each is the other's adjoint.
    @functools.cached_property
    def v2e(self) -> SegmentTable:
        return SegmentTable.from_long(self.ht_indptr, self.ht_vertex, self.num_nodes)

    @functools.cached_property
    def e2v(self) -> SegmentTable:
        return SegmentTable.from_long(self.h_indptr, self.h_edge, self.num_edges)

    # The max backward's table: ``e2v`` and, on a CUDA device, the
    # record-routed sum's layout of the edges (built on first use).
    @functools.cached_property
    def record(self) -> RecordTable:
        return RecordTable.over(self.e2v)

    @classmethod
    def from_host(cls, ht_indptr, ht_indices, h_indptr, h_indices, degV, degE, num_nodes: int,
                  num_edges: int, device) -> "HypergraphData":
        """The device view of host CSRs (NumPy) with their segment tables
        (:attr:`v2e`, :attr:`e2v`) built from the host arrays
        (:meth:`SegmentTable.from_host`): nothing is read back from the
        device, as a minibatch a step needs."""
        ht_indptr, h_indptr = (np.asarray(a, dtype=np.int64) for a in (ht_indptr, h_indptr))

        def idx(a):
            return torch.as_tensor(np.asarray(a, dtype=np.int64), device=device)

        data = cls(
            ht_vertex=idx(ht_indices),
            ht_segids=idx(np.repeat(np.arange(num_edges), np.diff(ht_indptr))),
            ht_indptr=idx(ht_indptr),
            h_edge=idx(h_indices),
            h_segids=idx(np.repeat(np.arange(num_nodes), np.diff(h_indptr))),
            h_indptr=idx(h_indptr),
            degV=torch.as_tensor(np.asarray(degV, dtype=np.float32), device=device),
            degE=torch.as_tensor(np.asarray(degE, dtype=np.float32), device=device),
            num_nodes=num_nodes,
            num_edges=num_edges,
        )
        # the cached properties' values, set where functools.cached_property
        # keeps them (a frozen dataclass refuses attribute assignment)
        data.__dict__["v2e"] = SegmentTable.from_host(ht_indptr, ht_indices, num_nodes,
                                                      data.ht_indptr, data.ht_vertex)
        data.__dict__["e2v"] = SegmentTable.from_host(h_indptr, h_indices, num_edges,
                                                      data.h_indptr, data.h_edge)
        return data


class StaticTables:
    """One minibatch pad shape's :class:`HypergraphData` (``num_nodes`` N,
    ``num_edges`` E, ``nnz`` entries each way) and the batch's ``rows``
    (int64 [N], the global id of each local row) and ``row_mask`` (f32 [N],
    1 on its real rows), whose tensors are written in place by
    :meth:`write` from each batch's host arrays.

    A recorded step reads the same addresses at every replay, so every
    tensor a batch changes lives here: both CSRs' int64 row pointers,
    indices and segment ids, their int32 copies, ``degV`` and ``degE``,
    each segment table's warp runs padded to :func:`max_warp_runs` of the
    shape (the kernel's launch is frozen at that count), the rows and the
    row mask. All of them are views (:attr:`tensors`) of one device
    buffer, filled by one copy a batch from one of two host staging
    buffers (page-locked on a card), so the host fills the next batch's
    while the last one's copy and step run; a staging buffer is refilled
    only after its last copy has ended. ``data.v2e``/``e2v`` are the
    segment tables over these views, with their runs on every device (the
    CPU's plain form ignores them). ``data.record`` is not built here: the
    minibatch routes sum."""

    def __init__(self, num_nodes: int, num_edges: int, nnz: int, device):
        self.device = torch.device(device)
        n, e, z = int(num_nodes), int(num_edges), int(nnz)
        self.shape = (n, e, z)
        self.runs = {"v2e": max_warp_runs(e, z), "e2v": max_warp_runs(n, z)}
        i64, i32, f32 = torch.int64, torch.int32, torch.float32
        spec = {
            "ht_vertex": (i64, (z,)), "ht_segids": (i64, (z,)), "ht_indptr": (i64, (e + 1,)),
            "h_edge": (i64, (z,)), "h_segids": (i64, (z,)), "h_indptr": (i64, (n + 1,)),
            "degV": (f32, (n, 1)), "degE": (f32, (e, 1)),
            "v2e_indptr": (i32, (e + 1,)), "v2e_gather": (i32, (z,)),
            "v2e_runs": (i32, (self.runs["v2e"] + 1, 2)),
            "e2v_indptr": (i32, (n + 1,)), "e2v_gather": (i32, (z,)),
            "e2v_runs": (i32, (self.runs["e2v"] + 1, 2)),
            "rows": (i64, (n,)), "row_mask": (f32, (n,)),
        }
        spans, size = {}, 0  # name -> (first byte, bytes), each view 16-byte aligned
        for name, (dtype, shape) in spec.items():
            nbytes = int(np.prod(shape)) * dtype.itemsize
            spans[name] = (size, nbytes)
            size += -(-nbytes // 16) * 16
        self.nbytes = size
        self._flat = torch.empty(size, dtype=torch.uint8, device=self.device)
        pin = self.device.type == "cuda"
        self._stage = [torch.empty(size, dtype=torch.uint8, pin_memory=pin) for _ in range(2)]
        self._copied = [None, None]  # the event after each staging buffer's last copy
        self._turn = 0

        def part(flat, name):
            first, nbytes = spans[name]
            return flat[first: first + nbytes]

        self.tensors = {name: part(self._flat, name).view(dtype).view(shape)
                        for name, (dtype, shape) in spec.items()}
        self._host = [{name: part(s, name).view(dtype).view(shape).numpy()
                       for name, (dtype, shape) in spec.items()} for s in self._stage]
        t = self.tensors
        data = HypergraphData(
            ht_vertex=t["ht_vertex"], ht_segids=t["ht_segids"], ht_indptr=t["ht_indptr"],
            h_edge=t["h_edge"], h_segids=t["h_segids"], h_indptr=t["h_indptr"],
            degV=t["degV"], degE=t["degE"], num_nodes=n, num_edges=e)
        data.__dict__["v2e"] = SegmentTable(
            indptr=t["v2e_indptr"], indptr_long=t["ht_indptr"], gather=t["v2e_gather"],
            gather_long=t["ht_vertex"], num_inputs=n, nnz=z, runs=t["v2e_runs"])
        data.__dict__["e2v"] = SegmentTable(
            indptr=t["e2v_indptr"], indptr_long=t["h_indptr"], gather=t["e2v_gather"],
            gather_long=t["h_edge"], num_inputs=e, nnz=z, runs=t["e2v_runs"])
        self.data = data

    def write(self, ht_indptr, ht_indices, h_indptr, h_indices, degV, degE, rows,
              row_mask) -> None:
        """Copy one batch's host CSRs (padded to this shape), degrees, rows
        and row mask into the tensors, in place. The checks of
        :meth:`SegmentTable.from_host` hold; a CSR whose warp runs would
        pass the padded count raises ``ValueError``, before anything is
        copied."""
        n, e, z = self.shape
        ht_ip, ht_g = check_host_csr(ht_indptr, ht_indices, n)
        h_ip, h_g = check_host_csr(h_indptr, h_indices, e)
        if ht_ip.shape != (e + 1,) or h_ip.shape != (n + 1,) or ht_ip[-1] != z or h_ip[-1] != z:
            raise ValueError(f"the batch's CSRs are not of the pad shape {self.shape}")
        v2e_runs = warp_runs(ht_ip, pad_to=self.runs["v2e"])
        e2v_runs = warp_runs(h_ip, pad_to=self.runs["e2v"])
        k = self._turn
        self._turn ^= 1
        if self._copied[k] is not None:
            self._copied[k].synchronize()  # that copy has read the buffer
        h = self._host[k]
        h["ht_indptr"][...] = ht_ip
        h["v2e_indptr"][...] = ht_ip
        h["ht_vertex"][...] = ht_g
        h["v2e_gather"][...] = ht_g
        h["ht_segids"][...] = np.repeat(np.arange(e), np.diff(ht_ip))
        h["h_indptr"][...] = h_ip
        h["e2v_indptr"][...] = h_ip
        h["h_edge"][...] = h_g
        h["e2v_gather"][...] = h_g
        h["h_segids"][...] = np.repeat(np.arange(n), np.diff(h_ip))
        h["degV"][...] = degV
        h["degE"][...] = degE
        h["v2e_runs"][...] = v2e_runs
        h["e2v_runs"][...] = e2v_runs
        h["rows"][...] = rows
        h["row_mask"][...] = row_mask
        self._flat.copy_(self._stage[k], non_blocking=True)
        if self.device.type == "cuda":
            ev = torch.cuda.Event()
            ev.record(torch.cuda.current_stream(self.device))
            self._copied[k] = ev


@dataclasses.dataclass
class Hypergraph:
    """Host-side hypergraph: CSR of H and Hᵀ plus degree vectors."""

    num_nodes: int
    num_edges: int
    # CSR of H (V×E): per-vertex sorted lists of incident hyperedges
    h_indptr: np.ndarray  # [N+1] int64
    h_indices: np.ndarray  # [nnz] int32
    # CSR of Hᵀ (E×V): per-hyperedge sorted lists of member vertices
    ht_indptr: np.ndarray  # [E+1] int64
    ht_indices: np.ndarray  # [nnz] int32
    name: str = "unnamed"

    def __post_init__(self):
        self.h_indptr = np.asarray(self.h_indptr, dtype=np.int64)
        self.h_indices = np.asarray(self.h_indices, dtype=np.int32)
        self.ht_indptr = np.asarray(self.ht_indptr, dtype=np.int64)
        self.ht_indices = np.asarray(self.ht_indices, dtype=np.int32)
        if self.h_indptr.shape != (self.num_nodes + 1,):
            raise ValueError("h_indptr shape mismatch")
        if self.ht_indptr.shape != (self.num_edges + 1,):
            raise ValueError("ht_indptr shape mismatch")
        if self.h_indices.shape != self.ht_indices.shape:
            raise ValueError("nnz mismatch between H and H^T")
        self._degV: Optional[np.ndarray] = None
        self._degE: Optional[np.ndarray] = None
        self._data: Dict[torch.device, HypergraphData] = {}

    # ------------------------------------------------------------------
    # constructors
    # ------------------------------------------------------------------
    @classmethod
    def from_coo(
        cls,
        vertex: np.ndarray,
        edge: np.ndarray,
        num_nodes: Optional[int] = None,
        num_edges: Optional[int] = None,
        name: str = "unnamed",
        dedup: bool = True,
    ) -> "Hypergraph":
        """Build from a bipartite COO membership list (vertex[k] ∈ edge[k]);
        duplicates are dropped since H is 0/1 (``hypergraph.py:118-166``)."""
        vertex = np.asarray(vertex, dtype=np.int64)
        edge = np.asarray(edge, dtype=np.int64)
        if vertex.shape != edge.shape or vertex.ndim != 1:
            raise ValueError("vertex/edge must be equal-length 1-D arrays")
        if num_nodes is None:
            num_nodes = int(vertex.max()) + 1 if vertex.size else 0
        if num_edges is None:
            num_edges = int(edge.max()) + 1 if edge.size else 0
        if dedup and vertex.size:
            flat = np.unique(vertex * num_edges + edge)
            vertex = flat // num_edges
            edge = flat % num_edges
        # CSR of H: sort by (vertex, edge)
        order_v = np.lexsort((edge, vertex))
        h_indices = edge[order_v].astype(np.int32)
        h_indptr = np.zeros(num_nodes + 1, dtype=np.int64)
        np.add.at(h_indptr, vertex + 1, 1)
        np.cumsum(h_indptr, out=h_indptr)
        # CSR of Hᵀ: sort by (edge, vertex)
        order_e = np.lexsort((vertex, edge))
        ht_indices = vertex[order_e].astype(np.int32)
        ht_indptr = np.zeros(num_edges + 1, dtype=np.int64)
        np.add.at(ht_indptr, edge + 1, 1)
        np.cumsum(ht_indptr, out=ht_indptr)
        return cls(
            num_nodes=num_nodes,
            num_edges=num_edges,
            h_indptr=h_indptr,
            h_indices=h_indices,
            ht_indptr=ht_indptr,
            ht_indices=ht_indices,
            name=name,
        )

    @classmethod
    def from_edge_index(
        cls,
        edge_index: np.ndarray,
        num_nodes: Optional[int] = None,
        name: str = "unnamed",
        compact: bool = False,
    ) -> "Hypergraph":
        """Build from a PyG/AllSet-style bipartite ``edge_index`` [2, M]
        (``hypergraph.py:168-211``).

        Row 0 holds vertex ids, then (past the split point) hyperedge ids
        offset by ``num_nodes``; only the V→E half is used. With
        ``compact=False`` hyperedge ids stay raw after the rebase and gaps
        become empty hyperedges; ``compact=True`` remaps the unique ids to
        ``0..k-1``.
        """
        edge_index = np.asarray(edge_index, dtype=np.int64)
        if num_nodes is None:
            raise ValueError("num_nodes is required for edge_index input")
        split = np.nonzero(edge_index[0] == num_nodes)[0]
        c_idx = int(split.min()) if split.size else edge_index.shape[1]
        v = edge_index[0, :c_idx]
        e = edge_index[1, :c_idx] - num_nodes
        if e.size and e.min() < 0:
            raise ValueError(
                "hyperedge ids below num_nodes in edge_index row 1 — "
                "row 1 must hold ids offset by num_nodes"
            )
        if compact:
            uniq, e = np.unique(e, return_inverse=True)
            num_edges = int(uniq.size)
        else:
            num_edges = int(e.max()) + 1 if e.size else 0
        return cls.from_coo(v, e, num_nodes=num_nodes, num_edges=num_edges, name=name)

    @classmethod
    def from_scipy(cls, H, name: str = "unnamed") -> "Hypergraph":
        """Build from a scipy sparse |V|×|E| incidence matrix."""
        coo = H.tocoo()
        return cls.from_coo(coo.row, coo.col, num_nodes=H.shape[0], num_edges=H.shape[1], name=name)

    # ------------------------------------------------------------------
    # derived quantities
    # ------------------------------------------------------------------
    @property
    def nnz(self) -> int:
        return int(self.h_indices.shape[0])

    @property
    def degV(self) -> np.ndarray:
        """[N,1] f32: rowsum(H)^(-1/2), inf→1."""
        if self._degV is None:
            rowsum = np.diff(self.h_indptr).astype(np.float64)
            with np.errstate(divide="ignore"):
                d = rowsum ** -0.5
            d[~np.isfinite(d)] = 1.0
            self._degV = d.astype(np.float32)[:, None]
        return self._degV

    @property
    def degE(self) -> np.ndarray:
        """[E,1] f32: colsum(H)^(-1), inf→1."""
        if self._degE is None:
            colsum = np.diff(self.ht_indptr).astype(np.float64)
            with np.errstate(divide="ignore"):
                d = 1.0 / colsum
            d[~np.isfinite(d)] = 1.0
            self._degE = d.astype(np.float32)[:, None]
        return self._degE

    @property
    def degD(self) -> np.ndarray:
        """[N,1] f32: degV^(-1), kept for parity."""
        with np.errstate(divide="ignore"):
            d = 1.0 / self.degV
        d[~np.isfinite(d)] = 1.0
        return d.astype(np.float32)

    def edge_sizes(self) -> np.ndarray:
        return np.diff(self.ht_indptr)

    def vertex_degrees(self) -> np.ndarray:
        return np.diff(self.h_indptr)

    # ------------------------------------------------------------------
    # device view
    # ------------------------------------------------------------------
    def device_data(self, device) -> HypergraphData:
        """Tensors every route consumes, on ``device`` (cached per device;
        ``hypergraph.py:265-288``)."""
        device = torch.device(device)
        if device not in self._data:
            ht_segids = np.repeat(np.arange(self.num_edges), self.edge_sizes())
            h_segids = np.repeat(np.arange(self.num_nodes), self.vertex_degrees())

            def idx(a):
                return torch.as_tensor(np.asarray(a, dtype=np.int64), device=device)

            self._data[device] = HypergraphData(
                ht_vertex=idx(self.ht_indices),
                ht_segids=idx(ht_segids),
                ht_indptr=idx(self.ht_indptr),
                h_edge=idx(self.h_indices),
                h_segids=idx(h_segids),
                h_indptr=idx(self.h_indptr),
                degV=torch.as_tensor(self.degV, device=device),
                degE=torch.as_tensor(self.degE, device=device),
                num_nodes=self.num_nodes,
                num_edges=self.num_edges,
            )
        return self._data[device]

    # ------------------------------------------------------------------
    # interop
    # ------------------------------------------------------------------
    def to_scipy(self):
        import scipy.sparse as sp

        return sp.csr_matrix(
            (
                np.ones(self.nnz, dtype=np.float32),
                self.h_indices.astype(np.int64),
                self.h_indptr,
            ),
            shape=(self.num_nodes, self.num_edges),
        )

    def store_mtx(self, path: str) -> str:
        """Write H as MatrixMarket to ``path + name + ".mtx"``
        (``hypergraph.py:305-311``); returns the file's name."""
        from hypergef_tpu_torch.sparse import mtx

        file_name = str(path) + self.name + ".mtx"
        mtx.write_mtx(file_name, self)
        return file_name

    def __repr__(self) -> str:
        return (
            f"Hypergraph(name={self.name!r}, |V|={self.num_nodes}, "
            f"|E|={self.num_edges}, nnz={self.nnz})"
        )
