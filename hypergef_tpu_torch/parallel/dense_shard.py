"""Edge-sharded dense incidence, int8 or packed int4: each rank holds a
hyperedge-contiguous slice ``H_d = H[:, e_d:e_{d+1}]`` and computes both
dense stages.

Port of ``hypergef_tpu/parallel/dense_shard.py`` (``:1-269``):

    out = Σ_d ( H_d · diag(degE_d·W_d) · H_dᵀ · X ) · diag(degV)

The two stages are library products, as JAX computes them outside any
Pallas kernel (``:159-182``): ``H_dᵀ · bf16(X)`` and ``H_d · bf16(xe)``
with f32 results (``torch.mm(..., out_dtype=torch.float32)`` on bf16 on the
card, an f32 product of the bf16-valued operands on the CPU, which has no
such kernel). The backward is JAX's transpose of those dots: the f32
cotangent times the table, rounded to bf16 after the product (the
transpose of ``astype(bf16)``), for each stage. The partials combine
through :func:`~.comm.sum_to_replicated`, X enters through
:func:`~.comm.from_replicated` (:mod:`.dist_aggr`'s rule).

Each product converts the table a block of rows at a time
(``DENSE_BLOCK_BYTES`` of f32 rows at most), so a rank holds its
slice, which ``DENSE_SHARD_MAX_BYTES`` bounds, and one converted block
beside it; with one block the products are the whole-slice ones.

``feature_sharded=True`` slices the columns around the products as
:mod:`.dist_aggr` does (``:185-269``); the row blocks are unchanged.

``packed=True`` is JAX's explicit opt-in (``:99-156``): each slice is the
packed-int4 nibble carrier [N, e_pad/2], bit for bit JAX's, and the byte
guard counts the carrier's bytes. The products unpack it one row block at a
time (JAX unpacks the slice in XLA ahead of the same dots,
``_two_stage_local``), so a rank holds its carrier and one unpacked,
converted block, never a whole unpacked slice; the results are the
unpacked slice's, bitwise.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from hypergef_tpu_torch.parallel.comm import from_replicated, sum_to_replicated
from hypergef_tpu_torch.parallel.dist_aggr import columns_in, columns_out
from hypergef_tpu_torch.parallel.mesh import Mesh, make_mesh
from hypergef_tpu_torch.parallel.partition import _shard_edge_vector, edge_partition_bounds
from hypergef_tpu_torch.sparse.hypergraph import Hypergraph
from hypergef_tpu_torch.sparse.planner import pack_nibbles, unpack_nibbles

# the slice a rank may hold, int8 or carrier bytes (``:48``)
DENSE_SHARD_MAX_BYTES = 2 << 30
# the table's rows converted at a time, counted as f32
DENSE_BLOCK_BYTES = 256 << 20


@dataclasses.dataclass(frozen=True)
class LocalDense:
    """One rank's slice on its device: int8 H_d [N, e_pad] (or its nibble
    carrier [N, e_pad/2] where ``packed``), the degrees and the member
    counts."""

    h: torch.Tensor  # int8 [N, e_pad], or the carrier [N, e_pad/2]
    degE: torch.Tensor  # f32 [e_pad, 1]
    counts: torch.Tensor  # f32 [e_pad, 1]
    packed: bool = False

    def rows(self, a: int, b: int, dtype: torch.dtype) -> torch.Tensor:
        """Rows [a, b) of H_d as ``dtype`` [b-a, e_pad], the carrier's
        unpacked first."""
        h = self.h[a:b]
        return (unpack_nibbles(h, self.degE.shape[0]) if self.packed else h).to(dtype)


@dataclasses.dataclass
class ShardedDensePlan:
    """Stacked int8 H slices (``:52-97``), one a shard; with ``packed`` the
    stacked nibble carriers [D, N, e_pad/2] (low nibble the even local
    column)."""

    n_shards: int
    num_nodes: int
    num_edges: int
    e_pad: int
    edge_bounds: np.ndarray
    h: np.ndarray  # [D, N, e_pad] int8 counts, or [D, N, e_pad/2] packed
    degE: np.ndarray  # [D, e_pad, 1] f32
    counts: np.ndarray  # [D, e_pad, 1] f32
    packed: bool = False
    _local: Dict[Tuple[int, torch.device], LocalDense] = dataclasses.field(
        default_factory=dict, repr=False, compare=False)

    def __getstate__(self):
        state = dict(self.__dict__)
        state["_local"] = {}
        return state

    def local(self, rank: int, device) -> LocalDense:
        device = torch.device(device)
        key = (rank, device)
        if key not in self._local:
            self._local[key] = LocalDense(
                h=torch.as_tensor(self.h[rank], device=device),
                degE=torch.as_tensor(self.degE[rank], device=device),
                counts=torch.as_tensor(self.counts[rank], device=device), packed=self.packed)
        return self._local[key]

    def shard_edge_vector(self, vec: np.ndarray) -> np.ndarray:
        return _shard_edge_vector(vec, self.n_shards, self.e_pad, self.edge_bounds)

    def table_bytes_per_device(self) -> int:
        return self.num_nodes * (self.e_pad // 2 if self.packed else self.e_pad)


def plan_sharded_dense(hg: Hypergraph, n_shards: int,
                       max_bytes_per_device: int = DENSE_SHARD_MAX_BYTES,
                       packed: bool = False) -> ShardedDensePlan:
    """The stacked int8 slices of an ``n_shards``-way edge-contiguous
    partition (``:100-156``), or with ``packed`` their nibble carriers.
    Raises ``MemoryError`` past the byte guard, and, packed, where a count
    exceeds 7."""
    bounds = edge_partition_bounds(hg, n_shards)
    widths = np.diff(bounds)
    e_pad = -(-int(max(widths.max(), 1)) // 2) * 2  # even, for nibble pairs
    table_bytes = hg.num_nodes * (e_pad // 2 if packed else e_pad)
    if table_bytes > max_bytes_per_device:
        raise MemoryError(
            f"dense shard slice {hg.num_nodes} x {e_pad} ({table_bytes} bytes) exceeds "
            f"{max_bytes_per_device} bytes/device — use the tree-based sharded plan or more "
            "shards")
    h = np.zeros((n_shards, hg.num_nodes, e_pad), np.int8)
    degE = np.zeros((n_shards, e_pad, 1), np.float32)
    counts = np.ones((n_shards, e_pad, 1), np.float32)
    sizes_all = np.diff(hg.ht_indptr)
    for d in range(n_shards):
        e0, e1 = int(bounds[d]), int(bounds[d + 1])
        lo, hi = int(hg.ht_indptr[e0]), int(hg.ht_indptr[e1])
        local_e = np.repeat(np.arange(e1 - e0, dtype=np.int64), sizes_all[e0:e1])
        np.add.at(h[d], (hg.ht_indices[lo:hi].astype(np.int64), local_e), 1)
        degE[d, : e1 - e0] = hg.degE[e0:e1]
        counts[d, : e1 - e0, 0] = np.maximum(sizes_all[e0:e1], 1)
    if packed:
        if h.max(initial=0) > 7:
            raise MemoryError(">7 duplicate incidences — packed int4 cannot represent "
                              "this graph; use packed=False")
        h = pack_nibbles(h)
    return ShardedDensePlan(n_shards=n_shards, num_nodes=hg.num_nodes,
                            num_edges=hg.num_edges, e_pad=e_pad, edge_bounds=bounds, h=h,
                            degE=degE, counts=counts, packed=packed)


def _mm_bf16(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a·b`` of two bf16 operands, f32 result (not rounded)."""
    if a.device.type == "cuda":
        return torch.mm(a, b, out_dtype=torch.float32)
    return a.float() @ b.float()


def _row_blocks(h: torch.Tensor, e: Optional[int] = None):
    """[a, b) row ranges of ``h`` of at most ``DENSE_BLOCK_BYTES`` as f32
    [rows, e] (``e``: its columns, a carrier's unpacked ones)."""
    n, e = h.shape[0], h.shape[1] if e is None else e
    rows = max(1, DENSE_BLOCK_BYTES // max(4 * e, 1))
    return [(a, min(a + rows, n)) for a in range(0, n, rows)]


class _TwoStage(torch.autograd.Function):
    """``H_d · bf16(scale · (H_dᵀ · bf16(x)))`` (``:159-182``), a block of
    the table's rows at a time."""

    @staticmethod
    def forward(ctx, x, loc: LocalDense, scale):
        ctx.loc, ctx.scale = loc, scale
        xb = x.to(torch.bfloat16)
        blocks = _row_blocks(loc.h, loc.degE.shape[0])
        xe = None
        for a, b in blocks:
            part = _mm_bf16(loc.rows(a, b, torch.bfloat16).t(), xb[a:b])
            xe = part if xe is None else xe + part
        xe = (xe * scale).to(torch.bfloat16)
        out = x.new_empty((loc.h.shape[0], x.shape[1]), dtype=torch.float32)
        for a, b in blocks:
            out[a:b] = _mm_bf16(loc.rows(a, b, torch.bfloat16), xe)
        return out

    @staticmethod
    def backward(ctx, g):
        loc, scale = ctx.loc, ctx.scale
        blocks = _row_blocks(loc.h, loc.degE.shape[0])
        # JAX's transpose of each bf16 dot: the f32 cotangent times the
        # table, then the cast's transpose rounds it to bf16
        ge = None
        for a, b in blocks:
            part = loc.rows(a, b, torch.float32).t() @ g[a:b]
            ge = part if ge is None else ge + part
        ge = ge.to(torch.bfloat16).float() * scale
        dx = torch.empty_like(g)
        for a, b in blocks:
            dx[a:b] = (loc.rows(a, b, torch.float32) @ ge).to(torch.bfloat16).float()
        return dx, None, None


def _scale(loc: LocalDense, first_aggr: str, wdiag_local) -> torch.Tensor:
    scale = loc.degE
    if first_aggr == "mean":
        scale = scale / loc.counts
    if wdiag_local is not None:
        scale = scale * wdiag_local
    return scale


def local_two_stage(loc: LocalDense, x: torch.Tensor, first_aggr: str = "sum") -> torch.Tensor:
    """One rank's partial ``H_d · diag(scale) · H_dᵀ · x`` over its own slice,
    the two library products and no exchange (``_two_stage_local``,
    ``:159-182``): the compute that runs D-way parallel."""
    return _TwoStage.apply(x, loc, _scale(loc, first_aggr, None))


def _local(plan, mesh, x):
    mesh = mesh or make_mesh()
    if mesh.size != plan.n_shards:
        raise ValueError(f"plan of {plan.n_shards} shards on a mesh of {mesh.size} ranks")
    return mesh, plan.local(mesh.rank, x.device)


def sharded_dense_hgnn_aggregate(plan: ShardedDensePlan, x: torch.Tensor, wdiag_local=None,
                                 first_aggr: str = "sum", degV=None,
                                 mesh: Optional[Mesh] = None,
                                 feature_sharded: bool = False) -> torch.Tensor:
    """HGNN aggregation on the slices (``:185-230``): ``x`` [N, F] the
    same on every rank, result [N, F] the same on every rank."""
    if first_aggr not in ("sum", "mean"):
        raise ValueError("dense shard path supports first_aggr in {sum, mean}")
    mesh, loc = _local(plan, mesh, x)
    x = from_replicated(columns_in(x, mesh, feature_sharded), mesh.group)
    part = _TwoStage.apply(x, loc, _scale(loc, first_aggr, wdiag_local))
    out = sum_to_replicated(part, mesh.group)
    return columns_out(out * degV if degV is not None else out, mesh, feature_sharded)


def sharded_dense_unignn_aggregate(plan: ShardedDensePlan, x: torch.Tensor,
                                   use_deg: bool = False, degV=None,
                                   mesh: Optional[Mesh] = None,
                                   feature_sharded: bool = False) -> torch.Tensor:
    """UniGNN aggregation (``H Hᵀ x``, or degree-scaled) on the slices
    (``:233-269``)."""
    mesh, loc = _local(plan, mesh, x)
    x = from_replicated(columns_in(x, mesh, feature_sharded), mesh.group)
    scale = loc.degE if use_deg else torch.ones_like(loc.degE)
    part = _TwoStage.apply(x, loc, scale)
    out = sum_to_replicated(part, mesh.group)
    return columns_out(out * degV if use_deg and degV is not None else out, mesh,
                       feature_sharded)
