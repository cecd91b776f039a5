"""Hyperedge-contiguous partition of a hypergraph over the ranks, and the
stacked plan of the edge-partitioned aggregation.

Port of ``hypergef_tpu/parallel/partition.py`` (``:1-267``) as the same
NumPy code over the port's :func:`~hypergef_tpu_torch.sparse.planner.plan_tree`,
``TreeLevel`` and ``TreeStage``, so every host array of a
:class:`ShardedAggPlan` is bit-equal to the JAX package's. The top-level
cut is an nnz-balanced 1-D partition of Hᵀ (``edge_partition_bounds``):
the ``degE·Wdiag`` scaling stays local and only vertex-side partials cross
ranks, combined by one reduction.

The arrays keep JAX's leading shard axis; a rank reads its own slice only
(:meth:`ShardedAggPlan.local`), and puts only that on its device.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from hypergef_tpu_torch.ops.segment_sum import RecordTable, SegmentTable
from hypergef_tpu_torch.sparse.hypergraph import Hypergraph
from hypergef_tpu_torch.sparse.planner import (
    DeviceStage, TreeLevel, TreeStage, choose_ngs, plan_tree,
)


def edge_partition_bounds(hg: Hypergraph, n_shards: int) -> np.ndarray:
    """Contiguous hyperedge ranges with balanced nnz: ``[n+1]`` cuts
    (``:26-35``)."""
    total = hg.nnz
    targets = (np.arange(1, n_shards) * total) / n_shards
    cuts = np.searchsorted(hg.ht_indptr, targets, side="left")
    return np.concatenate([[0], cuts, [hg.num_edges]]).astype(np.int64)


def _local_subgraph(hg: Hypergraph, e0: int, e1: int) -> Hypergraph:
    """Hyperedges [e0, e1) with local edge ids and global vertex ids
    (``:38-49``)."""
    lo, hi = int(hg.ht_indptr[e0]), int(hg.ht_indptr[e1])
    sizes = np.diff(hg.ht_indptr[e0: e1 + 1])
    v = hg.ht_indices[lo:hi].astype(np.int64)
    e = np.repeat(np.arange(e1 - e0, dtype=np.int64), sizes)
    return Hypergraph.from_coo(v, e, num_nodes=hg.num_nodes, num_edges=max(e1 - e0, 1),
                               name=f"{hg.name}[{e0}:{e1}]", dedup=False)


def _identity_level(rows: int, fan: int) -> TreeLevel:
    g = np.zeros((max(rows, 1), fan), dtype=np.int32)
    g[:, 0] = np.arange(max(rows, 1), dtype=np.int32)
    m = np.zeros((max(rows, 1), fan), dtype=np.float32)
    m[:, 0] = 1.0
    return TreeLevel(gather_idx=g, mask=m)


def _pad_level(lvl: TreeLevel, c_to: int) -> TreeLevel:
    c = lvl.gather_idx.shape[0]
    if c == c_to:
        return lvl
    g = np.zeros((c_to, lvl.gather_idx.shape[1]), dtype=np.int32)
    m = np.zeros((c_to, lvl.mask.shape[1]), dtype=np.float32)
    g[:c] = lvl.gather_idx
    m[:c] = lvl.mask
    return TreeLevel(gather_idx=g, mask=m)


def unify_stages(stages: List[TreeStage], seg_to: int, fan: int):
    """Pad per-shard stages to one shape and stack them on a leading shard
    axis (``:73-108``): (levels ``[(g [D, C, fan], m), ...]``, final_idx,
    final_mask, counts ``[D, seg_to]``)."""
    depth = max(len(s.levels) for s in stages)
    per_shard_levels = []
    for s in stages:
        lvls = list(s.levels)
        last_c = lvls[-1].gather_idx.shape[0] if lvls else 1
        while len(lvls) < depth:
            lvls.append(_identity_level(last_c, fan))
        per_shard_levels.append(lvls)
    stacked_levels = []
    for li in range(depth):
        c_max = max(ls[li].gather_idx.shape[0] for ls in per_shard_levels)
        gs = np.stack([_pad_level(ls[li], c_max).gather_idx for ls in per_shard_levels])
        ms = np.stack([_pad_level(ls[li], c_max).mask for ls in per_shard_levels])
        stacked_levels.append((gs, ms))
    fi = np.zeros((len(stages), seg_to), dtype=np.int32)
    fm = np.zeros((len(stages), seg_to), dtype=np.float32)
    cn = np.zeros((len(stages), seg_to), dtype=np.float32)
    for d, s in enumerate(stages):
        k = s.final_idx.shape[0]
        fi[d, :k] = s.final_idx
        fm[d, :k] = s.final_mask
        cn[d, :k] = s.counts
    return stacked_levels, fi, fm, cn


def shard_stage(levels, final_idx, final_mask, counts, d: int, num_inputs: int) -> TreeStage:
    """Shard ``d``'s :class:`TreeStage` out of the stacked arrays."""
    return TreeStage(
        levels=tuple(TreeLevel(gather_idx=g[d], mask=m[d]) for g, m in levels),
        final_idx=final_idx[d], final_mask=final_mask[d],
        counts=(counts[d] if counts is not None
                else np.zeros(final_idx.shape[1], np.float32)),
        num_inputs=num_inputs, num_segments=final_idx.shape[1])


def _shard_edge_vector(vec, n_shards: int, e_pad: int, bounds) -> np.ndarray:
    vec = np.asarray(vec)
    out = np.zeros((n_shards, e_pad, vec.shape[1]), dtype=vec.dtype)
    for d in range(n_shards):
        e0, e1 = int(bounds[d]), int(bounds[d + 1])
        out[d, : e1 - e0] = vec[e0:e1]
    return out


@dataclasses.dataclass(frozen=True)
class LocalAgg:
    """One rank's share of a :class:`ShardedAggPlan` on its device."""

    e_stage: DeviceStage  # V→E over the local edges, [N] → [e_pad]
    v_stage: DeviceStage  # E→V partial, [e_pad] → [N]; the adjoint of e_stage
    e_counts: torch.Tensor  # f32 [e_pad]
    degE: torch.Tensor  # f32 [e_pad, 1]
    record: Optional[RecordTable]  # the max backward's vertex-major local CSR


@dataclasses.dataclass
class ShardedAggPlan:
    """Stacked SPMD aggregation plan (``:111-209``): per-shard reduction
    trees padded to one shape, with a leading shard axis."""

    n_shards: int
    num_nodes: int
    num_edges: int
    e_pad: int
    edge_bounds: np.ndarray
    e_levels: list
    e_final_idx: np.ndarray
    e_final_mask: np.ndarray
    e_counts: np.ndarray
    v_levels: list
    v_final_idx: np.ndarray
    v_final_mask: np.ndarray
    degE: np.ndarray
    h_indptr: Optional[np.ndarray] = None  # [D, N+1] int32
    h_edge: Optional[np.ndarray] = None  # [D, nnz_pad] int32
    h_segids: Optional[np.ndarray] = None  # [D, nnz_pad] int32
    _local: Dict[Tuple[int, torch.device], LocalAgg] = dataclasses.field(
        default_factory=dict, repr=False, compare=False)

    def __getstate__(self):
        state = dict(self.__dict__)
        state["_local"] = {}
        return state

    def local(self, rank: int, device) -> LocalAgg:
        """Shard ``rank``'s stages, degrees and (for max) record table on
        ``device``, built once; only this shard's slice is moved."""
        device = torch.device(device)
        key = (rank, device)
        if key not in self._local:
            e_st = shard_stage(self.e_levels, self.e_final_idx, self.e_final_mask,
                               self.e_counts, rank, self.num_nodes)
            v_st = shard_stage(self.v_levels, self.v_final_idx, self.v_final_mask, None,
                               rank, self.e_pad)
            record = None
            if self.h_indptr is not None:
                ip = self.h_indptr[rank].astype(np.int64)
                nnz = int(ip[-1])
                edge = self.h_edge[rank, :nnz].astype(np.int64)
                e2v = SegmentTable.from_host(
                    ip, edge, self.e_pad, torch.as_tensor(ip, device=device),
                    torch.as_tensor(edge, device=device))
                record = RecordTable.over(e2v)
            self._local[key] = LocalAgg(
                e_stage=DeviceStage.from_stage(e_st, device, kernel_level0=False),
                v_stage=DeviceStage.from_stage(v_st, device, kernel_level0=False),
                e_counts=torch.as_tensor(self.e_counts[rank], device=device),
                degE=torch.as_tensor(self.degE[rank], device=device),
                record=record)
        return self._local[key]

    def shard_edge_vector(self, vec: np.ndarray) -> np.ndarray:
        """A global per-hyperedge [E, k] vector in the stacked layout
        [D, e_pad, k] (``:196-205``)."""
        return _shard_edge_vector(vec, self.n_shards, self.e_pad, self.edge_bounds)


def plan_sharded_aggregation(hg: Hypergraph, n_shards: int, ngs: Optional[int] = None,
                             fan: int = 8, with_max: bool = True) -> ShardedAggPlan:
    """The stacked plan of an ``n_shards``-way edge partition
    (``:208-267``); ``with_max`` adds each shard's vertex-major local CSR
    for the max backward."""
    bounds = edge_partition_bounds(hg, n_shards)
    e_stages, v_stages, subs = [], [], []
    e_pad = int((bounds[1:] - bounds[:-1]).max())
    if ngs is None:
        ngs = choose_ngs(hg.edge_sizes(), min_ngs=4, max_ngs=64, step=4)
    ngs_v = choose_ngs(hg.vertex_degrees(), min_ngs=4, max_ngs=64, step=4)
    for d in range(n_shards):
        e0, e1 = int(bounds[d]), int(bounds[d + 1])
        sub = _local_subgraph(hg, e0, e1)
        subs.append(sub)
        sub_plan = plan_tree(sub, ngs=ngs, ngs_vertex=ngs_v, fan=fan)
        e_stages.append(sub_plan.edge_stage)
        v_stages.append(sub_plan.vertex_stage)
    e_levels, e_fi, e_fm, e_cn = unify_stages(e_stages, e_pad, fan)
    v_levels, v_fi, v_fm, _ = unify_stages(v_stages, hg.num_nodes, fan)
    degE = np.zeros((n_shards, e_pad, 1), dtype=np.float32)
    for d in range(n_shards):
        e0, e1 = int(bounds[d]), int(bounds[d + 1])
        degE[d, : e1 - e0] = hg.degE[e0:e1]
    h_ip = h_ed = h_sg = None
    if with_max:
        nnz_pad = max(int(s.nnz) for s in subs)
        h_ip = np.zeros((n_shards, hg.num_nodes + 1), np.int32)
        h_ed = np.zeros((n_shards, nnz_pad), np.int32)
        h_sg = np.zeros((n_shards, nnz_pad), np.int32)
        for d, sub in enumerate(subs):
            h_ip[d] = sub.h_indptr.astype(np.int32)
            h_ed[d, : sub.nnz] = sub.h_indices.astype(np.int32)
            h_sg[d, : sub.nnz] = np.repeat(np.arange(hg.num_nodes, dtype=np.int32),
                                           np.diff(sub.h_indptr).astype(np.int64))
    return ShardedAggPlan(
        n_shards=n_shards, num_nodes=hg.num_nodes, num_edges=hg.num_edges, e_pad=e_pad,
        edge_bounds=bounds, e_levels=e_levels, e_final_idx=e_fi, e_final_mask=e_fm,
        e_counts=e_cn, v_levels=v_levels, v_final_idx=v_fi, v_final_mask=v_fm, degE=degE,
        h_indptr=h_ip, h_edge=h_ed, h_segids=h_sg)
