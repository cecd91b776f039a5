"""Block-sparse (BSR) incidence plans: the ``bsr`` route's host tables.

Port of ``hypergef_tpu/sparse/bsr.py`` (``:1-251``), as the same NumPy code,
so every host table is bit-identical to the JAX package's. H is cut into
128×128 blocks and only the blocks that hold an incidence are kept; each
aggregation direction is then

    gather the source block-rows → one 128×128 product a block
    → a reduction tree over the block partials of each block-row

(:mod:`hypergef_tpu_torch.ops.bsr_ops`). Fill decides the cost, so the
planner can renumber vertices and hyperedges first: reverse Cuthill-McKee
on the bipartite graph (``rcm``) or the community order
(``community``). A budget refuses the form with ``MemoryError`` before
the blocks are made when they would exceed it.

The tables stay host NumPy; :meth:`BsrPlan.device` puts them on a torch
device once (the blocks in bf16: 0/1 entries are exact).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from hypergef_tpu_torch.sparse.planner import DeviceStage, TreeStage, build_tree

BLOCK = 128


def rcm_bipartite_order(hg) -> Tuple[np.ndarray, np.ndarray]:
    """Vertex and hyperedge permutations from reverse Cuthill-McKee on the
    bipartite graph [[0, H], [Hᵀ, 0]] (``:34-48``)."""
    import scipy.sparse as sp
    from scipy.sparse.csgraph import reverse_cuthill_mckee

    H = hg.to_scipy()
    n = hg.num_nodes
    bip = sp.bmat([[None, H], [H.T, None]], format="csr")
    order = np.asarray(reverse_cuthill_mckee(bip, symmetric_mode=True))
    vperm = order[order < n]
    eperm = order[order >= n] - n
    return vperm.astype(np.int64), eperm.astype(np.int64)


@dataclasses.dataclass
class BsrStage:
    """One aggregation direction as block products and a block combine
    (``:51-72``): ``y[row block] = Σ_b M_b @ x[bcol[b]]`` over the row
    block's nonzero blocks, the Σ a :class:`TreeStage` over the partials."""

    blocks: np.ndarray  # [NB, BLOCK, BLOCK] f32 0/1 block data of M
    bcol: np.ndarray  # [NB] int32 source block-column of each block
    combine: TreeStage  # over the NB block partials → num_row_blocks segments
    num_rows: int  # true output rows (≤ num_row_blocks·BLOCK)
    num_cols: int  # true input rows
    num_row_blocks: int
    num_col_blocks: int

    @property
    def nbytes_bf16(self) -> int:
        return self.blocks.shape[0] * BLOCK * BLOCK * 2


def build_bsr_stage(indptr, indices, num_rows, num_cols,
                    max_bytes: Optional[int] = None) -> BsrStage:
    """The BSR form of the 0/1 CSR matrix M (rows × cols) (``:75-121``).
    ``max_bytes``: raise ``MemoryError`` before the blocks are made when
    their bf16 storage would exceed it."""
    indptr = np.asarray(indptr, dtype=np.int64)
    indices = np.asarray(indices, dtype=np.int64)
    nrb = -(-num_rows // BLOCK)
    ncb = -(-num_cols // BLOCK)
    row_of = np.repeat(np.arange(num_rows, dtype=np.int64), np.diff(indptr))
    brow = row_of // BLOCK
    bcol_all = indices // BLOCK
    key = brow * ncb + bcol_all
    uniq, inv = np.unique(key, return_inverse=True)
    nb = len(uniq)
    if max_bytes is not None and nb * BLOCK * BLOCK * 2 > max_bytes:
        nnz = len(indices)
        raise MemoryError(
            f"BSR blocks need {nb * BLOCK * BLOCK * 2 / 1e9:.2f} GB > budget "
            f"{max_bytes / 1e9:.2f} GB (fill {nnz / (nb * BLOCK * BLOCK):.4f}); "
            "use the tree backend for this graph"
        )
    blocks = np.zeros((max(nb, 1), BLOCK, BLOCK), dtype=np.float32)
    r_in = (row_of % BLOCK).astype(np.int64)
    c_in = (indices % BLOCK).astype(np.int64)
    # duplicates accumulate, then clip: H is 0/1
    np.add.at(blocks, (inv, r_in, c_in), 1.0)
    blocks = np.minimum(blocks, 1.0)
    ub_row = (uniq // ncb).astype(np.int64)
    ub_col = (uniq % ncb).astype(np.int32)
    # np.unique sorts the blocks by row block: a block-level CSR over them
    rowptr = np.zeros(nrb + 1, dtype=np.int64)
    np.add.at(rowptr, ub_row + 1, 1)
    np.cumsum(rowptr, out=rowptr)
    combine = build_tree(rowptr, np.arange(max(nb, 1), dtype=np.int32), max(nb, 1),
                         ngs=4, fan=8)
    return BsrStage(blocks=blocks, bcol=ub_col, combine=combine, num_rows=num_rows,
                    num_cols=num_cols, num_row_blocks=nrb, num_col_blocks=ncb)


class BsrStageDev(NamedTuple):
    """A :class:`BsrStage` on one torch device."""

    blocks: torch.Tensor  # bf16 [NB, BLOCK, BLOCK]
    bcol: torch.Tensor  # int64 [NB]
    combine: DeviceStage  # plain tree over the block partials
    num_rows: int


class BsrPlanDev(NamedTuple):
    """A :class:`BsrPlan` on one torch device: both stages and the
    permutations (None without reordering). ``einv`` is the hyperedge
    permutation's inverse, which JAX's device tuple does not carry: the
    port's permutation backward gathers through it instead of scattering."""

    edge_stage: BsrStageDev
    vertex_stage: BsrStageDev
    vperm: Optional[torch.Tensor]  # int64 [N]
    vinv: Optional[torch.Tensor]  # int64 [N]
    eperm: Optional[torch.Tensor]  # int64 [E]
    einv: Optional[torch.Tensor]  # int64 [E]


def _stage_device(st: BsrStage, device) -> BsrStageDev:
    # rounded to bf16 on the host: the f32 blocks never reach the device
    blocks = torch.from_numpy(st.blocks).to(torch.bfloat16).to(device)
    return BsrStageDev(
        blocks=blocks,
        bcol=torch.as_tensor(st.bcol.astype(np.int64), device=device),
        combine=DeviceStage.from_stage(st.combine, device, kernel_level0=False),
        num_rows=st.num_rows)


def _inverse(perm: np.ndarray) -> np.ndarray:
    inv = np.empty_like(perm)
    inv[perm] = np.arange(len(perm))
    return inv


@dataclasses.dataclass
class BsrPlan:
    """Two-direction BSR plan and its optional renumbering (``:124-186``).
    The device tables are cached per device and are not an init field."""

    edge_stage: BsrStage  # V→E (M = Hᵀ)
    vertex_stage: BsrStage  # E→V (M = H)
    vperm: Optional[np.ndarray] = None  # [N] vertex permutation
    eperm: Optional[np.ndarray] = None  # [E] hyperedge permutation
    _device: Dict[torch.device, BsrPlanDev] = dataclasses.field(
        default_factory=dict, init=False, repr=False, compare=False)

    @property
    def nbytes_bf16(self) -> int:
        return self.edge_stage.nbytes_bf16 + self.vertex_stage.nbytes_bf16

    def fill_fraction(self) -> float:
        nb = self.edge_stage.blocks.shape[0]
        nnz = float(self.edge_stage.blocks.sum())
        return nnz / (nb * BLOCK * BLOCK)

    def device(self, device) -> BsrPlanDev:
        """Both stages and the permutations on ``device``, built once per
        device."""
        device = torch.device(device)
        if device.type == "cuda" and device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
        if device not in self._device:
            perms = [None] * 4
            if self.vperm is not None:
                perms = [torch.as_tensor(p.astype(np.int64), device=device) for p in (
                    self.vperm, _inverse(self.vperm), self.eperm, _inverse(self.eperm))]
            self._device[device] = BsrPlanDev(
                _stage_device(self.edge_stage, device),
                _stage_device(self.vertex_stage, device), *perms)
        return self._device[device]


def plan_bsr(hg, reorder: bool = True, max_bytes: int = 2_000_000_000,
             method: str = "rcm") -> BsrPlan:
    """The BSR plan (``:188-251``); ``MemoryError`` when the blocks exceed
    ``max_bytes`` (half of it a stage). ``method``: ``rcm`` (bipartite
    reverse Cuthill-McKee) or ``community`` (the label-propagation community
    order, hyperedges by their members' mean rank)."""
    from hypergef_tpu_torch.sparse.hypergraph import Hypergraph

    vperm = eperm = None
    hg_p = hg
    if reorder:
        if method == "community":
            from hypergef_tpu_torch.sparse.reorder import community_order

            vperm = community_order(hg).astype(np.int64)
            # hyperedges ordered by their members' mean rank
            vrank = _inverse(vperm)
            sums = np.zeros(hg.num_edges)
            sizes = hg.edge_sizes()
            np.add.at(sums, np.repeat(np.arange(hg.num_edges), sizes),
                      vrank[hg.ht_indices.astype(np.int64)])
            key = sums / np.maximum(sizes, 1)
            eperm = np.argsort(key, kind="stable")
        else:
            vperm, eperm = rcm_bipartite_order(hg)
        # the CSRs with vertices and hyperedges renumbered
        vinv, einv = _inverse(vperm), _inverse(eperm)
        v_new = vinv[hg.ht_indices.astype(np.int64)]
        e_new = einv[np.repeat(np.arange(hg.num_edges, dtype=np.int64), hg.edge_sizes())]
        hg_p = Hypergraph.from_coo(v_new, e_new, num_nodes=hg.num_nodes,
                                   num_edges=hg.num_edges, name=hg.name + "+" + method,
                                   dedup=False)
    e_stage = build_bsr_stage(hg_p.ht_indptr, hg_p.ht_indices, hg_p.num_edges,
                              hg_p.num_nodes, max_bytes=max_bytes // 2)
    v_stage = build_bsr_stage(hg_p.h_indptr, hg_p.h_indices, hg_p.num_nodes,
                              hg_p.num_edges, max_bytes=max_bytes // 2)
    plan = BsrPlan(edge_stage=e_stage, vertex_stage=v_stage, vperm=vperm, eperm=eperm)
    if plan.nbytes_bf16 > max_bytes:
        raise MemoryError(
            f"BSR blocks need {plan.nbytes_bf16 / 1e9:.2f} GB > budget "
            f"{max_bytes / 1e9:.2f} GB (fill {plan.fill_fraction():.4f}); "
            "use the tree backend for this graph"
        )
    return plan
