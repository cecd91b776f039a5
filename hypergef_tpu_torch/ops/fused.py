"""Fused two-stage aggregation: route dispatch.

Port of ``hypergef_tpu/ops/fused.py`` (``hgnn_aggregate`` ``:269-375``,
``unignn_aggregate`` ``:378-472``) with seven routes; the route names mean
the same thing in both packages:

* ``"xla"`` — the plain segment-sum oracle (:mod:`.refops`).
* ``"dense"`` — two plain matmuls over the int8 table, the XLA dense route
  (``fused.py:107-142``, ``:341-347``).
* ``"pallas"`` — the hand-written fused kernel (:mod:`.fused_dense`), the
  counterpart of the Pallas kernel. It never falls back to another route.
* ``"tree"`` — the reduction tree with every level plain (:mod:`.tree`,
  ``fused.py:316-319``).
* ``"pallas_sparse"`` — the same tree with level 0 on the hand-written
  gather kernel (:mod:`.ell_gather`, ``fused.py:334-340``).
* ``"aligned"`` — banded products for community-sorted graphs
  (:func:`~hypergef_tpu_torch.sparse.planner.plan_aligned`,
  ``fused.py:327-333``): the plain chain, or the hand-written band kernel
  (:mod:`.aligned_band`) when the plan's form is ``pallas_*``.
* ``"bitstream"`` — two products over the bit-packed incidence
  (:mod:`.bitstream`, ``fused.py:348-352``), each one launch of the
  hand-written bit-scan kernel on the card.

Max first aggregation (``fused.py:195-263``, ``:284-290``) takes its V→E
stage from ``plan.tree`` when the plan has one, else from a TreePlan passed
directly, else from the route's own plan (``aligned``, ``tree``,
``pallas_sparse``): a tree stage runs :func:`.maxops.v2e_max_tree`, an
aligned stage :func:`.aligned_max.v2e_max_aligned` (the argmax kernel in a
``pallas_*`` form). The E→V sum then runs on the route's own stages, table
or packs. Where JAX would fall back to the nnz oracle, this raises
``ValueError`` and names the plan to pass.

UniGNN aggregation (``H Hᵀ X``, degree-scaled or not) runs on the same
seven routes. ``auto`` and the other routes raise ``NotImplementedError``
until they are ported (ROADMAP.md queue 1).
"""

from __future__ import annotations

from typing import Optional

from hypergef_tpu_torch.ops import aligned_max, bitstream, maxops, refops, tree
from hypergef_tpu_torch.ops.fused_dense import (
    dense_dot,
    dense_table,
    hgnn_aggregate_fused_dense,
    unignn_aggregate_fused_dense,
)
from hypergef_tpu_torch.sparse.hypergraph import HypergraphData
from hypergef_tpu_torch.sparse.planner import AlignedStageBDev, AlignedStageDev, TreePlan

ROUTES = ("xla", "dense", "pallas", "tree", "pallas_sparse", "aligned", "bitstream")
# routes of the JAX package (hypergef_tpu/ops/fused.py:36-39) not ported yet
UNPORTED = ("auto", "cumsum", "ell", "bsr", "precomp", "multihot")
# the routes whose plan is a TreePlan
_STAGE_ROUTES = ("tree", "pallas_sparse", "aligned")


def _resolve(backend: Optional[str], plan) -> str:
    if backend in ROUTES:
        if backend != "xla" and plan is None:
            raise ValueError(f"backend {backend!r} requires a plan (pass plan=...)")
        return backend
    if backend is None or backend in UNPORTED:
        raise NotImplementedError(
            f"backend {backend!r} is not ported yet (ported: {ROUTES}; "
            "ROADMAP.md queue 1, item 3)")
    raise ValueError(f"backend must be one of {ROUTES + UNPORTED}, got {backend!r}")


def tree_plan(plan, route: str) -> TreePlan:
    """The TreePlan of ``plan`` for ``route`` (an AggregationPlan's field of
    that name, or a TreePlan passed directly; ``fused.py:87-92``)."""
    sub = getattr(plan, route, None) or plan
    if not isinstance(sub, TreePlan):
        raise ValueError(
            f"the {route} route needs a TreePlan (plan_tree, plan_pallas_sparse or "
            f"plan_aligned), got {type(sub).__name__}")
    return sub


def bit_plan(plan) -> bitstream.BitIncidence:
    """The packs of ``plan`` (an AggregationPlan's ``bitstream`` field, or a
    BitIncidence passed directly; ``fused.py:87-92``)."""
    sub = getattr(plan, "bitstream", None) or plan
    if not isinstance(sub, bitstream.BitIncidence):
        raise ValueError(
            "the bitstream route needs a BitIncidence: pass AggregationPlan(bitstream="
            f"BitIncidence.from_hypergraph(hg)), got {type(sub).__name__}")
    return sub


def _max_plan(plan, b: str) -> TreePlan:
    """The TreePlan whose edge stage computes max V→E (``fused.py:208-213``):
    ``plan.tree``, a TreePlan passed directly, or the route's own plan."""
    for sub in (getattr(plan, "tree", None), plan,
                getattr(plan, b, None) if b in _STAGE_ROUTES else None):
        if isinstance(sub, TreePlan):
            return sub
    raise ValueError(
        f"max first aggregation on the {b} route needs a stage plan that carries the "
        f"record table: pass AggregationPlan(..., tree=plan_tree(hg)) (or the route's own "
        f"TreePlan); the JAX package falls back to the nnz oracle here")


def _hgnn_aggregate_max(hgd, x, wdiag, plan, b: str):
    """Max V→E with the record table, then the route's E→V sum
    (``fused.py:195-263``)."""
    mplan = _max_plan(plan, b)
    e_stage, v_stage = mplan.device(x.device)
    if isinstance(e_stage, (AlignedStageDev, AlignedStageBDev)):
        xe = aligned_max.v2e_max_aligned(x, e_stage, hgd.h_edge, hgd.h_segids, hgd.h_indptr)
    else:
        xe = maxops.v2e_max_tree(x, e_stage, hgd.h_edge, hgd.h_segids, hgd.h_indptr)
    xe = xe * hgd.degE
    if wdiag is not None:
        xe = xe * wdiag
    if b == "dense" and getattr(plan, "dense", None) is not None:
        xv = dense_dot(plan.dense.h, xe, False)
    elif b == "bitstream" and getattr(plan, "bitstream", None) is not None:
        h_pack, ht_pack = plan.bitstream.device(x.device)
        xv = bitstream.bit_matvec(xe, h_pack, ht_pack)
    else:
        own = getattr(plan, b, None) if b in ("aligned", "pallas_sparse") else None
        if isinstance(own, TreePlan):
            fe_stage, fv_stage = own.device(x.device)
            xv = tree.tree_matvec(xe, fv_stage, fe_stage)
        else:
            xv = tree.tree_matvec(xe, v_stage, e_stage)
    return xv * hgd.degV


def hgnn_aggregate(
    hgd: HypergraphData,
    x,
    wdiag=None,
    first_aggr: str = "sum",
    plan=None,
    backend: Optional[str] = None,
):
    """Fused HGNNConv aggregation:
    ``out = diag(degV) · H · diag(Wdiag·degE) · Hᵀ · X``, first-stage
    reduce ∈ {sum, mean, max}."""
    b = _resolve(backend, plan)
    if first_aggr not in ("sum", "mean", "max"):
        raise ValueError(f"unknown first_aggr {first_aggr!r}")
    if b == "xla":
        return refops.hgnn_aggregate_ref(hgd, x, wdiag, first_aggr)
    if first_aggr == "max":
        return _hgnn_aggregate_max(hgd, x, wdiag, plan, b)
    if b == "pallas":
        return hgnn_aggregate_fused_dense(hgd, x, wdiag, first_aggr, plan)
    if b in _STAGE_ROUTES:
        return tree.hgnn_aggregate_tree(hgd, x, wdiag, first_aggr, tree_plan(plan, b))
    if b == "bitstream":
        return bitstream.hgnn_aggregate_bitstream(hgd, x, wdiag, first_aggr, bit_plan(plan))
    dense = dense_table(plan, "dense")
    xe = dense_dot(dense.h, x, True)
    if first_aggr == "mean":
        cnt = (hgd.ht_indptr[1:] - hgd.ht_indptr[:-1]).to(xe.dtype)
        xe = xe / cnt.clamp_min(1.0)[:, None]
    xe = xe * hgd.degE
    if wdiag is not None:
        xe = xe * wdiag
    return dense_dot(dense.h, xe, False) * hgd.degV


def unignn_aggregate(
    hgd: HypergraphData,
    x,
    use_deg: bool = False,
    plan=None,
    backend: Optional[str] = None,
):
    """Fused UniGNN aggregation: ``H Hᵀ X``, or ``diag(degV)·H·diag(degE)·Hᵀ·X``
    with ``use_deg`` (``fused.py:378-472``)."""
    b = _resolve(backend, plan)
    if b == "xla":
        return refops.unignn_aggregate_ref(hgd, x, use_deg)
    if b == "pallas":
        return unignn_aggregate_fused_dense(hgd, x, use_deg, plan)
    if b in _STAGE_ROUTES:
        return tree.unignn_aggregate_tree(hgd, x, use_deg, tree_plan(plan, b))
    if b == "bitstream":
        return bitstream.unignn_aggregate_bitstream(hgd, x, use_deg, bit_plan(plan))
    dense = dense_table(plan, "dense")
    xe = dense_dot(dense.h, x, True)
    if use_deg:
        xe = xe * hgd.degE
    xv = dense_dot(dense.h, xe, False)
    if use_deg:
        xv = xv * hgd.degV
    return xv
