"""Fused two-stage aggregation: route dispatch.

Port of ``hypergef_tpu/ops/fused.py`` (``hgnn_aggregate`` ``:269-375``,
``unignn_aggregate`` ``:378-472``) with all twelve routes and ``auto``; the
route names mean the same thing in both packages:

* ``"xla"`` — the plain segment-sum oracle (:mod:`.refops`).
* ``"cumsum"`` — gather + sorted segment sum over each CSR
  (:func:`.segments.incidence_gather_sum`, ``fused.py:148-161``), whose
  backward is the same op over the transposed CSR; one launch of the
  hand-written segment-sum kernel (:mod:`.segment_sum`) a stage on the card.
  The default route, as in JAX (``fused.py:35``).
* ``"precomp"`` — one product with the bf16 propagation matrix
  (:class:`~hypergef_tpu_torch.sparse.planner.DensePrecomp`,
  ``fused.py:298-311``), a library matmul as in JAX. With ``wdiag``, or a
  first aggregation other than sum, it falls through to ``dense`` (when the
  plan has the table) or ``tree``, as in JAX.
* ``"dense"`` — two plain matmuls over the int8 table, the XLA dense route
  (``fused.py:107-142``, ``:341-347``); a packed table
  (``DenseIncidence(packed=True)``) is unpacked first, as JAX's
  ``_dense_dot(packed=True)`` unpacks it.
* ``"pallas"`` — the hand-written fused kernel (:mod:`.fused_dense`), the
  counterpart of the Pallas kernel, on the int8 table or, in its packed
  form, on the nibble carrier. It never falls back to another route.
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
* ``"ell"`` — the padded ELL chunk tables of a
  :class:`~hypergef_tpu_torch.sparse.planner.TilePlan`
  (``plan_aggregation(..., with_tile=True)`` or ``plan_tiles``,
  ``fused.py:167-189``, ``:353-364``): the gather kernel's chunk sums, then
  the segment-sum kernel over each segment's chunks.
* ``"bsr"`` — 128×128 block products over a
  :class:`~hypergef_tpu_torch.sparse.bsr.BsrPlan` (:mod:`.bsr_ops`,
  ``fused.py:312-314``), library bf16 products with an f32 result.
* ``"multihot"`` — the tiled stages of
  :func:`~hypergef_tpu_torch.sparse.planner.plan_multihot` (:mod:`.tree`,
  ``fused.py:320-326``): one multihot bf16 product a source tile.

Max first aggregation (``fused.py:195-263``, ``:284-290``) takes its V→E
stage from ``plan.tree`` when the plan has one, else from a TreePlan passed
directly, else from the route's own plan (``aligned``, ``tree``,
``pallas_sparse``): a tree stage runs :func:`.maxops.v2e_max_tree`, an
aligned stage :func:`.aligned_max.v2e_max_aligned` (the argmax kernel in a
``pallas_*`` form). The E→V sum then runs on the route's own stages, table
or packs (``aligned``, ``pallas_sparse`` and ``multihot`` ride their own
plan's vertex stage, ``fused.py:244-256``). Where JAX would fall back to the
nnz oracle (no plan, a tiled plan's stages, which carry no argmax), this
raises ``ValueError`` and names the plan to pass.

UniGNN aggregation (``H Hᵀ X``, degree-scaled or not) runs on the same
routes; ``precomp`` serves it only degree-scaled (``fused.py:397-406``).

``backend=None`` takes the process-global default (``cumsum``, settable with
:func:`set_default_backend`); ``"auto"`` takes the plan's
``preferred_backend`` (:func:`~hypergef_tpu_torch.sparse.planner.plan_aggregation`),
``cumsum`` without a plan.
"""

from __future__ import annotations

import warnings
from typing import Optional

import torch

from hypergef_tpu_torch.ops import aligned_max, bitstream, bsr_ops, maxops, refops, tree
from hypergef_tpu_torch.ops.fused_dense import (
    dense_dot,
    dense_table,
    hgnn_aggregate_fused_dense,
    unignn_aggregate_fused_dense,
)
from hypergef_tpu_torch.ops.segments import divide_by_segment_sizes, incidence_gather_sum
from hypergef_tpu_torch.sparse.hypergraph import HypergraphData
from hypergef_tpu_torch.sparse.bsr import BsrPlan
from hypergef_tpu_torch.sparse.planner import (
    AlignedStageBDev, AlignedStageDev, DensePrecomp, TiledStage, TiledStageDev, TilePlan,
    TreePlan,
)

ROUTES = ("xla", "cumsum", "ell", "tree", "dense", "bsr", "precomp", "pallas", "multihot",
          "pallas_sparse", "aligned", "bitstream")
# the routes whose plan is a TreePlan
_STAGE_ROUTES = ("tree", "pallas_sparse", "aligned", "multihot")
# the routes whose E→V stage under max first aggregation is their own plan's
_OWN_E2V = ("aligned", "pallas_sparse", "multihot")
# what each route's plan is built by, named where one is missing
_PLAN_OF = {"multihot": "plan_multihot(hg)", "ell": "plan_tiles(hg)",
            "bsr": "sparse.bsr.plan_bsr(hg)", "bitstream": "BitIncidence.from_hypergraph(hg)"}

_DEFAULT_BACKEND = "cumsum"


def set_default_backend(name: str) -> None:
    """The route ``backend=None`` takes, process-wide (``fused.py:42-46``)."""
    global _DEFAULT_BACKEND
    if name not in ROUTES + ("auto",):
        raise ValueError(f"backend must be one of {ROUTES + ('auto',)}, got {name!r}")
    _DEFAULT_BACKEND = name


def get_default_backend() -> str:
    return _DEFAULT_BACKEND


# nnz above which cumsum goes to the tree when the plan has one, as in JAX
# (fused.py:53-84). JAX's cumsum differences a running prefix, whose error
# grows with nnz; the port sums each segment directly and loses nothing
# there, but keeps the guard so that both packages run the same route.
CUMSUM_NNZ_GUARD = 1 << 20
_warned_cumsum = False


def resolve_backend(backend: Optional[str], plan, nnz: Optional[int] = None) -> str:
    """The route a call takes (``fused.py:61-84``): None → the default,
    ``auto`` → the plan's ``preferred_backend`` (``cumsum`` without a
    plan), and ``cumsum`` above the nnz guard → ``tree`` when the plan has
    one (a warning, once, when it has none)."""
    global _warned_cumsum
    b = backend or _DEFAULT_BACKEND
    if b == "auto":
        b = getattr(plan, "preferred_backend", None) or "cumsum"
    if b == "cumsum" and nnz is not None and nnz > CUMSUM_NNZ_GUARD:
        if getattr(plan, "tree", None) is not None:
            b = "tree"
        elif not _warned_cumsum:
            warnings.warn(
                f"cumsum at nnz={nnz} > {CUMSUM_NNZ_GUARD}: the JAX package routes this "
                "to the tree when a plan has one; pass a plan to run the same route",
                stacklevel=3)
            _warned_cumsum = True
    if b not in ROUTES:
        raise ValueError(f"backend must be one of {ROUTES + ('auto',)}, got {b!r}")
    if b not in ("xla", "cumsum") and plan is None:
        raise ValueError(f"backend {b!r} requires a plan (pass plan=...)")
    return b


def tree_plan(plan, route: str) -> TreePlan:
    """The TreePlan of ``plan`` for ``route`` (an AggregationPlan's field of
    that name, or a TreePlan passed directly; ``fused.py:87-92``)."""
    sub = getattr(plan, route, None) or plan
    if not isinstance(sub, TreePlan):
        builders = _PLAN_OF.get(route, "plan_tree, plan_pallas_sparse or plan_aligned")
        raise ValueError(f"the {route} route needs a TreePlan ({builders}), "
                         f"got {type(sub).__name__}")
    return sub


def _sub_plan(plan, field: str, cls, route: str):
    """An AggregationPlan's ``field``, or a plan of type ``cls`` passed
    directly (``fused.py:87-92``): the packs, ELL tables or block plan of
    the ``bitstream``, ``ell`` and ``bsr`` routes."""
    sub = getattr(plan, field, None) or plan
    if not isinstance(sub, cls):
        raise ValueError(f"the {route} route needs a {cls.__name__}: pass "
                         f"AggregationPlan({field}={_PLAN_OF[route]}), got {type(sub).__name__}")
    return sub


def _precomp_table(plan) -> Optional[DensePrecomp]:
    """An AggregationPlan's ``precomp`` field, or a DensePrecomp passed
    directly (``fused.py:303``)."""
    pre = getattr(plan, "precomp", None) or plan
    return pre if isinstance(pre, DensePrecomp) else None


def _fallback(plan) -> str:
    """Where ``precomp`` falls through (``fused.py:310``)."""
    return "dense" if getattr(plan, "dense", None) is not None else "tree"


def _mm_f32(a, b):
    """``a·b`` of two bf16 operands with an f32 result that is not rounded
    to bf16: on the card ``torch.mm`` with ``out_dtype=torch.float32`` (bf16
    products, f32 accumulation and output); on the CPU, which has no such
    kernel, an f32 product of the bf16-valued operands (exact products, f32
    sums). ``torch.matmul`` of two bf16 tensors would round the output."""
    if a.device.type == "cuda":
        return torch.mm(a, b, out_dtype=torch.float32)
    return a.float() @ b.float()


class _PrecompProduct(torch.autograd.Function):
    @staticmethod
    def forward(ctx, a, xb):
        ctx.save_for_backward(a)
        return _mm_f32(a, xb)

    @staticmethod
    def backward(ctx, g):
        (a,) = ctx.saved_tensors
        # the gradient of the bf16 operand is bf16; autograd's cast back to
        # f32 is the transpose of x.astype(bf16), as in JAX
        return None, _mm_f32(a.t(), g.to(torch.bfloat16)).to(torch.bfloat16)


def precomp_matvec(a: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """``A · bf16(x)`` with an f32 result (JAX's ``dot_general(a,
    x.astype(bf16), preferred_element_type=f32)``, ``fused.py:305-308``).

    The gradient is ``bf16(Aᵀ · bf16(ȳ))``: JAX rounds at the same place
    after the product (the transpose of the cast) but multiplies the f32
    cotangent, so the two agree at the bf16 bar."""
    return _PrecompProduct.apply(a, x.to(torch.bfloat16))


def _cumsum_v2e(hgd: HypergraphData, x, aggr: str):
    """V→E of the cumsum route (``fused.py:148-155``)."""
    xe = incidence_gather_sum(x, hgd.v2e, hgd.e2v)
    return divide_by_segment_sizes(xe, hgd.ht_indptr) if aggr == "mean" else xe


def _cumsum_e2v(hgd: HypergraphData, xe):
    """E→V of the cumsum route (``fused.py:158-161``)."""
    return incidence_gather_sum(xe, hgd.e2v, hgd.v2e)


def _max_plan(plan, b: str) -> TreePlan:
    """The TreePlan whose edge stage computes max V→E (``fused.py:208-234``):
    ``plan.tree``, a TreePlan passed directly, or the route's own plan; a
    tiled edge stage carries no argmax."""
    for sub in (getattr(plan, "tree", None), plan,
                getattr(plan, b, None) if b in _STAGE_ROUTES else None):
        if isinstance(sub, TreePlan) and not isinstance(sub.edge_stage, TiledStage):
            return sub
    raise ValueError(
        f"max first aggregation on the {b} route needs a stage plan that carries the "
        f"record table: pass AggregationPlan(..., tree=plan_tree(hg)) (or the route's own "
        f"untiled TreePlan); the JAX package falls back to the nnz oracle here")


def _hgnn_aggregate_max(hgd, x, wdiag, plan, b: str):
    """Max V→E with the record table, then the route's E→V sum
    (``fused.py:195-263``)."""
    mplan = _max_plan(plan, b)
    e_stage, v_stage = mplan.device(x.device)
    if isinstance(e_stage, (AlignedStageDev, AlignedStageBDev)):
        xe = aligned_max.v2e_max_aligned(x, e_stage, hgd.record)
    else:
        xe = maxops.v2e_max_tree(x, e_stage, hgd.record)
    xe = xe * hgd.degE
    if wdiag is not None:
        xe = xe * wdiag
    if b == "dense" and getattr(plan, "dense", None) is not None:
        xv = dense_dot(plan.dense.unpacked(), xe, False)
    elif b == "bitstream" and getattr(plan, "bitstream", None) is not None:
        h_pack, ht_pack = plan.bitstream.device(x.device)
        xv = bitstream.bit_matvec(xe, h_pack, ht_pack)
    elif b in _OWN_E2V and isinstance(getattr(plan, b, None), TreePlan):
        # the E→V stage is a plain sum: it rides the route's own stages
        fe_stage, fv_stage = getattr(plan, b).device(x.device)
        xv = tree.tree_matvec(xe, fv_stage, fe_stage)
    elif b == "cumsum" or isinstance(v_stage, TiledStageDev):
        xv = _cumsum_e2v(hgd, xe)
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
    b = resolve_backend(backend, plan, nnz=int(hgd.h_edge.shape[0]))
    if first_aggr not in ("sum", "mean", "max"):
        raise ValueError(f"unknown first_aggr {first_aggr!r}")
    if b == "xla":
        return refops.hgnn_aggregate_ref(hgd, x, wdiag, first_aggr)
    if first_aggr == "max":
        return _hgnn_aggregate_max(hgd, x, wdiag, plan, b)
    if b == "cumsum":
        xe = _cumsum_v2e(hgd, x, first_aggr) * hgd.degE
        if wdiag is not None:
            xe = xe * wdiag
        return _cumsum_e2v(hgd, xe) * hgd.degV
    if b == "precomp":
        pre = _precomp_table(plan)
        if wdiag is None and first_aggr == "sum" and pre is not None:
            return precomp_matvec(pre.device(x.device), x)
        return hgnn_aggregate(hgd, x, wdiag, first_aggr, plan, _fallback(plan))
    if b == "pallas":
        return hgnn_aggregate_fused_dense(hgd, x, wdiag, first_aggr, plan)
    if b in _STAGE_ROUTES:
        return tree.hgnn_aggregate_tree(hgd, x, wdiag, first_aggr, tree_plan(plan, b))
    if b == "ell":
        return tree.hgnn_aggregate_tree(hgd, x, wdiag, first_aggr,
                                        _sub_plan(plan, "tile", TilePlan, b))
    if b == "bsr":
        return bsr_ops.hgnn_aggregate_bsr(hgd, x, wdiag, first_aggr,
                                          _sub_plan(plan, "bsr", BsrPlan, b))
    if b == "bitstream":
        return bitstream.hgnn_aggregate_bitstream(
            hgd, x, wdiag, first_aggr, _sub_plan(plan, "bitstream", bitstream.BitIncidence, b))
    h = dense_table(plan, "dense").unpacked()
    xe = dense_dot(h, x, True)
    if first_aggr == "mean":
        cnt = (hgd.ht_indptr[1:] - hgd.ht_indptr[:-1]).to(xe.dtype)
        xe = xe / cnt.clamp_min(1.0)[:, None]
    xe = xe * hgd.degE
    if wdiag is not None:
        xe = xe * wdiag
    return dense_dot(h, xe, False) * hgd.degV


def unignn_aggregate(
    hgd: HypergraphData,
    x,
    use_deg: bool = False,
    plan=None,
    backend: Optional[str] = None,
):
    """Fused UniGNN aggregation: ``H Hᵀ X``, or ``diag(degV)·H·diag(degE)·Hᵀ·X``
    with ``use_deg`` (``fused.py:378-472``)."""
    b = resolve_backend(backend, plan, nnz=int(hgd.h_edge.shape[0]))
    if b == "xla":
        return refops.unignn_aggregate_ref(hgd, x, use_deg)
    if b == "cumsum":
        xe = _cumsum_v2e(hgd, x, "sum")
        if use_deg:
            xe = xe * hgd.degE
        xv = _cumsum_e2v(hgd, xe)
        return xv * hgd.degV if use_deg else xv
    if b == "precomp":
        pre = _precomp_table(plan)
        if use_deg and pre is not None:
            # the degree-scaled UniGNN propagation is HGNN's A
            return precomp_matvec(pre.device(x.device), x)
        return unignn_aggregate(hgd, x, use_deg, plan, _fallback(plan))
    if b == "pallas":
        return unignn_aggregate_fused_dense(hgd, x, use_deg, plan)
    if b in _STAGE_ROUTES:
        return tree.unignn_aggregate_tree(hgd, x, use_deg, tree_plan(plan, b))
    if b == "ell":
        return tree.unignn_aggregate_tree(hgd, x, use_deg, _sub_plan(plan, "tile", TilePlan, b))
    if b == "bsr":
        return bsr_ops.unignn_aggregate_bsr(hgd, x, use_deg, _sub_plan(plan, "bsr", BsrPlan, b))
    if b == "bitstream":
        return bitstream.unignn_aggregate_bitstream(
            hgd, x, use_deg, _sub_plan(plan, "bitstream", bitstream.BitIncidence, b))
    h = dense_table(plan, "dense").unpacked()
    xe = dense_dot(h, x, True)
    if use_deg:
        xe = xe * hgd.degE
    xv = dense_dot(h, xe, False)
    if use_deg:
        xv = xv * hgd.degV
    return xv
