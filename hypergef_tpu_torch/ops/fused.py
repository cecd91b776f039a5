"""Fused two-stage aggregation: route dispatch.

Port of ``hypergef_tpu/ops/fused.py::hgnn_aggregate`` (``:269-375``) with
three routes; the route names mean the same thing in both packages:

* ``"xla"`` — the plain segment-sum oracle (:mod:`.refops`).
* ``"dense"`` — two plain matmuls over the int8 table, the XLA dense route
  (``fused.py:107-142``, ``:341-347``).
* ``"pallas"`` — the hand-written fused kernel (:mod:`.fused_dense`), the
  counterpart of the Pallas kernel. It never falls back to another route.

``auto``, the other routes and ``first_aggr="max"`` raise
``NotImplementedError`` until they are ported (ROADMAP.md queue 1).
"""

from __future__ import annotations

from typing import Optional

from hypergef_tpu_torch.ops import refops
from hypergef_tpu_torch.ops.fused_dense import (
    dense_dot,
    dense_table,
    hgnn_aggregate_fused_dense,
)
from hypergef_tpu_torch.sparse.hypergraph import HypergraphData

ROUTES = ("xla", "dense", "pallas")
# routes of the JAX package (hypergef_tpu/ops/fused.py:36-39) not ported yet
UNPORTED = (
    "auto", "cumsum", "ell", "tree", "bsr", "precomp", "multihot",
    "pallas_sparse", "aligned", "bitstream",
)


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
    reduce ∈ {sum, mean}."""
    b = _resolve(backend, plan)
    if first_aggr == "max":
        raise NotImplementedError(
            "max first aggregation is not ported yet (ROADMAP.md queue 1, item 6)")
    if b == "xla":
        return refops.hgnn_aggregate_ref(hgd, x, wdiag, first_aggr)
    if b == "pallas":
        return hgnn_aggregate_fused_dense(hgd, x, wdiag, first_aggr, plan)
    if first_aggr not in ("sum", "mean"):
        raise ValueError(f"unknown first_aggr {first_aggr!r}")
    dense = dense_table(plan, "dense")
    xe = dense_dot(dense.h, x, True)
    if first_aggr == "mean":
        cnt = (hgd.ht_indptr[1:] - hgd.ht_indptr[:-1]).to(xe.dtype)
        xe = xe / cnt.clamp_min(1.0)[:, None]
    xe = xe * hgd.degE
    if wdiag is not None:
        xe = xe * wdiag
    return dense_dot(dense.h, xe, False) * hgd.degV
