"""Edge-partitioned fused aggregation, one rank a shard.

Port of ``hypergef_tpu/parallel/dist_aggr.py`` (``:1-149``). Each rank runs
JAX's ``shard_map`` body for its own shard:

    xe_local   = local V→E tree over X          (X replicated on every rank)
    xe_local  *= degE_local (* Wdiag_local)     (local: the cut is edge-contiguous)
    part_local = local E→V tree → [N, F] partial
    out        = Σ_ranks part_local * degV      (``jax.lax.psum``, ``:94``, ``:133``)

The trees run plain levels, as JAX's do (``:38``). Where JAX differentiates
through ``shard_map`` and ``psum``, the port states the transposes
(:mod:`.comm`): X enters through :func:`~.comm.from_replicated` (identity
forward, ``all_reduce`` backward) and the partials leave through
:func:`~.comm.sum_to_replicated` (``all_reduce`` forward, identity
backward), one ``[N, F]`` reduction each way. The local stages go through
``ops.tree.tree_matvec``, whose backward is the other stage of the pair (the
E→V stage is the V→E stage's adjoint): no scatter. Max runs the port's
``maxops.v2e_max_tree`` over the shard's edges (exact: the cut is
edge-contiguous and X is whole on every rank) with the record-routed sum
backward over the shard's vertex-major local CSR (``partition.py:237-249``),
the ``record_routed_dx`` kernel on the card.

``feature_sharded=True`` is JAX's ``P(None, "f")`` on x and the output
(``:71-72``): on a grid with a feature axis (``make_mesh(n_edge,
n_feature)``) each rank aggregates its ``F / n_f`` columns through the same
trees (every index op is row-wise, so column blocks are independent), the
partials sum over the edge group only, as JAX's ``psum`` over ``"e"``, and
the blocks are gathered back (:func:`~.comm.slice_columns`,
:func:`~.comm.gather_columns`). Max runs the record-routed sum over the
rank's column block. On a grid without a feature axis it changes nothing.
"""

from __future__ import annotations

from typing import Optional

import torch

from hypergef_tpu_torch.ops.maxops import v2e_max_tree
from hypergef_tpu_torch.ops.tree import tree_matvec
from hypergef_tpu_torch.parallel.comm import (
    from_replicated, gather_columns, slice_columns, sum_to_replicated,
)
from hypergef_tpu_torch.parallel.mesh import Mesh, make_mesh


def _local(plan, mesh: Optional[Mesh], x):
    mesh = mesh or make_mesh()
    if mesh.size != plan.n_shards:
        raise ValueError(f"plan of {plan.n_shards} shards on a mesh of {mesh.size} ranks")
    return mesh, plan.local(mesh.rank, x.device)


def columns_in(x: torch.Tensor, mesh: Mesh, feature_sharded: bool) -> torch.Tensor:
    """This rank's column block of a replicated x when ``feature_sharded``
    and the grid has a feature axis; x otherwise."""
    if feature_sharded and mesh.feature is not None:
        return slice_columns(x, mesh.feature.group)
    return x


def columns_out(y: torch.Tensor, mesh: Mesh, feature_sharded: bool) -> torch.Tensor:
    """The replicated whole of the column blocks :func:`columns_in` cut."""
    if feature_sharded and mesh.feature is not None:
        return gather_columns(y, mesh.feature.group)
    return y


def sharded_hgnn_aggregate(plan, x: torch.Tensor, wdiag_local: Optional[torch.Tensor] = None,
                           first_aggr: str = "sum", degV: Optional[torch.Tensor] = None,
                           mesh: Optional[Mesh] = None,
                           feature_sharded: bool = False) -> torch.Tensor:
    """HGNN aggregation over the edge partition (``:46-117``): ``x`` [N, F],
    the same on every rank; ``wdiag_local`` this rank's [e_pad, 1] slice of
    ``plan.shard_edge_vector(wdiag)``. Returns [N, F], the same on every
    rank."""
    if first_aggr not in ("sum", "mean", "max"):
        raise ValueError("sharded path supports first_aggr in {sum, mean, max}")
    mesh, loc = _local(plan, mesh, x)
    x = from_replicated(columns_in(x, mesh, feature_sharded), mesh.group)
    if first_aggr == "max":
        xe = v2e_max_tree(x, loc.e_stage, loc.record)
    else:
        xe = tree_matvec(x, loc.e_stage, loc.v_stage)
        if first_aggr == "mean":
            xe = xe / loc.e_counts.clamp_min(1.0)[:, None]
    xe = xe * loc.degE
    if wdiag_local is not None:
        xe = xe * wdiag_local
    part = tree_matvec(xe, loc.v_stage, loc.e_stage)
    out = sum_to_replicated(part, mesh.group)
    return columns_out(out * degV if degV is not None else out, mesh, feature_sharded)


def sharded_unignn_aggregate(plan, x: torch.Tensor, use_deg: bool = False,
                             degV: Optional[torch.Tensor] = None,
                             mesh: Optional[Mesh] = None,
                             feature_sharded: bool = False) -> torch.Tensor:
    """UniGNN aggregation over the edge partition (``:120-149``): ``H Hᵀ X``,
    or ``degV·H·degE·Hᵀ·X`` with ``use_deg``."""
    mesh, loc = _local(plan, mesh, x)
    x = from_replicated(columns_in(x, mesh, feature_sharded), mesh.group)
    xe = tree_matvec(x, loc.e_stage, loc.v_stage)
    if use_deg:
        xe = xe * loc.degE
    part = tree_matvec(xe, loc.v_stage, loc.e_stage)
    out = sum_to_replicated(part, mesh.group)
    return columns_out(out * degV if use_deg and degV is not None else out, mesh,
                       feature_sharded)
