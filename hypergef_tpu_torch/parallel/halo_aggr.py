"""Fully-sharded halo aggregation: X vertex-sharded, one owned block a rank.

Port of ``hypergef_tpu/parallel/halo_aggr.py`` (``:1-288``). Each rank runs
JAX's ``shard_map`` body on its owned block ``x_blk`` [n_own, F]:

    1. halo in:  owners send the rows each shard's boundary edges touch
                 (one ``all_to_all``)
    2. local:    interior V→E on the owned block (needs no exchange),
                 boundary V→E on the received rows, assembled per local
                 edge → scale → E→V over the touched rows
    3. return:   partial rows go back to their owners (one ``all_to_all``)
    4. combine:  the owner's tree sums the incoming partials → ⊙ degV

Steps 2 and 4 are functions of their own (:func:`shard_compute`,
:func:`owner_combine`), which the serialized single-device form
(:mod:`.serial_halo`) calls with a host permutation in place of each
``all_to_all``.

The interior runs as a tree, or as the aligned form (``local_form=
"aligned"``): ``ops.tree.tree_matvec`` over the rank's uniform aligned
stages for sum (the band kernel on the card, forward and backward) and
``ops.aligned_max.aligned_max_matvec`` for max (the masked argmax kernel,
its backward the arg-sum kernel). Tree-form max runs
``maxops.v2e_max_tree`` with the record-routed sum backward.

Every take and every plain tree stage is a Function of :mod:`.exact`
whose backward is a fixed-order segment sum (the segment-sum kernel on the
card), where JAX's autodiff would scatter-add; the ``all_to_all`` is its
own transpose (:mod:`.comm`). Max ties: JAX's tree-form max splits a tie's
cotangent evenly among the tied members (``ops/tree.py:226-239``), the
port routes it to the first winner, as every max route of the port does.

The training steps (:func:`make_halo_train_step` and the UniGIN/UniGCNII
ones) keep everything in the owner layout: the loss is a masked sum over
owned rows, so the loss sum, the mask count and the replicated weights'
gradients are summed over the ranks.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from hypergef_tpu_torch.ops.aligned_max import aligned_max_matvec
from hypergef_tpu_torch.ops.maxops import v2e_max_tree
from hypergef_tpu_torch.ops.tree import tree_matvec
from hypergef_tpu_torch.parallel.comm import all_reduce_, all_reduce_grads, all_to_all
from hypergef_tpu_torch.parallel.dist_model import make_forward
from hypergef_tpu_torch.parallel.exact import apply_stage, take
from hypergef_tpu_torch.parallel.mesh import Mesh, make_mesh
from hypergef_tpu_torch.train.trainer import init_adam_state, make_optimizer


def shard_compute(plan, loc, x_blk: torch.Tensor, halo_in: torch.Tensor,
                  first_aggr: str = "sum", use_deg: bool = True,
                  wdiag_local: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Step 2, one shard's work between the two exchanges: its owned block
    ``x_blk`` [n_own, F] and the received halo rows ``halo_in`` [D,
    b_cap_h, F] in, its partial rows for each owner out, [D, b_cap, F]."""
    d_, f = plan.n_shards, x_blk.shape[1]
    # 2a. interior V→E on the owned block
    if plan.local_form == "aligned":
        if first_aggr == "max":
            xe_int = aligned_max_matvec(x_blk, loc.int_fwd, loc.int_bwd)
        else:
            xe_int = tree_matvec(x_blk, loc.int_fwd, loc.int_bwd)
    elif first_aggr == "max":
        xe_int = v2e_max_tree(x_blk, loc.int_tree.stage, loc.int_record)
    else:
        xe_int = apply_stage(x_blk, loc.int_tree)
    # 2b. boundary V→E over the received rows
    x_t = take(halo_in.reshape(d_ * plan.b_cap_h, f), loc.halo_take)
    if first_aggr == "max":
        xe_bnd = v2e_max_tree(x_t, loc.bnd.stage, loc.bnd_record)
    else:
        xe_bnd = apply_stage(x_t, loc.bnd)
    # 2c. per-local-edge rows, scaled, then E→V over the touched rows
    xe_cat = torch.cat([xe_int, xe_bnd, xe_int.new_zeros((1, f))], dim=0)
    xe = take(xe_cat, loc.asm)
    if first_aggr == "mean":
        xe = xe / loc.e_counts.clamp_min(1.0)[:, None]
    if use_deg:
        xe = xe * loc.degE
    if wdiag_local is not None:
        xe = xe * wdiag_local
    part = apply_stage(xe, loc.v)
    return (take(part, loc.send) * loc.send_mask).reshape(d_, plan.b_cap, f)


def owner_combine(plan, comb, ret_in: torch.Tensor, use_deg: bool = True) -> torch.Tensor:
    """Step 4: the owner's tree over the partial rows it received, [D,
    b_cap, F] → [n_own, F], ⊙ degV. ``comb`` is the shard's
    :class:`~.halo.LocalCombine` (or its :class:`~.halo.LocalHalo`)."""
    out = apply_stage(ret_in.reshape(plan.n_shards * plan.b_cap, ret_in.shape[-1]), comb.own)
    return out * comb.degV_own if use_deg else out


def halo_hgnn_aggregate(plan, x_blk: torch.Tensor, wdiag_local: Optional[torch.Tensor] = None,
                        first_aggr: str = "sum", use_deg: bool = True,
                        mesh: Optional[Mesh] = None) -> torch.Tensor:
    """This rank's owned block ``x_blk`` [n_own, F] in, its block of the
    aggregated output out (``:36-160``): the owned rows each shard's
    boundary edges touch, ``all_to_all``, :func:`shard_compute`,
    ``all_to_all``, :func:`owner_combine`."""
    if first_aggr not in ("sum", "mean", "max"):
        raise ValueError("halo path supports first_aggr in {sum, mean, max}")
    mesh = mesh or make_mesh()
    if mesh.size != plan.n_shards:
        raise ValueError(f"plan of {plan.n_shards} shards on a mesh of {mesh.size} ranks")
    if x_blk.shape[0] != plan.n_own:
        raise ValueError(f"x_blk must be this rank's [{plan.n_own}, F] block, got "
                         f"{tuple(x_blk.shape)}")
    loc = plan.local(mesh.rank, x_blk.device)
    halo_out = take(x_blk, loc.halo_send).reshape(plan.n_shards, plan.b_cap_h, x_blk.shape[1])
    halo_in = all_to_all(halo_out, mesh.group)
    ret_out = shard_compute(plan, loc, x_blk, halo_in, first_aggr, use_deg, wdiag_local)
    return owner_combine(plan, loc, all_to_all(ret_out, mesh.group), use_deg)


def halo_unignn_aggregate(plan, x_blk: torch.Tensor, use_deg: bool = False,
                          mesh: Optional[Mesh] = None) -> torch.Tensor:
    """UniGNN on the halo program: ``H Hᵀ X``, or ``degV·H·degE·Hᵀ·X`` with
    ``use_deg`` (``:180-188``)."""
    return halo_hgnn_aggregate(plan, x_blk, None, "sum", use_deg=use_deg, mesh=mesh)


def shard_vertex_features(plan, x) -> np.ndarray:
    """[N, F] → [D·n_own, F] owner-block layout, zero-padded (``:163-171``)."""
    x = np.asarray(x)
    out = np.zeros((plan.n_shards * plan.n_own, x.shape[1]), dtype=x.dtype)
    out[: x.shape[0]] = x
    return out


def unshard_vertex_features(plan, x_own) -> np.ndarray:
    """[D·n_own, F] owner-block layout → [N, F] (``:174-178``)."""
    return np.asarray(x_own)[: plan.num_nodes]


def own_block(plan, x_own, rank: int):
    """Rank ``rank``'s [n_own, F] block of the owner layout."""
    return x_own[rank * plan.n_own:(rank + 1) * plan.n_own]


def gather_blocks(x_blk: torch.Tensor, mesh: Optional[Mesh] = None) -> torch.Tensor:
    """Every rank's block, in rank order: [D·n_own, F] on every rank (no
    autograd)."""
    import torch.distributed as dist

    mesh = mesh or make_mesh()
    parts = [torch.empty_like(x_blk) for _ in range(mesh.size)]
    dist.all_gather(parts, x_blk.contiguous(), group=mesh.group)
    return torch.cat(parts, dim=0)


class HaloStep:
    """A fully-sharded training step (``make_halo_train_step``, ``:191-226``;
    the UniGIN and UniGCNII steps, ``:229-288``): the weights (replicated),
    Adam, and the forward over this rank's owned block. ``__call__(x_blk,
    y_blk, mask_blk)`` steps once and returns the global loss (before the
    update): ``-Σ_ranks Σ picked·mask / max(Σ_ranks Σ mask, 1)``."""

    def __init__(self, model: str, plan, params: Dict[str, torch.Tensor], lr: float = 0.01,
                 wd: float = 5e-4, first_aggr: str = "sum", nclass: Optional[int] = None,
                 mesh: Optional[Mesh] = None):
        self.mesh = mesh or make_mesh()
        dev = self.mesh.device
        self.params = {k: torch.as_tensor(v, dtype=torch.float32).to(dev).clone()
                       .requires_grad_(True) for k, v in params.items()}
        mesh = self.mesh
        self.forward = make_forward(
            model, lambda h, aggr, _dv: halo_hgnn_aggregate(plan, h, None, aggr, mesh=mesh),
            lambda h, use_deg, _dv: halo_hgnn_aggregate(plan, h, None, "sum", use_deg=use_deg,
                                                         mesh=mesh),
            None, first_aggr, nclass)
        self.optimizer = make_optimizer(list(self.params.values()), lr, wd,
                                        capturable=dev.type == "cuda")
        init_adam_state(self.optimizer)

    def loss_terms(self, x_blk, y_blk, mask_blk):
        """(this rank's loss share, the global loss): the share's gradient
        summed over the ranks is the global loss's gradient."""
        logp = self.forward(self.params, x_blk)
        picked = logp.gather(1, y_blk[:, None])[:, 0]
        count = all_reduce_(mask_blk.sum().detach().clone(), self.mesh.group).clamp_min(1.0)
        share = -(picked * mask_blk).sum() / count
        return share, all_reduce_(share.detach().clone(), self.mesh.group)

    def __call__(self, x_blk, y_blk, mask_blk) -> torch.Tensor:
        self.optimizer.zero_grad(set_to_none=True)
        share, loss = self.loss_terms(x_blk, y_blk, mask_blk)
        share.backward()
        all_reduce_grads(self.params.values(), self.mesh.group)
        self.optimizer.step()
        return loss


def make_halo_train_step(plan, params, lr: float = 0.01, wd: float = 5e-4,
                         first_aggr: str = "sum", nclass: Optional[int] = None,
                         mesh: Optional[Mesh] = None) -> HaloStep:
    """The fully-sharded 2-layer HGNN step (``:191-226``)."""
    return HaloStep("HGNN", plan, params, lr, wd, first_aggr, nclass, mesh)


def make_halo_unigin_train_step(plan, params, lr: float = 0.01, wd: float = 5e-4,
                                nclass: Optional[int] = None,
                                mesh: Optional[Mesh] = None) -> HaloStep:
    """The fully-sharded 2-layer UniGIN step (``:229-247``)."""
    return HaloStep("UniGIN", plan, params, lr, wd, "sum", nclass, mesh)


def make_halo_unigcnii_train_step(plan, params, lr: float = 0.01, wd: float = 5e-4,
                                  nclass: Optional[int] = None,
                                  mesh: Optional[Mesh] = None) -> HaloStep:
    """The fully-sharded UniGCNII step (``:250-288``)."""
    return HaloStep("UniGCNII", plan, params, lr, wd, "sum", nclass, mesh)
