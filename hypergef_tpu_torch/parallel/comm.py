"""The collectives of the distributed programs, as autograd Functions.

JAX's ``shard_map`` bodies call ``jax.lax.psum`` and ``jax.lax.all_to_all``
and differentiate through them; the port states each collective's
transpose itself, for the way the programs use it:

* :func:`sum_to_replicated`: ``all_reduce`` forward, identity backward. The
  output side of an edge-partitioned aggregation (``dist_aggr.py:94``,
  ``:133``; ``dense_shard.py:205``): each rank holds a partial, the sum is
  replicated, and every rank computes the whole loss from it, so the
  cotangent arriving at the sum is already the replicated one.
* :func:`from_replicated`: identity forward, ``all_reduce`` backward. The
  input side of the same aggregation: X is replicated, each rank's local
  stages see all of it, and the true cotangent of X is the sum of the
  ranks' partial cotangents. Together the two make one ``[N, F]``
  reduction each way a layer, and never D times the gradient.
* :func:`all_to_all`: ``[D, b, F]`` block i to rank i, its own transpose
  (``halo_aggr.py:13-14``, ``:70``, ``:136``).
* :func:`slice_columns` and :func:`gather_columns`: the feature axis, where
  JAX's ``shard_map`` takes ``P(None, "f")`` (``dist_aggr.py:71-72``,
  ``dense_shard.py:216``): a replicated ``[N, F]`` in, this rank's ``F /
  n_f`` columns out, and back. The pair is conjugate: every rank of the
  grid computes the same loss from the same replicated weights, so the
  gradient of the gathered columns is this rank's columns of the
  replicated cotangent (never summed over the group, which would give
  ``n_f`` times it), and the gradient of a slice is gathered over the
  group (otherwise each rank's weight gradient would hold only its own
  columns).

:func:`all_reduce_` and :func:`all_reduce_grads` reduce tensors outside
autograd (a loss sum, a mask count, replicated weights' gradients) in a
fixed order. gloo takes CUDA tensors for these collectives (checked on the
card by ``chip_smoke.py`` phase 30); the calls are the same for every
backend.

Under a CUDA-graph recording (a recorded ``DistTrainer`` or
``DPMinibatchTrainer`` step) an nccl collective is recorded as the card's
work and replayed with the step; no collective here reads the device from
the host. A gloo collective on a CUDA tensor copies it through the host,
which a graph cannot hold: it raises
:class:`~hypergef_tpu_torch.utils.graphs.CaptureError` instead.
:data:`sent_bytes` counts where :func:`all_to_all` is called: each eager
call and each recording, not a replay (as the kernels' launch counters).
"""

from __future__ import annotations

from typing import Iterable

import torch
import torch.distributed as dist

from hypergef_tpu_torch.utils.graphs import refuse_capture

# bytes moved by all_to_all calls since the last reset, this rank's send side
# (the phase's exchange bytes a layer); a replay of a recorded step counts
# nothing
sent_bytes = 0
# called as ``a2a_observer(x, out)`` after each all_to_all while a caller
# watches the exchanges (``utils/introspect.py``'s taint walk marks ``out``
# as the collective's); None otherwise
a2a_observer = None


def _recordable(group) -> None:
    """Raise ``CaptureError`` for a gloo collective under a recording."""
    if dist.get_backend(group) == "gloo":
        refuse_capture("a gloo collective (it copies CUDA tensors through the host)",
                       "record the step on an nccl rank, or run it eagerly")


def all_reduce_(t: torch.Tensor, group=None) -> torch.Tensor:
    """Sum ``t`` over the group in place (no autograd) and return it."""
    _recordable(group)
    dist.all_reduce(t, op=dist.ReduceOp.SUM, group=group)
    return t


def all_reduce_grads(params: Iterable[torch.Tensor], group=None) -> None:
    """Sum each parameter's gradient over the group, one call a parameter,
    in the order given (the same on every rank). A parameter without a
    gradient is skipped (Adam skips it too); every rank runs the same graph,
    so every rank skips the same ones."""
    _recordable(group)
    for p in params:
        if p.grad is not None:
            dist.all_reduce(p.grad, op=dist.ReduceOp.SUM, group=group)


class _SumToReplicated(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        out = x.contiguous().clone()
        return all_reduce_(out, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _FromReplicated(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce_(g.contiguous().clone(), ctx.group), None


def _a2a(x: torch.Tensor, group) -> torch.Tensor:
    global sent_bytes
    _recordable(group)
    x = x.contiguous()
    out = torch.empty_like(x)
    dist.all_to_all_single(out, x, group=group)
    sent_bytes += x.numel() * x.element_size()
    if a2a_observer is not None:
        a2a_observer(x, out)
    return out


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _a2a(x, group)

    @staticmethod
    def backward(ctx, g):
        return _a2a(g, ctx.group), None


def _columns(x: torch.Tensor, group) -> slice:
    n, r = dist.get_world_size(group), dist.get_rank(group)
    if x.dim() != 2 or x.shape[1] % n:
        raise ValueError(f"the feature axis of {n} ranks splits the columns of a 2-D tensor "
                         f"evenly; got {tuple(x.shape)}")
    w = x.shape[1] // n
    return slice(r * w, (r + 1) * w)


def _all_gather_columns(x: torch.Tensor, group) -> torch.Tensor:
    _recordable(group)
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, x, group=group)
    return torch.cat(parts, dim=1)


class _SliceColumns(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x[:, _columns(x, group)].contiguous()

    @staticmethod
    def backward(ctx, g):
        return _all_gather_columns(g, ctx.group), None


class _GatherColumns(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _all_gather_columns(x, group)

    @staticmethod
    def backward(ctx, g):
        return g[:, _columns(g, ctx.group)].contiguous(), None


def slice_columns(x: torch.Tensor, group) -> torch.Tensor:
    """This rank's block of the columns of a replicated ``x`` [N, F] (rank
    r of the group takes ``[r·F/n, (r+1)·F/n)``); the backward gathers the
    cotangent's column blocks over the group."""
    return _SliceColumns.apply(x, group)


def gather_columns(x: torch.Tensor, group) -> torch.Tensor:
    """Every rank's column block ``x`` [N, F/n], concatenated in rank order
    into the replicated [N, F]; the backward takes this rank's block of the
    (replicated) cotangent."""
    return _GatherColumns.apply(x, group)


def sum_to_replicated(x: torch.Tensor, group=None) -> torch.Tensor:
    """``psum`` of per-rank partials into a replicated value; identity
    backward (the cotangent is replicated already)."""
    return _SumToReplicated.apply(x, group)


def from_replicated(x: torch.Tensor, group=None) -> torch.Tensor:
    """Mark a replicated input whose ranks each take a part of its use:
    identity forward, ``all_reduce`` of the cotangent backward."""
    return _FromReplicated.apply(x, group)


def all_to_all(x: torch.Tensor, group=None) -> torch.Tensor:
    """``x`` [D, b, ...]: block i goes to rank i, and block j of the result
    came from rank j (``jax.lax.all_to_all(split_axis=0, concat_axis=0,
    tiled=False)``); the backward is the same exchange of the cotangent."""
    return _AllToAll.apply(x, group)
