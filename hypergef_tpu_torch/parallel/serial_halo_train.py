"""A full-batch training step over a multi-shard :class:`~.halo.HaloPlan`,
one shard at a time on one device.

Port of ``hypergef_tpu/parallel/serial_halo_train.py`` (``:1-326``): the
two-layer HGNN ``z = A(relu(A(X·W1))·W2)``, ``A = diag(degV)·H·diag(degE)·Hᵀ``
(the fused layer, sum), its masked NLL, and the backward, each layer in
:mod:`.serial_halo`'s discipline. The cross-shard dataflow is linear (the
exchanges are permutations and one owner-side gather), so the whole
backward factors into per-shard backwards glued by host transposes:

* forward: per shard, ``x·W`` on the card, then the layer's shard turns
  (:func:`~.halo_aggr.shard_compute`), then the owner combines with the
  relu or the loss;
* backward: each shard's turn runs its forward again under
  ``torch.enable_grad()`` and takes ``torch.autograd.grad`` with the
  cotangent of its return rows, so no shard's residuals outlive its turn;
  every take and tree stage has its fixed-order backward
  (:mod:`.exact`: the segment-sum kernel on the card), the aligned interior
  the band kernel;
* the exchanges' transposes run on the host: the permutations are their own
  inverses, and the halo gather's transpose is one ``np.add.at`` an owner,
  in a fixed order (``:132-140``).

Two runs of a step give bitwise equal gradients. Host arrays between the
turns are NumPy, as JAX's are. :func:`serialized_halo_train_epochs` draws
JAX's initial weights with NumPy and steps them with ``torch.optim.AdamW``
on the host with optax's ``adamw`` constants (``:300-326``); the main
``Trainer``'s optimizer is Adam with L2, this one decoupled decay.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch
from torch.nn import functional as F

from hypergef_tpu_torch.parallel.halo_aggr import (
    owner_combine, shard_compute, shard_vertex_features,
)
from hypergef_tpu_torch.parallel.serial_halo import (
    ShardTables, TurnTimers, layer_turns, serial_device, to_device,
)


def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy()


def _halo_gather_T(plan, dhalo_in: np.ndarray, n_own: int) -> np.ndarray:
    """The transpose of :func:`~.serial_halo.halo_gather`: each owner's
    scatter-add over its send slots, in JAX's order."""
    D, f = plan.n_shards, dhalo_in.shape[-1]
    dxw = np.zeros((D, n_own, f), np.float32)
    for s in range(D):
        np.add.at(dxw[s], plan.halo_send_slot[s].reshape(-1),
                  dhalo_in[:, s].reshape(D * plan.b_cap_h, f))
    return dxw


def _layer_backward(plan, tables: ShardTables, xw, halo_in, dret_in) -> np.ndarray:
    """The layer's backward from the cotangent of its return buffer: each
    shard's turn recomputes its forward and takes its gradients; returns
    the cotangent of ``xw`` [D, n_own, F]."""
    D, dev = plan.n_shards, tables.device
    dxw = np.empty_like(xw)
    dhalo_in = np.empty_like(halo_in)
    for d in range(D):
        loc = tables.local(d)
        with torch.enable_grad():
            xb = to_device(xw[d], dev).requires_grad_(True)
            hi = to_device(halo_in[d], dev).requires_grad_(True)
            ret = shard_compute(plan, loc, xb, hi)
            dx, dh = torch.autograd.grad(ret, (xb, hi), to_device(dret_in[:, d], dev))
        dxw[d], dhalo_in[d] = _np(dx), _np(dh)
        del loc, xb, hi, ret, dx, dh
    return dxw + _halo_gather_T(plan, dhalo_in, plan.n_own)


def _combine_grad(plan, tables, ret_in, fn) -> np.ndarray:
    """Each owner's gradient of ``fn(combine output, d)`` (a scalar) with
    respect to its return rows."""
    out = np.empty_like(ret_in)
    for d in range(plan.n_shards):
        comb = tables.combine(d)
        with torch.enable_grad():
            r = to_device(ret_in[d], tables.device).requires_grad_(True)
            (g,) = torch.autograd.grad(fn(owner_combine(plan, comb, r), d), (r,))
        out[d] = _np(g)
        del comb, r, g
    return out


def _picked(z: torch.Tensor, y: torch.Tensor, m: torch.Tensor) -> torch.Tensor:
    """``-Σ log_softmax(z)[y] · m`` over the rows (every column counts, as
    JAX's, whose padded classes stay in the softmax)."""
    return -(F.log_softmax(z, dim=-1).gather(1, y[:, None])[:, 0] * m).sum()


def serialized_halo_train_step(
    plan,
    params: Dict[str, np.ndarray],
    x: np.ndarray,
    y: np.ndarray,
    train_mask: np.ndarray,
    stats: Optional[dict] = None,
    device=None,
    tables: Optional[ShardTables] = None,
):
    """One full-batch step (forward, masked NLL, backward) of the two-layer
    HGNN over a halo-sharded graph, one shard at a time on one device
    (``:195-297``). ``params`` ``{"w1": [F, H], "w2": [H, C]}``; returns
    ``(loss, {"w1": dW1, "w2": dW2})`` as NumPy, as JAX's. ``stats`` gathers
    the forward's layer turns (the timers of
    :func:`~.serial_halo.serialized_halo_forward`, two turns a shard a
    step), lists extended and seconds summed over the steps that share it.
    ``tables`` (built for ``device`` when None) may be shared between
    steps."""
    device = serial_device(device)
    if tables is None:
        tables = ShardTables(plan, device)
    elif tables.plan is not plan or tables.device != device:
        raise ValueError("the tables were built for another plan or device")
    D, n_own = plan.n_shards, plan.n_own
    turns = TurnTimers(device)
    xs = shard_vertex_features(plan, np.asarray(x, np.float32)).reshape(D, n_own, -1)
    y_sh = shard_vertex_features(plan, np.asarray(y, np.int64)[:, None]).reshape(D, n_own)
    m_sh = shard_vertex_features(
        plan, np.asarray(train_mask, np.float32)[:, None]).reshape(D, n_own)
    w1 = to_device(np.asarray(params["w1"], np.float32), device)
    w2 = to_device(np.asarray(params["w2"], np.float32), device)

    def ym(d):
        return to_device(y_sh[d], device), to_device(m_sh[d], device)

    # ---- forward ----
    with torch.no_grad():
        xw1 = np.stack([_np(to_device(xs[d], device) @ w1) for d in range(D)])
        ret_in1, halo_in1 = layer_turns(plan, tables, xw1, turns)
        h = np.empty((D, n_own, w1.shape[1]), np.float32)
        for d in range(D):
            h[d] = _np(F.relu(owner_combine(plan, tables.combine(d),
                                            to_device(ret_in1[d], device))))
        hw2 = np.stack([_np(to_device(h[d], device) @ w2) for d in range(D)])
        ret_in2, halo_in2 = layer_turns(plan, tables, hw2, turns)
        loss_num = denom = 0.0
        for d in range(D):
            yd, md = ym(d)
            z = owner_combine(plan, tables.combine(d), to_device(ret_in2[d], device))
            loss_num += float(_picked(z, yd, md))
            denom += float(md.sum())
    denom = max(denom, 1.0)
    loss = loss_num / denom

    # ---- backward ----
    den = torch.tensor(denom, dtype=torch.float32, device=device)
    dret_in2 = _combine_grad(plan, tables, ret_in2, lambda z, d: _picked(z, *ym(d)) / den)
    dhw2 = _layer_backward(plan, tables, hw2, halo_in2, dret_in2)
    dw2 = np.zeros(tuple(w2.shape), np.float32)
    dh = np.empty_like(h)
    with torch.no_grad():
        for d in range(D):
            g = to_device(dhw2[d], device)
            dw2 += _np(to_device(h[d], device).t() @ g)
            dh[d] = _np(g @ w2.t())
    dret_in1 = _combine_grad(
        plan, tables, ret_in1,
        lambda out, d: (F.relu(out) * to_device(dh[d], device)).sum())
    dxw1 = _layer_backward(plan, tables, xw1, halo_in1, dret_in1)
    dw1 = np.zeros(tuple(w1.shape), np.float32)
    with torch.no_grad():
        for d in range(D):
            dw1 += _np(to_device(xs[d], device).t() @ to_device(dxw1[d], device))
    if stats is not None:
        for k, v in turns.stats().items():
            stats[k] = stats.get(k, type(v)()) + v
    return loss, {"w1": dw1, "w2": dw2}


def serialized_halo_train_epochs(
    plan, x, y, train_mask, nhid: int, nclass: int,
    epochs: int = 1, lr: float = 0.01, wd: float = 5e-4, seed: int = 0,
    stats: Optional[dict] = None, device=None,
):
    """Full-batch epochs, one step each (``:300-326``): JAX's initial
    weights (``default_rng(seed).normal / sqrt(fan_in)``, classes padded to
    ``max(nclass, 8)``) and optax's ``adamw(lr, weight_decay=wd)`` as
    ``torch.optim.AdamW`` (betas 0.9, 0.999, eps 1e-8) on the host. The
    shards' tables are built once for all epochs. Returns (params, losses)
    as NumPy and floats."""
    device = serial_device(device)
    rng = np.random.default_rng(seed)
    f = np.asarray(x).shape[1]
    c_pad = max(nclass, 8)
    init = {
        "w1": (rng.normal(size=(f, nhid)) / np.sqrt(f)).astype(np.float32),
        "w2": (rng.normal(size=(nhid, c_pad)) / np.sqrt(nhid)).astype(np.float32),
    }
    params = {k: torch.from_numpy(v.copy()).requires_grad_(True) for k, v in init.items()}
    opt = torch.optim.AdamW(list(params.values()), lr=lr, betas=(0.9, 0.999), eps=1e-8,
                            weight_decay=wd)
    tables = ShardTables(plan, device)
    losses = []
    for _ in range(epochs):
        loss, grads = serialized_halo_train_step(
            plan, {k: p.detach().numpy() for k, p in params.items()}, x, y, train_mask,
            stats=stats, device=device, tables=tables)
        for k, p in params.items():
            p.grad = torch.from_numpy(grads[k])
        opt.step()
        losses.append(loss)
    return {k: p.detach().numpy().copy() for k, p in params.items()}, losses
