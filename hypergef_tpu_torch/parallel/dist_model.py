"""Distributed full-batch models over the edge-partitioned aggregation.

Port of ``hypergef_tpu/parallel/dist_model.py`` (``:1-241``): the
functional 2-layer HGNN, the 2-layer UniGIN and UniGCNII, whose
aggregations run :mod:`.dist_aggr` while the projections run replicated on
every rank. Parameters are a dict of tensors under JAX's names (``W1``,
``W2``; ``eps1``, ``eps2``; ``lin_in``, ``lin_out``, ``W{i}``), kernels
``[in, out]`` as JAX keeps them (``x @ W``).

Each rank computes the whole loss from the replicated output, so its
gradients are the whole gradients (:mod:`.comm`'s conjugate pair) and Adam
(:func:`~hypergef_tpu_torch.train.trainer.make_optimizer`, JAX's optax
chain) takes the same step on every rank. Padded classifier columns are
masked to -1e30 before the softmax (``:80-83``). Weights are drawn from a
seeded ``torch.Generator`` on the CPU, so every rank draws the same ones;
:func:`dist_params_from_jax` takes JAX's instead.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, Mapping, Optional

import numpy as np
import torch
from torch.nn import functional as F

MODELS = ("HGNN", "UniGIN", "UniGCNII")


def _uniform(gen: torch.Generator, shape, scale: float) -> torch.Tensor:
    return (torch.rand(shape, generator=gen, dtype=torch.float32) * 2.0 - 1.0) * scale


def init_dist_params(model: str, seed: int, nfeat: int, nhid: int, nclass: int,
                     class_pad: int = 1, nlayer: int = 2) -> Dict[str, torch.Tensor]:
    """The model's weights, uniform in ±(1/fan_in)^½ as JAX draws them
    (``:25-36``, ``:103-116``, ``:151-166``), from ``seed`` on the CPU."""
    gen = torch.Generator().manual_seed(seed)
    ncls_p = -(-nclass // class_pad) * class_pad
    s_in, s_h = (1.0 / nfeat) ** 0.5, (1.0 / nhid) ** 0.5
    if model == "HGNN":
        return {"W1": _uniform(gen, (nfeat, nhid), s_in),
                "W2": _uniform(gen, (nhid, ncls_p), s_h)}
    if model == "UniGIN":
        return {"W1": _uniform(gen, (nfeat, nhid), s_in),
                "W2": _uniform(gen, (nhid, ncls_p), s_h),
                "eps1": torch.zeros(()), "eps2": torch.zeros(())}
    if model == "UniGCNII":
        params = {"lin_in": _uniform(gen, (nfeat, nhid), s_in),
                  "lin_out": _uniform(gen, (nhid, ncls_p), s_h)}
        for i in range(nlayer):
            params[f"W{i}"] = _uniform(gen, (nhid, nhid), s_h)
        return params
    raise ValueError(f"unknown distributed model {model!r}")


def dist_params_from_jax(params: Mapping) -> Dict[str, torch.Tensor]:
    """JAX's distributed param dict (arrays, read with ``np.asarray``) as the
    port's tensors, under the same names and layouts."""
    return {k: torch.from_numpy(np.array(np.asarray(v, dtype=np.float32), order="C"))
            for k, v in params.items()}


def mask_classes(z: torch.Tensor, nclass: Optional[int]) -> torch.Tensor:
    """Padded classifier columns out of the softmax (``:80-83``)."""
    if nclass is not None and z.shape[1] > nclass:
        col = torch.arange(z.shape[1], device=z.device)[None, :]
        z = torch.where(col < nclass, z, torch.full_like(z, -1e30))
    return z


def unigcnii_betas(nlayer: int, lamda: float) -> list:
    return [math.log(lamda / (i + 1) + 1.0) for i in range(nlayer)]


def make_forward(model: str, aggregate: Callable, unignn: Callable, degV,
                 first_aggr: str = "sum", nclass: Optional[int] = None, nlayer: int = 2,
                 lamda: float = 0.5, alpha: float = 0.1) -> Callable:
    """The model's forward ``(params, x) -> log-probabilities`` over the two
    aggregation callables: ``aggregate(x, first_aggr, degV)`` (HGNN) and
    ``unignn(x, use_deg, degV)`` (UniGNN), which :class:`~.trainer.DistTrainer`
    binds to the plan (``:60-84``, ``:119-145``, ``:169-204``)."""
    if model == "HGNN":
        def forward(params, x):
            h = F.relu(aggregate(x @ params["W1"], first_aggr, degV))
            z = aggregate(h @ params["W2"], first_aggr, degV)
            return F.log_softmax(mask_classes(z, nclass), dim=1)
    elif model == "UniGIN":
        def forward(params, x):
            xw = x @ params["W1"]
            h = F.relu(unignn(xw, False, None) + (1.0 + params["eps1"]) * xw)
            hw = h @ params["W2"]
            z = unignn(hw, False, None) + (1.0 + params["eps2"]) * hw
            return F.log_softmax(mask_classes(z, nclass), dim=1)
    elif model == "UniGCNII":
        betas = unigcnii_betas(nlayer, lamda)

        def forward(params, x):
            h = F.relu(x @ params["lin_in"])
            h0 = h
            for i in range(nlayer):
                xv = unignn(h, True, degV)
                xi = (1.0 - alpha) * xv + alpha * h0
                h = F.relu((1.0 - betas[i]) * xi + betas[i] * (xi @ params[f"W{i}"]))
            z = h @ params["lin_out"]
            return F.log_softmax(mask_classes(z, nclass), dim=1)
    else:
        raise ValueError(f"unknown distributed model {model!r}")
    return forward


def masked_nll_terms(logp: torch.Tensor, y: torch.Tensor, mask: torch.Tensor):
    """(-Σ picked·mask, Σ mask) of the masked mean NLL (``:69-74``): the loss
    is their ratio, the count at least 1."""
    picked = logp.gather(1, y[:, None])[:, 0]
    return -(picked * mask).sum(), mask.sum()
