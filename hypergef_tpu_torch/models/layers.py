"""Hypergraph convolution layers (``torch.nn``).

Port of ``hypergef_tpu/models/layers.py``: :class:`HGNNConv` (``:34-61``),
:class:`UniGINConv` (``:64-80``) and :class:`UniGCNIIConv` (``:83-98``). The
aggregation route is chosen underneath by
:mod:`hypergef_tpu_torch.ops.fused`, so a layer runs on every ported route
unchanged.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn

from hypergef_tpu_torch.ops import fused

# flax's lecun_normal: a normal cut at ±2σ, rescaled to unit variance
_TRUNC_STD = 0.87962566103423978


def lecun_normal_(w: torch.Tensor, generator: Optional[torch.Generator]) -> torch.Tensor:
    """flax's default Dense kernel init for a torch ``[out, in]`` weight."""
    std = math.sqrt(1.0 / w.shape[1]) / _TRUNC_STD
    with torch.no_grad():
        return nn.init.trunc_normal_(w, 0.0, std, -2.0 * std, 2.0 * std, generator=generator)


class HGNNConv(nn.Module):
    """No-bias projection, then the fused aggregation with an optional
    per-hyperedge ``wdiag`` (``layers.py:34-61``)."""

    def __init__(
        self,
        in_features: int,
        out_features: int,
        num_edges: int,
        first_aggr: str = "sum",
        heads: int = 1,
        learn_wdiag: bool = False,
        backend: Optional[str] = None,
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        self.first_aggr = first_aggr
        self.backend = backend
        self.linear = nn.Linear(in_features, heads * out_features, bias=False)
        lecun_normal_(self.linear.weight, generator)
        # frozen Wdiag ≡ ones is passed as None, as on the JAX side
        self.wdiag = nn.Parameter(torch.ones((num_edges, 1))) if learn_wdiag else None

    def forward(self, x, hgd, plan=None):
        x = self.linear(x)
        return fused.hgnn_aggregate(
            hgd, x, self.wdiag, self.first_aggr, plan=plan, backend=self.backend
        )


class UniGINConv(nn.Module):
    """``(1+ε)·XW + H Hᵀ (XW)`` with a no-bias projection and a learnable
    ε of shape (1,), initialised to 0 (``layers.py:64-80``)."""

    def __init__(
        self,
        in_features: int,
        out_features: int,
        heads: int = 1,
        backend: Optional[str] = None,
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        self.backend = backend
        self.linear = nn.Linear(in_features, heads * out_features, bias=False)
        lecun_normal_(self.linear.weight, generator)
        self.eps = nn.Parameter(torch.zeros(1))

    def forward(self, x, hgd, plan=None):
        x = self.linear(x)
        xv = fused.unignn_aggregate(hgd, x, use_deg=False, plan=plan, backend=self.backend)
        return (1.0 + self.eps) * x + xv


class UniGCNIIConv(nn.Module):
    """Degree-scaled propagation with the α/β identity-mapping residuals
    (``layers.py:83-98``): ``xi = (1-α)·degV H degE Hᵀ x + α·x0``, then
    ``(1-β)·xi + β·xi W`` with a no-bias ``W``."""

    def __init__(
        self,
        features: int,
        backend: Optional[str] = None,
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        self.backend = backend
        self.W = nn.Linear(features, features, bias=False)
        lecun_normal_(self.W.weight, generator)

    def forward(self, x, x0, alpha: float, beta: float, hgd, plan=None):
        xv = fused.unignn_aggregate(hgd, x, use_deg=True, plan=plan, backend=self.backend)
        xi = (1.0 - alpha) * xv + alpha * x0
        return (1.0 - beta) * xi + beta * self.W(xi)
