"""End-to-end hypergraph-GNN models (``torch.nn``).

Port of ``hypergef_tpu/models/zoo.py``: :class:`HGNN` (``:31-69``),
:class:`UniGIN` (``:72-93``), :class:`UniGCNII` (``:96-127``) and
:func:`build_model` (``:130-179``). HGNN and UniGIN stack input dropout →
[conv → activation → dropout]×(nlayer-1) → conv_out → log_softmax; UniGCNII
is lin_in → nlayer UniGCNIIConv with α = 0.1, β_i = log(λ/(i+1)+1), λ = 0.5
→ lin_out. Dropout follows the module's train/eval mode, which takes the
place of flax's ``deterministic`` flag, and draws its masks from the
``torch.Generator`` that ``forward`` is given (the trainer's, seeded from
its config), as flax draws them from an explicit key.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn

from hypergef_tpu_torch.models.layers import HGNNConv, UniGCNIIConv, UniGINConv, lecun_normal_

_ACTS = {
    "relu": torch.relu,
    "leaky_relu": lambda x: nn.functional.leaky_relu(x, negative_slope=0.01),
}
# 'prelu' (the reference's option for UniGCNII) is a module with a learnable
# slope: UniGCNII holds one, shared by every layer (zoo.py:111-112).


def dropout(x, rate: float, training: bool, generator: Optional[torch.Generator]):
    """flax's ``nn.Dropout``: keep each entry with probability 1 - rate and
    scale it by 1 / (1 - rate); the mask comes from ``generator``."""
    if not training or rate == 0.0:
        return x
    if rate >= 1.0:
        return torch.zeros_like(x)
    keep = torch.empty_like(x).bernoulli_(1.0 - rate, generator=generator)
    return torch.where(keep.bool(), x / (1.0 - rate), torch.zeros_like(x))


class HGNN(nn.Module):
    def __init__(
        self,
        nfeat: int,
        nhid: int,
        nclass: int,
        num_edges: int,
        nlayer: int = 2,
        first_aggr: str = "sum",
        nhead: int = 1,
        dropout: float = 0.6,
        input_drop: float = 0.6,
        activation: str = "relu",
        learn_wdiag: bool = False,
        backend: Optional[str] = None,
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        self.act = _ACTS[activation]
        self.input_drop_rate = input_drop
        self.dropout_rate = dropout
        widths = [nfeat] + [nhead * nhid] * (nlayer - 1)
        convs = [
            HGNNConv(widths[i], nhid, num_edges, first_aggr, heads=nhead,
                     learn_wdiag=learn_wdiag, backend=backend, generator=generator)
            for i in range(nlayer - 1)
        ]
        # DELIBERATE deviation from the reference, kept from the JAX package
        # (zoo.py:57-61): the output layer is heads=1, so the logits are
        # nclass wide for any nhead.
        convs.append(
            HGNNConv(widths[-1], nclass, num_edges, first_aggr, heads=1,
                     learn_wdiag=learn_wdiag, backend=backend, generator=generator)
        )
        self.convs = nn.ModuleList(convs)

    def forward(self, x, hgd, plan=None, generator: Optional[torch.Generator] = None):
        x = dropout(x, self.input_drop_rate, self.training, generator)
        for conv in self.convs[:-1]:
            x = dropout(self.act(conv(x, hgd, plan)), self.dropout_rate, self.training,
                        generator)
        return torch.log_softmax(self.convs[-1](x, hgd, plan), dim=1)


class UniGIN(nn.Module):
    """HGNN's stack with UniGINConv layers (``zoo.py:72-93``); the output
    layer is heads=1, as HGNN's."""

    def __init__(
        self,
        nfeat: int,
        nhid: int,
        nclass: int,
        nlayer: int = 2,
        nhead: int = 1,
        dropout: float = 0.6,
        input_drop: float = 0.6,
        activation: str = "relu",
        backend: Optional[str] = None,
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        self.act = _ACTS[activation]
        self.input_drop_rate = input_drop
        self.dropout_rate = dropout
        widths = [nfeat] + [nhead * nhid] * (nlayer - 1)
        convs = [UniGINConv(widths[i], nhid, heads=nhead, backend=backend, generator=generator)
                 for i in range(nlayer - 1)]
        convs.append(UniGINConv(widths[-1], nclass, heads=1, backend=backend,
                                generator=generator))
        self.convs = nn.ModuleList(convs)

    def forward(self, x, hgd, plan=None, generator: Optional[torch.Generator] = None):
        x = dropout(x, self.input_drop_rate, self.training, generator)
        for conv in self.convs[:-1]:
            x = dropout(self.act(conv(x, hgd, plan)), self.dropout_rate, self.training,
                        generator)
        return torch.log_softmax(self.convs[-1](x, hgd, plan), dim=1)


def _dense(nin: int, nout: int, generator: Optional[torch.Generator]) -> nn.Linear:
    """flax's ``nn.Dense`` with bias: lecun-normal kernel, zero bias."""
    lin = nn.Linear(nin, nout)
    lecun_normal_(lin.weight, generator)
    nn.init.zeros_(lin.bias)
    return lin


class UniGCNII(nn.Module):
    """``zoo.py:96-127``: dropout → act(lin_in) = x0 → nlayer × [dropout →
    act(UniGCNIIConv(x, x0, α, β_i))] → dropout → lin_out → log_softmax, at
    width nhid·nhead. There is no separate input dropout rate."""

    def __init__(
        self,
        nfeat: int,
        nhid: int,
        nclass: int,
        nlayer: int = 2,
        nhead: int = 1,
        dropout: float = 0.6,
        activation: str = "relu",
        lamda: float = 0.5,
        alpha: float = 0.1,
        backend: Optional[str] = None,
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        if activation == "prelu":
            self.prelu = nn.PReLU(num_parameters=1, init=0.01)  # flax's negative_slope_init
            self.act = self.prelu.forward  # a method: the module is registered once
        else:
            self.act = _ACTS[activation]
        self.dropout_rate = dropout
        self.alpha = alpha
        width = nhid * nhead
        self.lin_in = _dense(nfeat, width, generator)
        self.convs = nn.ModuleList(
            UniGCNIIConv(width, backend=backend, generator=generator) for _ in range(nlayer))
        self.betas = [math.log(lamda / (i + 1) + 1.0) for i in range(nlayer)]
        self.lin_out = _dense(width, nclass, generator)

    def forward(self, x, hgd, plan=None, generator: Optional[torch.Generator] = None):
        x = dropout(x, self.dropout_rate, self.training, generator)
        x = x0 = self.act(self.lin_in(x))
        for conv, beta in zip(self.convs, self.betas):
            x = dropout(x, self.dropout_rate, self.training, generator)
            x = self.act(conv(x, x0, self.alpha, beta, hgd, plan))
        x = dropout(x, self.dropout_rate, self.training, generator)
        return torch.log_softmax(self.lin_out(x), dim=1)


def build_model(
    model: str,
    nfeat: int,
    nhid: int,
    nclass: int,
    num_edges: int,
    nlayer: int = 2,
    first_aggr: str = "sum",
    nhead: int = 1,
    dropout: float = 0.6,
    input_drop: float = 0.6,
    activation: str = "relu",
    backend: Optional[str] = None,
    *,
    device,
    seed: int = 0,
):
    """Model registry (``zoo.py:130-179``), each family given the arguments
    JAX gives it (``first_aggr`` and ``num_edges`` go to HGNN alone,
    ``input_drop`` to HGNN and UniGIN). Weights are drawn on the CPU from a
    ``torch.Generator`` seeded with ``seed`` (so a seed gives the same
    weights on every device), then moved to ``device``."""
    gen = torch.Generator().manual_seed(seed)
    if model == "HGNN":
        net = HGNN(nfeat, nhid, nclass, num_edges, nlayer=nlayer, first_aggr=first_aggr,
                   nhead=nhead, dropout=dropout, input_drop=input_drop,
                   activation=activation, backend=backend, generator=gen)
    elif model == "UniGIN":
        net = UniGIN(nfeat, nhid, nclass, nlayer=nlayer, nhead=nhead, dropout=dropout,
                     input_drop=input_drop, activation=activation, backend=backend,
                     generator=gen)
    elif model == "UniGCNII":
        net = UniGCNII(nfeat, nhid, nclass, nlayer=nlayer, nhead=nhead, dropout=dropout,
                       activation=activation, backend=backend, generator=gen)
    else:
        raise ValueError(f"unknown model {model!r} (HGNN | UniGIN | UniGCNII)")
    return net.to(device)
