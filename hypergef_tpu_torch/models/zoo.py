"""End-to-end hypergraph-GNN models (``torch.nn``).

Port of ``hypergef_tpu/models/zoo.py``: :class:`HGNN` (``:31-69``) and
:func:`build_model` (``:130-179``). The stack is input dropout →
[conv → activation → dropout]×(nlayer-1) → conv_out → log_softmax. Dropout
follows the module's train/eval mode, which takes the place of flax's
``deterministic`` flag, and draws its masks from the ``torch.Generator``
that ``forward`` is given (the trainer's, seeded from its config), as flax
draws them from an explicit key. UniGIN and UniGCNII are not ported yet.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from hypergef_tpu_torch.models.layers import HGNNConv

_ACTS = {
    "relu": torch.relu,
    "leaky_relu": lambda x: nn.functional.leaky_relu(x, negative_slope=0.01),
}


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
    """Model registry (``zoo.py:130-179``). Weights are drawn on the CPU
    from a ``torch.Generator`` seeded with ``seed`` (so a seed gives the
    same weights on every device), then moved to ``device``."""
    if model in ("UniGIN", "UniGCNII"):
        raise NotImplementedError(
            f"{model} is not ported yet (ROADMAP.md queue 1, item 4)")
    if model != "HGNN":
        raise ValueError(f"unknown model {model!r} (HGNN | UniGIN | UniGCNII)")
    gen = torch.Generator().manual_seed(seed)
    net = HGNN(nfeat, nhid, nclass, num_edges, nlayer=nlayer, first_aggr=first_aggr,
               nhead=nhead, dropout=dropout, input_drop=input_drop,
               activation=activation, backend=backend, generator=gen)
    return net.to(device)
