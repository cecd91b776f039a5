"""Full-batch training with the reference's protocol.

Port of ``hypergef_tpu/train/trainer.py``: :class:`TrainConfig`
(``:32-64``), :func:`make_optimizer` (``:67-74``), :class:`Trainer`
(``:77-200``, ``:292-328``) and :func:`train_full_batch` (``:331-338``).
The protocol is ``HyperGsys/hgsys.py:146-211``'s: Adam(lr=0.01,
weight-decay 5e-4, L2 added to the gradient), ``nll_loss`` on the train
split, ``warmup`` untimed epochs then ``epochs`` timed ones, a separate
timed inference loop, accuracy on each split.

PyTorch runs eagerly, so a step is the model's forward, the loss, the
backward and the optimizer step, with no jit around them. Times come from
:class:`~hypergef_tpu_torch.utils.timing.Window`: CUDA events around the
loop on a card (host time included), the host clock on the CPU; each
result names its ``timer``. JAX's chained-``fori_loop`` differencing
(``:199-290``) is not ported: events time the card directly.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Mapping, Optional

import numpy as np
import torch
from torch.nn import functional as F

from hypergef_tpu_torch.models.zoo import build_model
from hypergef_tpu_torch.ops import fused
from hypergef_tpu_torch.ops.bitstream import BitIncidence
from hypergef_tpu_torch.sparse.planner import (
    AggregationPlan, DensePrecomp, TreePlan, plan_aggregation, plan_aligned, plan_tree,
)
from hypergef_tpu_torch.train.splits import accuracy
from hypergef_tpu_torch.utils.timing import Window


@dataclasses.dataclass
class TrainConfig:
    """The reference's argparse knobs (``hgsys.py:22-70``) plus route
    options. ``model`` is HGNN, UniGIN or UniGCNII. ``backend="auto"`` (the
    default) trains on the route the ladder picks
    (:func:`~hypergef_tpu_torch.sparse.planner.plan_aggregation`); ``None``
    takes the process-global default route (``cumsum``). ``tune`` and
    ``plan_cache`` need modules that are not ported yet (ROADMAP.md queue 1,
    "Autotune and the plan cache")."""

    model: str = "HGNN"
    nhid: int = 32
    nlayer: int = 2
    nhead: int = 1
    first_aggr: str = "sum"
    dropout: float = 0.6
    input_drop: float = 0.6
    activation: str = "relu"
    lr: float = 0.01
    wd: float = 5e-4
    epochs: int = 200
    warmup: int = 10
    seed: int = 1
    train_prop: float = 0.5
    valid_prop: float = 0.25
    backend: Optional[str] = "auto"
    tune: bool = False
    plan_cache: Optional[str] = None


def make_optimizer(params, lr: float, wd: float) -> torch.optim.Adam:
    """Adam with L2 added to the gradient before the moments, which is
    what ``optax.add_decayed_weights(wd)`` then ``scale_by_adam()`` do
    (betas 0.9/0.999, eps 1e-8); not the decoupled AdamW."""
    return torch.optim.Adam(params, lr=lr, betas=(0.9, 0.999), eps=1e-8, weight_decay=wd)


def default_plan(backend: Optional[str], hg, device, first_aggr: str = "sum"):
    """The plan the JAX Trainer builds for ``backend`` (``:88-99``): the
    ladder's plan (:func:`plan_aggregation` on ``device``) for ``auto``,
    ``precomp`` and None, as JAX builds it for every route but ``xla`` and
    ``cumsum``; none for ``xla`` and ``cumsum`` (the tree for max on
    ``cumsum``, where JAX would fall back to its oracle); the
    int8 table for ``dense``/``pallas`` (with ``first_aggr="max"`` also the
    tree, whose edge stage carries the record table, as JAX's
    ``plan_aggregation`` always holds one), the tree for ``tree``; for
    ``aligned`` the plain-form aligned plan, the one JAX's ladder picks for
    a community-sorted graph (``plan_aligned`` raises ``ValueError`` for a
    graph that is not: run ``community_reorder`` first). Max on ``aligned``
    runs the masked argmax on the aligned edge stage. ``bitstream`` gets the
    bit packs, the plan JAX's ladder builds in its band (``planner.py:735-754``),
    with the tree for max."""
    if backend == "xla":
        return None
    if backend == "cumsum":
        return AggregationPlan(tree=plan_tree(hg)) if first_aggr == "max" else None
    if backend in (None, "auto", "precomp"):
        return plan_aggregation(hg, device)
    if backend in ("dense", "pallas", "bitstream"):
        if backend == "bitstream":
            plan = AggregationPlan(bitstream=BitIncidence.from_hypergraph(hg))
        else:
            plan = AggregationPlan.dense_plan(hg, device)
        if first_aggr == "max":
            plan.tree = plan_tree(hg)
        return plan
    if backend == "tree":
        return AggregationPlan(tree=plan_tree(hg))
    if backend == "aligned":
        return AggregationPlan(aligned=plan_aligned(hg))
    if backend == "pallas_sparse":
        raise ValueError(
            "backend 'pallas_sparse' needs its plan: pass plan=plan_pallas_sparse(hg), "
            "as the JAX package's Trainer needs it too")
    fused.resolve_backend(backend, None)  # raises for a route left out or unknown
    raise AssertionError(backend)


def device_plans(plan):
    """The stage plans, bit packs and propagation matrix of ``plan``, whose
    tables go to the device when a Trainer or a server is built, not inside
    its first step."""
    if isinstance(plan, (TreePlan, BitIncidence, DensePrecomp)):
        return [plan]
    fields = ("tree", "pallas_sparse", "aligned", "bitstream", "precomp")
    return [p for p in (getattr(plan, f, None) for f in fields) if p is not None]


class Trainer:
    """A model, its optimizer and its graph on one device.

    ``device`` is the card unless the caller asks for the CPU
    (``device="cpu"``); without a card the default raises. ``params`` is a
    ``state_dict`` (for instance from
    :func:`hypergef_tpu_torch.models.convert.params_from_flax`); without it
    the weights are drawn from ``cfg.seed``. Dropout masks come from a
    ``torch.Generator`` on ``device``, seeded from ``cfg.seed`` at each
    :meth:`fit`, as the JAX trainer re-keys its dropout there.
    """

    def __init__(self, cfg: TrainConfig, hg, x, y, nclass: Optional[int] = None, plan=None,
                 *, device="cuda", params: Optional[Mapping[str, Any]] = None):
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: the Trainer runs on the card unless it is given "
                "device='cpu'")
        if cfg.tune:
            raise NotImplementedError(
                "tune (the measured autotune) is not ported yet (ROADMAP.md queue 1, "
                "'Autotune and the plan cache')")
        if cfg.plan_cache is not None:
            raise NotImplementedError(
                "plan_cache is not ported yet (ROADMAP.md queue 1, 'Autotune and the plan "
                "cache')")
        self.cfg = cfg
        self.hg = hg
        if plan is None:
            plan = default_plan(cfg.backend, hg, self.device, cfg.first_aggr)
        self.plan = plan
        for p in device_plans(self.plan):
            p.device(self.device)  # tables put on the device and checked once, here
        self.hgd = hg.device_data(self.device)
        self.x = torch.as_tensor(np.asarray(x), dtype=torch.float32, device=self.device)
        self.y = torch.as_tensor(np.asarray(y), dtype=torch.int64, device=self.device)
        self.nclass = int(nclass if nclass is not None else int(np.asarray(y).max()) + 1)
        self.model = build_model(
            cfg.model, nfeat=self.x.shape[1], nhid=cfg.nhid, nclass=self.nclass,
            num_edges=hg.num_edges, nlayer=cfg.nlayer, first_aggr=cfg.first_aggr,
            nhead=cfg.nhead, dropout=cfg.dropout, input_drop=cfg.input_drop,
            activation=cfg.activation, backend=cfg.backend, seed=cfg.seed,
            device=self.device,
        )
        if params is not None:
            self.model.load_state_dict({k: torch.as_tensor(v) for k, v in params.items()})
        self.optimizer = make_optimizer(self.model.parameters(), cfg.lr, cfg.wd)
        self.generator = torch.Generator(device=self.device)

    def _index(self, idx) -> torch.Tensor:
        return torch.as_tensor(np.asarray(idx), dtype=torch.int64, device=self.device)

    def step(self, train_idx: torch.Tensor) -> torch.Tensor:
        """One training epoch: forward, nll over ``train_idx``, backward,
        Adam. Returns the loss before the update, on the device."""
        self.model.train()
        self.optimizer.zero_grad(set_to_none=True)
        z = self.model(self.x, self.hgd, self.plan, generator=self.generator)
        loss = F.nll_loss(z.index_select(0, train_idx), self.y.index_select(0, train_idx))
        loss.backward()
        self.optimizer.step()
        return loss.detach()

    def fit(self, train_idx, epochs: Optional[int] = None,
            warmup: Optional[int] = None) -> Dict[str, Any]:
        """Warm-up + timed training epochs (protocol of hgsys.py:162-195).

        ``losses`` holds each timed epoch's loss; they are read back once,
        after the timed window."""
        cfg = self.cfg
        epochs = cfg.epochs if epochs is None else epochs
        warmup = cfg.warmup if warmup is None else warmup
        train_idx = self._index(train_idx)
        self.generator.manual_seed(cfg.seed + 1)
        last = torch.zeros(())
        for _ in range(warmup):
            last = self.step(train_idx)
        losses = []
        with Window(self.device) as window:
            for _ in range(epochs):
                losses.append(self.step(train_idx))
        if losses:
            last = losses[-1]
        return {
            "train_epoch_time_s": window.seconds / max(epochs, 1),
            "timer": window.timer,
            "final_loss": float(last),
            "losses": torch.stack(losses).cpu().numpy() if losses else np.zeros(0, np.float32),
            "epochs": epochs,
        }

    def predict(self) -> torch.Tensor:
        """Full-graph log-probabilities in eval mode, on the device."""
        self.model.eval()
        with torch.no_grad():
            return self.model(self.x, self.hgd, self.plan)

    def evaluate(self, split_idx) -> Dict[str, float]:
        z = self.predict().cpu().numpy()
        y = self.y.cpu().numpy()
        out = {}
        for name, idx in split_idx.items():
            idx = np.asarray(idx)
            if idx.size:
                out[f"{name}_acc"] = accuracy(z[idx], y[idx])
        return out

    def time_inference(self, iters: int = 200, warmup: int = 10) -> float:
        """Seconds per full-graph forward, over ``iters`` back-to-back ones."""
        for _ in range(warmup):
            self.predict()
        with Window(self.device) as window:
            for _ in range(iters):
                self.predict()
        return window.seconds / max(iters, 1)

    def save(self, directory: str, step: int = 0, wait: bool = True) -> None:
        raise NotImplementedError(
            "checkpointing is not ported yet (ROADMAP.md queue 1, 'Serving export and "
            "checkpoints')")

    def restore(self, directory: str, step: Optional[int] = None) -> int:
        raise NotImplementedError(
            "checkpointing is not ported yet (ROADMAP.md queue 1, 'Serving export and "
            "checkpoints')")


def train_full_batch(cfg: TrainConfig, hg, x, y, split_idx, nclass=None, plan=None, *,
                     device="cuda", params: Optional[Mapping[str, Any]] = None):
    """One call in the manner of the reference CLI run: timing + accuracy
    (the CSV row of ``hgsys.py:207-211``), on the card unless ``device``
    says otherwise."""
    tr = Trainer(cfg, hg, x, y, nclass=nclass, plan=plan, device=device, params=params)
    res = tr.fit(split_idx["train"])
    res["inference_time_s"] = tr.time_inference(iters=max(cfg.epochs // 2, 1))
    res.update(tr.evaluate(split_idx))
    return res
