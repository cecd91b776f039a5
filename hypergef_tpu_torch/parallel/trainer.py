"""Distributed trainer: edge-partitioned full-batch training, one rank a
shard.

Port of ``hypergef_tpu/parallel/trainer.py`` (``:1-191``). Every rank of the
world builds a :class:`DistTrainer` over the same graph and features; each
takes its shard of the plan (:class:`~.partition.ShardedAggPlan`, built by
the caller once and handed to every rank, or here) and runs the same eager
steps. The losses and the weights are the same on every rank.

:meth:`DistTrainer.fit` runs ``warmup`` untimed epochs, then ``epochs``
timed ones between a barrier and CUDA events on the card (the host clock on
the CPU); it returns JAX's keys (``train_epoch_time_s``, ``final_loss``,
``n_shards``) with ``losses``, ``timer`` and ``step``. JAX runs the epochs
as one chained ``lax.scan`` program (``:102-130``); on an nccl rank the
port records one step into a CUDA graph (``compiled``: the forward with its
collectives, the tree stages and the fixed-order segment sums, the
record-routed sum for max, the backward and Adam) and replays it every
epoch, each loss copied into a device buffer read once at the end. A gloo
world (and so the feature axis on one card) runs eager steps, and says
so. ``save``/``restore`` go over
:mod:`~hypergef_tpu_torch.train.checkpoint`: rank 0 writes, every rank reads,
a barrier between. UniGIN and UniGCNII take ``first_aggr="sum"`` only
(``:67-97``).

``n_feature > 1`` lays the world out as an ``(n_shards, n_feature)`` grid
(:func:`~.mesh.make_mesh`): the world has ``n_shards · n_feature`` ranks,
each aggregation is feature-sharded (``feature_sharded=True``) and the
classifier is padded to a multiple of ``n_feature`` columns, masked out of
the softmax (``:53-97``), as JAX's.
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional

import numpy as np
import torch

from hypergef_tpu_torch.parallel.dist_aggr import sharded_hgnn_aggregate, sharded_unignn_aggregate
from hypergef_tpu_torch.parallel.dist_model import (
    MODELS, init_dist_params, make_forward, masked_nll_terms,
)
from hypergef_tpu_torch.parallel.mesh import Mesh, compiled_for, make_mesh
from hypergef_tpu_torch.parallel.partition import plan_sharded_aggregation
from hypergef_tpu_torch.train.checkpoint import restore_checkpoint, save_checkpoint
from hypergef_tpu_torch.train.splits import accuracy
from hypergef_tpu_torch.train.trainer import (
    _copy_into, init_adam_state, make_optimizer, record_step, training_state,
)
from hypergef_tpu_torch.utils.graphs import Captured
from hypergef_tpu_torch.utils.timing import Window


class DistTrainer:
    """The model, its optimizer and this rank's shard of the plan.

    ``compiled``: None records the step on an nccl rank (once a
    ``train_idx`` length, as JAX compiles once a shape: a warm-up on a
    snapshot that is put back, whose collectives also set up the
    communicator) and runs it eagerly on a gloo or CPU rank; False runs it
    eagerly; True on gloo or the CPU raises, naming nccl. A recording that
    fails raises ``CaptureError``; the step never falls back to eager."""

    def __init__(
        self,
        hg,
        x,
        y,
        nhid: int = 32,
        nclass: Optional[int] = None,
        n_shards: Optional[int] = None,
        n_feature: int = 1,
        lr: float = 0.01,
        wd: float = 5e-4,
        seed: int = 1,
        mesh: Optional[Mesh] = None,
        model: str = "HGNN",
        first_aggr: str = "sum",
        *,
        plan=None,
        params: Optional[Mapping] = None,
        compiled: Optional[bool] = None,
    ):
        n_f = n_feature if mesh is None or mesh.feature is None else mesh.feature.size
        if nhid % n_f != 0:
            raise ValueError(f"nhid={nhid} must be divisible by the feature-mesh axis ({n_f})")
        if model not in MODELS:
            raise ValueError(f"unknown distributed model {model!r}")
        if model == "UniGIN" and first_aggr != "sum":
            raise ValueError(
                "DistTrainer(model='UniGIN') supports first_aggr='sum' only (got "
                f"{first_aggr!r}); the UniGNN family is a plain H·Hᵀ sum aggregation")
        if model == "UniGCNII" and first_aggr != "sum":
            raise ValueError(
                "DistTrainer(model='UniGCNII') supports first_aggr='sum' only (got "
                f"{first_aggr!r}); UniGCNII's V→E stage is a degE-scaled sum")
        self.mesh = mesh or make_mesh(n_shards, n_feature)
        self.device = self.mesh.device
        self.n_shards = self.mesh.size
        self.compiled = compiled_for(self.mesh, compiled, "DistTrainer")
        self.plan = plan if plan is not None else plan_sharded_aggregation(hg, self.n_shards)
        if self.plan.n_shards != self.n_shards:
            raise ValueError(f"plan of {self.plan.n_shards} shards on {self.n_shards} ranks")
        dev = self.device
        self.x = torch.as_tensor(np.asarray(x, dtype=np.float32), device=dev)
        y = np.asarray(y)
        self.y = torch.as_tensor(y.astype(np.int64), device=dev)
        self.nclass = int(nclass if nclass is not None else int(y.max()) + 1)
        self.degV = torch.as_tensor(hg.degV, device=dev)
        self.model = model
        self.first_aggr = first_aggr
        plan_, mesh_, fs = self.plan, self.mesh, n_f > 1

        def aggregate(h, aggr, degv):
            return sharded_hgnn_aggregate(plan_, h, None, aggr, degV=degv, mesh=mesh_,
                                          feature_sharded=fs)

        def unignn(h, use_deg, degv):
            return sharded_unignn_aggregate(plan_, h, use_deg=use_deg, degV=degv, mesh=mesh_,
                                            feature_sharded=fs)

        self.forward = make_forward(model, aggregate, unignn, self.degV, first_aggr,
                                    nclass=self.nclass)
        init = params if params is not None else init_dist_params(
            model, seed, self.x.shape[1], nhid, self.nclass, class_pad=n_f)
        self.params = {k: torch.as_tensor(v, dtype=torch.float32).to(dev).clone()
                       .requires_grad_(True) for k, v in init.items()}
        self.optimizer = make_optimizer(list(self.params.values()), lr, wd,
                                        capturable=dev.type == "cuda")
        init_adam_state(self.optimizer)
        self._steps: Dict[int, Captured] = {}  # recorded steps by train_idx length

    @property
    def opt_state(self) -> Dict[str, Dict[str, torch.Tensor]]:
        """Adam's state by parameter name (optax's ``count``, ``mu``, ``nu``)."""
        return {k: self.optimizer.state[p] for k, p in self.params.items()}

    def train_mask(self, train_idx) -> torch.Tensor:
        mask = np.zeros(self.x.shape[0], dtype=np.float32)
        mask[np.asarray(train_idx)] = 1.0
        return torch.as_tensor(mask, device=self.device)

    def loss(self, mask: torch.Tensor) -> torch.Tensor:
        """The masked mean NLL of the current weights (``:69-74``)."""
        nll, cnt = masked_nll_terms(self.forward(self.params, self.x), self.y, mask)
        return nll / cnt.clamp_min(1.0)

    def step(self, mask: torch.Tensor) -> torch.Tensor:
        """One eager step: forward, loss, backward, Adam; the loss before
        the update, on the device."""
        self.optimizer.zero_grad(set_to_none=True)
        loss = self.loss(mask)
        loss.backward()
        self.optimizer.step()
        return loss.detach()

    def _state(self):
        return training_state(self.params.values(), self.optimizer)

    def _captured_step(self, train_idx) -> Captured:
        """The step recorded for ``train_idx``'s length; ``out`` is its
        static (mask, loss)."""
        g = self._steps.get(len(train_idx))
        if g is None:
            mask = self.train_mask(train_idx)
            g = record_step(lambda: (mask, self.step(mask)), self._state, self.optimizer,
                            self.device)
            self._steps[len(train_idx)] = g
        return g

    def fit(self, train_idx, epochs: int = 100, warmup: int = 10) -> Dict[str, object]:
        """``warmup`` untimed steps, then ``epochs`` timed ones
        (``:99-156``), replays of the recorded step or eager steps; each
        loss is copied into a device buffer, read back once, at the end.
        ``capture_s`` is the host time this call spent recording (0 where
        the step was recorded before)."""
        mask = self.train_mask(train_idx)
        capture_s = 0.0
        if self.compiled:
            recorded = len(train_idx) in self._steps
            g = self._captured_step(train_idx)
            if not recorded:
                capture_s = g.build_s
            g.out[0].copy_(mask)

            def one():
                return g.replay()[1]
        else:
            def one():
                return self.step(mask)

        for _ in range(warmup):
            one()
        self.mesh.barrier()
        losses = torch.empty(epochs, dtype=torch.float32, device=self.device)
        with Window(self.device) as window:
            for i in range(epochs):
                losses[i].copy_(one())
        self.mesh.barrier()
        host = losses.cpu().numpy()
        return {
            "train_epoch_time_s": window.seconds / max(epochs, 1),
            "final_loss": float(host[-1]) if host.size else float("nan"),
            "n_shards": self.n_shards,
            "losses": host,
            "timer": window.timer,
            "step": "captured" if self.compiled else "eager",
            "capture_s": capture_s,
        }

    def predict(self) -> torch.Tensor:
        with torch.no_grad():
            return self.forward(self.params, self.x)

    def evaluate(self, split_idx) -> Dict[str, float]:
        z = self.predict().cpu().numpy()
        y = self.y.cpu().numpy()
        return {f"{name}_acc": accuracy(z[np.asarray(idx)], y[np.asarray(idx)])
                for name, idx in split_idx.items() if np.asarray(idx).size}

    def save(self, directory: str, step: int = 0) -> None:
        """Checkpoint the weights and Adam's state: the grid's first rank
        writes (and waits for the write), then a barrier (``:158-166``)."""
        if self.mesh.lead:
            save_checkpoint(directory, step, {k: p.detach() for k, p in self.params.items()},
                            self.opt_state, wait=True)
        self.mesh.barrier()

    def restore(self, directory: str, step: Optional[int] = None) -> int:
        """Every rank reads the latest (or the given) step into its tensors,
        in place (``:168-191``)."""
        self.mesh.barrier()
        step, params, opt_state = restore_checkpoint(
            directory, {k: p.detach() for k, p in self.params.items()}, self.opt_state,
            step=step)
        _copy_into({k: p.detach() for k, p in self.params.items()}, params, "params")
        _copy_into(self.opt_state, opt_state, "opt_state")
        return step
