"""Data-parallel minibatch training: one sampled batch a rank a step.

Port of ``hypergef_tpu/train/dp_minibatch.py`` (``:1-196``). JAX stacks D
batches on a leading axis, ``vmap``s the model over it and lets GSPMD
insert the gradient reduction; the port runs one rank a batch:

* every rank holds the same sampler (the same seed), draws the step's D
  hyperedge sets in JAX's order and builds only its own batch (``:135-140``),
  all at JAX's shared pad shape (``HyperedgeSampler.probe_pad_shapes``);
* each rank's step is the ``cumsum`` step of
  :mod:`~hypergef_tpu_torch.train.minibatch` (the segment-sum kernel
  forward and backward on the card), over its pad shape's tables
  (:class:`~hypergef_tpu_torch.sparse.hypergraph.StaticTables`); on an nccl rank
  it is recorded into a CUDA graph with its collectives (JAX jits it,
  ``:126``), on gloo it runs eagerly (``compiled`` below);
* the loss is JAX's global masked mean NLL over every rank's batch
  (``:112-126``): each rank's NLL sum is divided by the count summed over
  the ranks, backpropagated, and the parameters' gradients are summed over
  the ranks in a fixed order before Adam, which then steps alike on every
  rank. The reported loss is the sum of the ranks' shares.

JAX's ``stack_batches`` (``:46-55``) has no counterpart: a rank holds one
batch, so nothing is stacked.
"""

from __future__ import annotations

import time
from typing import Any, Dict, Mapping, Optional

import numpy as np
import torch

from hypergef_tpu_torch.data.sampling import HyperedgeBatch, HyperedgeSampler
from hypergef_tpu_torch.models.zoo import build_model
from hypergef_tpu_torch.parallel.comm import all_reduce_, all_reduce_grads
from hypergef_tpu_torch.parallel.mesh import Mesh, compiled_for, make_mesh
from hypergef_tpu_torch.sparse.hypergraph import StaticTables
from hypergef_tpu_torch.train.splits import accuracy
from hypergef_tpu_torch.train.trainer import (
    TrainConfig, init_adam_state, make_optimizer, record_step, training_state,
)
from hypergef_tpu_torch.utils.graphs import Captured


class DPMinibatchTrainer:
    """Minibatch training with one sampled batch a rank (``:58-196``). Every
    rank of the world builds one, with the same arguments; ``params`` is a
    ``state_dict`` (e.g. ``models.convert.params_from_flax``), else the
    weights are drawn from ``cfg.seed``.

    ``compiled``: None records the step, its ``all_reduce`` calls inside,
    on an nccl rank (at the first step: a warm-up on a snapshot that is put
    back, whose collectives also set up the communicator) and runs it
    eagerly on gloo, whose collectives copy through the host; False runs
    it eagerly; True on gloo or the CPU raises, naming nccl."""

    def __init__(
        self,
        cfg: TrainConfig,
        hg,
        x,
        y,
        train_idx,
        batch_edges: int = 64,
        nclass: Optional[int] = None,
        sampler_seed: int = 0,
        mesh: Optional[Mesh] = None,
        *,
        params: Optional[Mapping[str, Any]] = None,
        compiled: Optional[bool] = None,
    ):
        if cfg.first_aggr == "max":
            raise ValueError(
                "first_aggr='max' has no plan-free route in this package (the minibatch "
                "steps run cumsum, which sums): train max full-batch with a plan")
        self.cfg = cfg
        self.hg = hg
        self.mesh = mesh or make_mesh()
        self.device = self.mesh.device
        self.n_dev = self.mesh.size
        self.compiled = compiled_for(self.mesh, compiled, "DPMinibatchTrainer")
        x = np.asarray(x, dtype=np.float32)
        self.y = np.asarray(y, dtype=np.int32)
        self.nclass = int(nclass if nclass is not None else self.y.max() + 1)
        self.train_mask_global = np.zeros(hg.num_nodes, dtype=np.float32)
        self.train_mask_global[np.asarray(train_idx)] = 1.0
        self.x = torch.as_tensor(x, device=self.device)
        self._y = torch.as_tensor(self.y, dtype=torch.int64, device=self.device)
        self._train_mask = torch.as_tensor(self.train_mask_global, device=self.device)
        self.sampler = HyperedgeSampler(hg, batch_edges, seed=sampler_seed, device=self.device)
        self.pad_to = self.sampler.probe_pad_shapes()
        self.model = build_model(
            cfg.model, nfeat=x.shape[1], nhid=cfg.nhid, nclass=self.nclass,
            num_edges=hg.num_edges, nlayer=cfg.nlayer, first_aggr=cfg.first_aggr,
            nhead=cfg.nhead, dropout=cfg.dropout, input_drop=cfg.input_drop,
            activation=cfg.activation, backend="cumsum", seed=cfg.seed, device=self.device)
        if params is not None:
            self.model.load_state_dict({k: torch.as_tensor(v) for k, v in params.items()})
        # JAX draws one batch to initialise its parameters (:74-79)
        self.sampler.sample_batch(pad_to=self.pad_to)
        self.optimizer = make_optimizer(self.model.parameters(), cfg.lr, cfg.wd,
                                        capturable=self.device.type == "cuda")
        init_adam_state(self.optimizer)
        # a stream of dropout masks of its own a rank
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(cfg.seed + 1 + 7919 * self.mesh.rank)
        self.tables = StaticTables(*self.pad_to, self.device)
        self._step: Optional[Captured] = None

    def draw(self) -> HyperedgeBatch:
        """The step's D hyperedge sets, drawn in JAX's order; this rank's
        batch built (``:135-140``)."""
        hg, s = self.hg, self.sampler
        mine = None
        for r in range(self.n_dev):
            edges = np.sort(s.rng.choice(hg.num_edges, size=min(s.batch_edges, hg.num_edges),
                                         replace=False, p=s._probs))
            if r == self.mesh.rank:
                mine = edges
        return s.induce(mine, pad_to=self.pad_to)

    def _state(self):
        return training_state(self.model.state_dict().values(), self.optimizer)

    def _train_step(self) -> torch.Tensor:
        """One data-parallel step on the batch in the tables: what an eager
        step runs and a graph records. The global loss."""
        self.model.train()
        self.optimizer.zero_grad(set_to_none=True)
        t = self.tables.tensors
        ids = t["rows"]
        xb, yb = self.x.index_select(0, ids), self._y.index_select(0, ids)
        mask = t["row_mask"] * self._train_mask.index_select(0, ids)
        z = self.model(xb, self.tables.data, None, generator=self.generator)
        picked = z.gather(1, yb[:, None])[:, 0]
        count = all_reduce_(mask.sum().detach().clone(), self.mesh.group).clamp_min(1.0)
        share = -(picked * mask).sum() / count
        share.backward()
        all_reduce_grads(self.model.parameters(), self.mesh.group)
        self.optimizer.step()
        return all_reduce_(share.detach().clone(), self.mesh.group)

    def step(self, batch: HyperedgeBatch) -> torch.Tensor:
        """One data-parallel step on this rank's batch (copied into the
        tables first); the global loss, on the device. Recorded, the first
        call records the step and each call replays it; the loss returned is
        a copy the next step leaves alone."""
        batch.write(self.tables)
        if not self.compiled:
            return self._train_step()
        if self._step is None:
            self._step = record_step(self._train_step, self._state, self.optimizer,
                                     self.device, self.generator)
        return self._step.replay().clone()

    def step_once(self) -> torch.Tensor:
        return self.step(self.draw())

    def fit(self, steps: int = 10) -> Dict[str, Any]:
        """``steps`` steps; the losses are read back once, at the end
        (JAX's keys, ``:142-156``)."""
        losses = []
        t0 = time.perf_counter()
        for _ in range(steps):
            losses.append(self.step_once())
        host = torch.stack(losses).cpu().numpy() if losses else np.zeros(0, np.float32)
        return {
            "final_loss": float(host[-1]) if host.size else float("nan"),
            "mean_loss": float(np.mean(host[-10:])) if host.size else float("nan"),
            "steps": steps,
            "devices": self.n_dev,
            "time_s": time.perf_counter() - t0,
            "losses": host,
            "step": "captured" if self.compiled else "eager",
        }

    def evaluate_full(self, split_idx, plan=None) -> Dict[str, float]:
        """Full-graph evaluation with the trained weights (``:158-196``)."""
        hgd = self.hg.device_data(self.device)
        self.model.eval()
        with torch.no_grad():
            z = self.model(self.x, hgd, plan).cpu().numpy()
        return {f"{name}_acc": accuracy(z[np.asarray(idx)], self.y[np.asarray(idx)])
                for name, idx in split_idx.items() if np.asarray(idx).size}
