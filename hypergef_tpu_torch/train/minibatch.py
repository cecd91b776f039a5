"""Minibatch training over hyperedge-sampled subgraphs.

Port of ``hypergef_tpu/train/minibatch.py`` (``:23-177``). Each step trains
on one padded batch of :class:`~hypergef_tpu_torch.data.sampling.HyperedgeSampler`
on the ``cumsum`` route, which needs no plan: the batch's own segment tables
(built on the host with the batch) drive the segment-sum kernel forward and
backward (the adjoint is the same kernel over the transposed CSR). Every
batch of a run pads to one probed shape, doubled where a batch overflows
it (``:105-130``).

JAX jits the step once a pad shape (``:93``); on the card the port records
it into a CUDA graph once a pad shape (``compiled=None``,
:mod:`hypergef_tpu_torch.utils.graphs`) and replays it for every batch of
that shape. Each batch is copied into its shape's tensors
(:class:`~hypergef_tpu_torch.sparse.hypergraph.StaticTables`: the CSRs, their
int32 copies, degrees, rows and row mask, and warp runs padded to the
most the shape can need, :func:`~hypergef_tpu_torch.ops.segment_sum.max_warp_runs`),
and the step reads only those, eager or recorded.
:attr:`MinibatchTrainer.compile_count` is JAX's jit cache size: the
recordings, or the distinct shapes of an eager run. Max first aggregation
has no plan-free route in the port (JAX falls back to its nnz oracle
there), so ``first_aggr="max"`` raises ``ValueError``.
"""

from __future__ import annotations

import time
from typing import Any, Dict, Mapping, Optional

import numpy as np
import torch

from hypergef_tpu_torch.data.sampling import HyperedgeBatch, HyperedgeSampler
from hypergef_tpu_torch.models.zoo import build_model
from hypergef_tpu_torch.sparse.hypergraph import StaticTables
from hypergef_tpu_torch.train.splits import accuracy
from hypergef_tpu_torch.train.trainer import (
    TrainConfig, init_adam_state, make_optimizer, record_step, training_state,
)
from hypergef_tpu_torch.utils.graphs import Captured


class MinibatchTrainer:
    """The model, its optimizer and a sampler of ``batch_edges`` hyperedges
    a step, on ``device`` (the card unless ``device="cpu"``; without a card
    the default raises). ``params`` is a ``state_dict`` (e.g. from
    ``params_from_flax``); without it the weights are drawn from
    ``cfg.seed``. The sampler draws JAX's batches for ``sampler_seed``: the
    probe of the pad shapes and the one batch JAX draws to initialise its
    parameters are drawn here too.

    ``compiled`` as the full-batch ``Trainer``'s: None records the step on
    a CUDA device, once a pad shape at its first batch (a warm-up on a
    snapshot that is put back, the dropout generator registered), and runs
    it eagerly on the CPU; False runs it eagerly; True on the CPU raises.
    The recordings share one memory pool: one replays at a time."""

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
        fixed_shapes: bool = True,
        *,
        device="cuda",
        params: Optional[Mapping[str, Any]] = None,
        compiled: Optional[bool] = None,
    ):
        if cfg.first_aggr == "max":
            raise ValueError(
                "first_aggr='max' has no plan-free route in this package (the minibatch "
                "steps run cumsum, which sums): train max full-batch with a plan")
        if compiled and torch.device(device).type != "cuda":
            raise ValueError(
                f"compiled=True needs a CUDA device (a CUDA graph records the card's "
                f"kernels); on {device} the minibatch steps run eagerly")
        self.cfg = cfg
        self.hg = hg
        self.sampler = HyperedgeSampler(hg, batch_edges, seed=sampler_seed, device=device)
        self.device = self.sampler.device
        self.compiled = self.device.type == "cuda" if compiled is None else bool(compiled)
        x = np.asarray(x, dtype=np.float32)
        self.y = np.asarray(y, dtype=np.int32)
        self.nclass = int(nclass if nclass is not None else self.y.max() + 1)
        self.train_mask_global = np.zeros(hg.num_nodes, dtype=np.float32)
        self.train_mask_global[np.asarray(train_idx)] = 1.0
        self.x = torch.as_tensor(x, device=self.device)
        self._y = torch.as_tensor(self.y, dtype=torch.int64, device=self.device)
        self._train_mask = torch.as_tensor(self.train_mask_global, device=self.device)
        self.model = build_model(
            cfg.model, nfeat=x.shape[1], nhid=cfg.nhid, nclass=self.nclass,
            num_edges=hg.num_edges, nlayer=cfg.nlayer, first_aggr=cfg.first_aggr,
            nhead=cfg.nhead, dropout=cfg.dropout, input_drop=cfg.input_drop,
            activation=cfg.activation, backend="cumsum",  # plan-free: any padded batch
            seed=cfg.seed, device=self.device,
        )
        if params is not None:
            self.model.load_state_dict({k: torch.as_tensor(v) for k, v in params.items()})
        # every batch of the run pads to one (n, e, nnz) triple
        self.pad_shapes = self.sampler.probe_pad_shapes() if fixed_shapes else None
        # JAX draws one batch to initialise its parameters (:74-79): the
        # same draw keeps the two samplers' streams together
        self.sampler.sample_batch(pad_to=self.pad_shapes)
        self.optimizer = make_optimizer(self.model.parameters(), cfg.lr, cfg.wd,
                                        capturable=self.device.type == "cuda")
        init_adam_state(self.optimizer)
        self.generator = torch.Generator(device=self.device)
        self.tables: Dict[tuple, StaticTables] = {}  # each pad shape's batch tensors
        self._steps: Dict[tuple, Captured] = {}  # each pad shape's recording
        self._pool = None  # the recordings' shared memory pool

    @property
    def compile_count(self) -> int:
        """JAX's jit cache size: the recordings on the card, the distinct
        pad shapes the steps ran at when eager."""
        return len(self._steps) if self.compiled else len(self.tables)

    def _state(self):
        return training_state(self.model.state_dict().values(), self.optimizer)

    def batch_inputs(self, tables: StaticTables):
        """(xb, yb, mask) of the batch in ``tables``, on the device: its
        rows' features and labels, and the train mask of its real rows,
        gathered on the device from the batch's ``rows``."""
        ids = tables.tensors["rows"]
        return (self.x.index_select(0, ids), self._y.index_select(0, ids),
                tables.tensors["row_mask"] * self._train_mask.index_select(0, ids))

    def _train_step(self, tables: StaticTables) -> torch.Tensor:
        """Forward, masked nll (``-Σ(picked·mask) / max(Σmask, 1)``,
        ``:86-91``), backward, Adam over the batch in ``tables``: what an
        eager step runs and a graph records. The loss before the update."""
        self.model.train()
        self.optimizer.zero_grad(set_to_none=True)
        xb, yb, mask = self.batch_inputs(tables)
        z = self.model(xb, tables.data, None, generator=self.generator)
        picked = z.gather(1, yb[:, None])[:, 0]
        loss = -(picked * mask).sum() / mask.sum().clamp_min(1.0)
        loss.backward()
        self.optimizer.step()
        return loss.detach()

    def _captured_step(self, shape: tuple) -> Captured:
        """The step recorded over ``shape``'s tables, which hold the batch
        it is first called for (its warm-up's batch)."""
        g = self._steps.get(shape)
        if g is None:
            tables = self.tables[shape]
            if self._pool is None:
                self._pool = torch.cuda.graph_pool_handle()
            g = record_step(lambda: self._train_step(tables), self._state, self.optimizer,
                            self.device, self.generator, pool=self._pool)
            self._steps[shape] = g
        return g

    def step(self, batch: HyperedgeBatch) -> torch.Tensor:
        """One step on ``batch``: copied into its pad shape's tables, then
        the eager step or a replay of the shape's recording (made at the
        shape's first batch). The loss before the update, on the device; a
        replay's is a copy the next step leaves alone."""
        shape = batch.pad_shape
        tables = self.tables.get(shape)
        if tables is None:
            tables = self.tables[shape] = StaticTables(*shape, self.device)
        batch.write(tables)
        if not self.compiled:
            return self._train_step(tables)
        g = self._captured_step(shape)
        return g.replay().clone()

    def epoch_batches(self):
        """One epoch of batches at the fixed pad shapes; a batch overflowing
        them doubles the offending dimension (``:105-130``)."""
        if self.pad_shapes is None:
            yield from self.sampler.epoch()
            return
        order = self.sampler.rng.permutation(self.hg.num_edges)
        bs = self.sampler.batch_edges
        for i in range(0, len(order), bs):
            chunk = order[i : i + bs]
            if len(chunk) < bs and self.sampler.drop_last and i > 0:
                return
            while True:
                try:
                    yield self.sampler.induce(np.sort(chunk), pad_to=self.pad_shapes)
                    break
                except ValueError:
                    n, e, z = self.pad_shapes
                    b = self.sampler.induce(np.sort(chunk))
                    self.pad_shapes = (max(n, b.pad_shape[0]), max(e, b.pad_shape[1]),
                                       max(z, b.pad_shape[2]))

    def fit(self, epochs: int = 1) -> Dict[str, Any]:
        """``epochs`` passes over the hyperedges, a step a batch; the losses
        are read back once, at the end (JAX's keys; ``losses`` holds them
        all). ``step`` says whether the steps ran ``"captured"`` or
        ``"eager"``; ``capture_s`` is the host time this call spent
        recording (warm-ups included), ``recorded`` the recordings it made."""
        self.generator.manual_seed(self.cfg.seed + 1)
        recorded = set(self._steps)
        losses = []
        t0 = time.perf_counter()
        for _ in range(epochs):
            for batch in self.epoch_batches():
                losses.append(self.step(batch))
        host = torch.stack(losses).cpu().numpy() if losses else np.zeros(0, np.float32)
        dt = time.perf_counter() - t0
        new = [g for shape, g in self._steps.items() if shape not in recorded]
        return {
            "final_loss": float(host[-1]) if host.size else float("nan"),
            "mean_loss": float(np.mean(host[-10:])) if host.size else float("nan"),
            "batches": len(losses),
            "time_s": dt,
            "losses": host,
            "step": "captured" if self.compiled else "eager",
            "capture_s": sum(g.build_s for g in new),
            "recorded": len(new),
        }

    def evaluate_full(self, split_idx, plan=None) -> Dict[str, float]:
        """Full-graph evaluation with the trained weights (``:158-177``)."""
        hgd = self.hg.device_data(self.device)
        self.model.eval()
        with torch.no_grad():
            z = self.model(self.x, hgd, plan).cpu().numpy()
        out = {}
        for name, idx in split_idx.items():
            idx = np.asarray(idx)
            if idx.size:
                out[f"{name}_acc"] = accuracy(z[idx], self.y[idx])
        return out
