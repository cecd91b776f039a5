"""Full-batch training with the reference's protocol.

Port of ``hypergef_tpu/train/trainer.py``: :class:`TrainConfig`
(``:32-64``), :func:`make_optimizer` (``:67-74``), :class:`Trainer`
(``:77-328``) and :func:`train_full_batch` (``:331-338``).
The protocol is ``HyperGsys/hgsys.py:146-211``'s: Adam(lr=0.01,
weight-decay 5e-4, L2 added to the gradient), ``nll_loss`` on the train
split, ``warmup`` untimed epochs then ``epochs`` timed ones, a separate
timed inference loop, accuracy on each split.

A step is the model's forward, the loss, the backward and the optimizer
step. JAX jits it (``:150-158``) and the forward (``:160-167``); on the
card the Trainer records each into a CUDA graph once and replays it
(:mod:`hypergef_tpu_torch.utils.graphs`, ``compiled=None``), and on the CPU,
or with ``compiled=False``, it runs them eagerly. Times come from
:class:`~hypergef_tpu_torch.utils.timing.Window`: CUDA events around the
loop on a card (host time included), the host clock on the CPU; each
result names its ``timer``. :meth:`Trainer.epoch_device_time_stats` is
JAX's differenced window (``:199-290``) over replays of the captured step.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, Iterable, List, Mapping, Optional

import numpy as np
import torch
from torch.nn import functional as F

from hypergef_tpu_torch.models.zoo import build_model
from hypergef_tpu_torch.ops import fused
from hypergef_tpu_torch.ops.bitstream import BitIncidence
from hypergef_tpu_torch.sparse.bsr import BsrPlan, plan_bsr
from hypergef_tpu_torch.sparse.planner import (
    AggregationPlan, DensePrecomp, TilePlan, TreePlan, plan_aggregation, plan_aligned,
    plan_multihot, plan_tree,
)
from hypergef_tpu_torch.train.checkpoint import restore_checkpoint, save_checkpoint
from hypergef_tpu_torch.train.splits import accuracy
from hypergef_tpu_torch.utils.graphs import Captured
from hypergef_tpu_torch.utils.timing import Window, differenced_windows

# Eager steps a captured step's recording is preceded by (on a snapshot of
# the training state, which is then put back): they build what a first
# call builds lazily (tables, cuBLAS's handle), which a graph cannot.
CAPTURE_WARMUP = 1


@dataclasses.dataclass
class TrainConfig:
    """The reference's argparse knobs (``hgsys.py:22-70``) plus route
    options. ``model`` is HGNN, UniGIN or UniGCNII. ``backend="auto"`` (the
    default) trains on the route the ladder picks
    (:func:`~hypergef_tpu_torch.sparse.planner.plan_aggregation`); ``None``
    takes the process-global default route (``cumsum``). ``tune`` plans by
    measurement (:mod:`~hypergef_tpu_torch.sparse.autotune`) and
    ``plan_cache`` (a directory, ``""`` for the default one) keeps the plan
    on disk (:mod:`~hypergef_tpu_torch.sparse.plancache`):
    :func:`trainer_plan`."""

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


def make_optimizer(params, lr: float, wd: float, capturable: bool = False) -> torch.optim.Adam:
    """Adam with L2 added to the gradient before the moments, which is
    what ``optax.add_decayed_weights(wd)`` then ``scale_by_adam()`` do
    (betas 0.9/0.999, eps 1e-8); not the decoupled AdamW. ``capturable``
    keeps the step count and the bias corrections on the card, so that a
    CUDA graph can hold the update; the Trainer sets it on the card for
    captured and eager steps alike, so both do the same arithmetic."""
    return torch.optim.Adam(params, lr=lr, betas=(0.9, 0.999), eps=1e-8, weight_decay=wd,
                            capturable=capturable)


def init_adam_state(optimizer: torch.optim.Adam) -> None:
    """Adam's state (``step``, ``exp_avg``, ``exp_avg_sq``) for every
    parameter, as its first step would make it, so no step allocates it:
    JAX's ``tx.init`` in ``Trainer.__init__`` (``:121-122``)."""
    for group in optimizer.param_groups:
        for p in group["params"]:
            state = optimizer.state[p]
            if state:
                continue
            state["step"] = (torch.zeros((), dtype=torch.float32, device=p.device)
                             if group["capturable"] else torch.tensor(0.0))
            state["exp_avg"] = torch.zeros_like(p, memory_format=torch.preserve_format)
            state["exp_avg_sq"] = torch.zeros_like(p, memory_format=torch.preserve_format)


def _copy_into(dst: Mapping, src: Mapping, what: str) -> None:
    """Copy the tensors of ``src`` into those of ``dst`` (nested dicts of
    the same keys), in place."""
    if set(dst) != set(src):
        raise ValueError(f"{what}: keys {sorted(src)} != {sorted(dst)}")
    with torch.no_grad():
        for k, t in dst.items():
            if isinstance(t, Mapping):
                _copy_into(t, src[k], f"{what}[{k!r}]")
            else:
                t.copy_(torch.as_tensor(src[k]))


def training_state(tensors: Iterable[torch.Tensor],
                   optimizer: torch.optim.Optimizer) -> List[torch.Tensor]:
    """The training state's tensors: ``tensors`` (a model's ``state_dict``
    values, or its parameters), then Adam's state of each parameter in
    the optimizer's order."""
    out = list(tensors)
    for group in optimizer.param_groups:
        for p in group["params"]:
            st = optimizer.state[p]
            out += [st["step"], st["exp_avg"], st["exp_avg_sq"]]
    return out


def snapshot_state(tensors: List[torch.Tensor], generator: Optional[torch.Generator] = None):
    """Copies of the training state's ``tensors`` and ``generator``'s state
    (None without one), for :func:`put_back_state`."""
    return ([t.detach().clone() for t in tensors],
            None if generator is None else generator.get_state())


def put_back_state(tensors: List[torch.Tensor], snapshot,
                   generator: Optional[torch.Generator] = None) -> None:
    """Copy a :func:`snapshot_state` back into the same tensors, in place
    (a recorded step keeps reading them), and the generator's state."""
    saved, gen = snapshot
    with torch.no_grad():
        for t, v in zip(tensors, saved):
            t.copy_(v)
    if generator is not None:
        generator.set_state(gen)


def record_step(body: Callable[[], Any], state: Callable[[], List[torch.Tensor]],
                optimizer: torch.optim.Optimizer, device,
                generator: Optional[torch.Generator] = None, pool=None) -> Captured:
    """``body`` (a training step: zero the gradients, forward, backward,
    the optimizer's step) recorded into a CUDA graph, its ``out`` what
    ``body`` returns. Its warm-up runs ``CAPTURE_WARMUP`` eager steps on a
    snapshot of ``state()`` (the training state's tensors) and
    ``generator``, puts them back and drops the gradients, so the
    recording allocates them in its own pool (``pool``: shared with other
    recordings, :class:`~hypergef_tpu_torch.utils.graphs.Captured`).
    ``build_s`` is the host seconds it took, warm-up included."""
    t0 = time.perf_counter()

    def warmup():
        snapshot = snapshot_state(state(), generator)
        for _ in range(CAPTURE_WARMUP):
            body()
        put_back_state(state(), snapshot, generator)
        optimizer.zero_grad(set_to_none=True)

    g = Captured(body, device, generator, warmup, pool=pool)
    g.build_s = time.perf_counter() - t0
    return g


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
    with the tree for max. ``ell`` gets the ladder's plan with the ELL tables
    (``with_tile=True``, as JAX's Trainer builds it, ``:89-99``); ``bsr``
    and ``multihot`` the tree and their own plan (``plan_bsr(hg,
    reorder=True)``, ``plan_multihot(hg)``), as JAX's autotune builds them
    (``autotune.py:136-147``): JAX's Trainer passes the ladder's plan, which
    holds no BSR plan and, off the ``tree`` rung, no multihot plan."""
    if backend == "xla":
        return None
    if backend == "cumsum":
        return AggregationPlan(tree=plan_tree(hg)) if first_aggr == "max" else None
    if backend in (None, "auto", "precomp"):
        return plan_aggregation(hg, device)
    if backend == "ell":
        return plan_aggregation(hg, device, with_tile=True)
    if backend == "bsr":
        return AggregationPlan(tree=plan_tree(hg), bsr=plan_bsr(hg, reorder=True))
    if backend == "multihot":
        return AggregationPlan(tree=plan_tree(hg), multihot=plan_multihot(hg))
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
    fused.resolve_backend(backend, None)  # raises for an unknown route
    raise AssertionError(backend)


def trainer_plan(cfg: "TrainConfig", hg, device):
    """The plan a Trainer builds when it is given none (JAX's ``:82-99``).
    With ``cfg.tune`` it is the measured one
    (:func:`~hypergef_tpu_torch.sparse.autotune.autotune_plan` at the hidden
    width, which the aggregations of every layer but the first run at).
    With ``cfg.plan_cache`` set (``""``: the default directory) and a route
    other than ``xla`` and ``cumsum``, the ladder's plan comes from the plan
    cache (:func:`~hypergef_tpu_torch.sparse.plancache.cached_plan_aggregation`)
    for the routes that read it (``auto``, None, ``precomp``), and any other
    route's :func:`default_plan` from the same cache under a key naming the
    route. Else it is :func:`default_plan`."""
    if cfg.tune:
        from hypergef_tpu_torch.sparse.autotune import autotune_plan

        return autotune_plan(hg, feature_size=cfg.nhid, device=device)
    if cfg.plan_cache is not None and cfg.backend not in ("xla", "cumsum"):
        from hypergef_tpu_torch.sparse import plancache

        cache_dir = cfg.plan_cache or None
        if cfg.backend in (None, "auto", "precomp"):
            return plancache.cached_plan_aggregation(hg, cache_dir=cache_dir, device=device)
        return plancache.cached_plan(
            hg, lambda: default_plan(cfg.backend, hg, device, cfg.first_aggr),
            cache_dir=cache_dir, device=device, route=cfg.backend, first_aggr=cfg.first_aggr)
    return default_plan(cfg.backend, hg, device, cfg.first_aggr)


def device_plans(plan):
    """The stage plans, ELL and block tables, bit packs and propagation
    matrix of ``plan``, whose tables go to the device when a Trainer or a
    server is built, not inside its first step."""
    if isinstance(plan, (TreePlan, TilePlan, BsrPlan, BitIncidence, DensePrecomp)):
        return [plan]
    fields = ("tree", "tile", "bsr", "multihot", "pallas_sparse", "aligned", "bitstream",
              "precomp")
    return [p for p in (getattr(plan, f, None) for f in fields) if p is not None]


class Trainer:
    """A model, its optimizer and its graph on one device.

    ``device`` is the card unless the caller asks for the CPU
    (``device="cpu"``); without a card the default raises. ``params`` is a
    ``state_dict`` (for instance from
    :func:`hypergef_tpu_torch.models.convert.params_from_flax`); without it
    the weights are drawn from ``cfg.seed``. ``opt_state`` is Adam's state
    by parameter name (:attr:`opt_state`, or
    :func:`~hypergef_tpu_torch.models.convert.opt_state_from_optax`);
    without it Adam starts from zero. Dropout masks come from a
    ``torch.Generator`` on ``device``, seeded from ``cfg.seed`` at each
    :meth:`fit`, as the JAX trainer re-keys its dropout there.

    ``compiled`` is the counterpart of ``jax.disable_jit``: None records
    the step and the forward into CUDA graphs on a CUDA device and runs
    them eagerly on the CPU; False runs them eagerly; True on the CPU
    raises. A captured step is recorded at its first call for each length
    of ``train_idx`` and leaves the training state as it was: its warm-up
    runs on a snapshot that is put back. Parameters and optimizer state
    are only ever updated in place, so the graphs always read the live
    values.
    """

    def __init__(self, cfg: TrainConfig, hg, x, y, nclass: Optional[int] = None, plan=None,
                 *, device="cuda", params: Optional[Mapping[str, Any]] = None,
                 opt_state: Optional[Mapping[str, Mapping[str, Any]]] = None,
                 compiled: Optional[bool] = None):
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: the Trainer runs on the card unless it is given "
                "device='cpu'")
        if compiled and self.device.type != "cuda":
            raise ValueError(
                f"compiled=True needs a CUDA device (a CUDA graph records the card's "
                f"kernels); on {self.device} the Trainer runs eagerly")
        self.cfg = cfg
        self.hg = hg
        self.compiled = self.device.type == "cuda" if compiled is None else bool(compiled)
        if plan is None:
            plan = trainer_plan(cfg, hg, self.device)
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
        self.optimizer = make_optimizer(self.model.parameters(), cfg.lr, cfg.wd,
                                        capturable=self.device.type == "cuda")
        init_adam_state(self.optimizer)
        if opt_state is not None:
            _copy_into(self.opt_state, opt_state, "opt_state")
        self.generator = torch.Generator(device=self.device)
        self._steps: Dict[int, Captured] = {}  # captured steps by train_idx length
        self._forward: Optional[Captured] = None

    @property
    def opt_state(self) -> Dict[str, Dict[str, torch.Tensor]]:
        """Adam's live state by parameter name: ``step``, ``exp_avg``,
        ``exp_avg_sq`` (optax's ``count``, ``mu``, ``nu``)."""
        return {name: self.optimizer.state[p] for name, p in self.model.named_parameters()}

    def _state(self) -> List[torch.Tensor]:
        """The training state's tensors: parameters, then Adam's state."""
        return training_state(self.model.state_dict().values(), self.optimizer)

    def _snapshot(self):
        return snapshot_state(self._state(), self.generator)

    def _put_back(self, snapshot) -> None:
        put_back_state(self._state(), snapshot, self.generator)

    def _index(self, idx) -> torch.Tensor:
        return torch.as_tensor(np.asarray(idx), dtype=torch.int64, device=self.device)

    def _train_step(self, train_idx: torch.Tensor) -> torch.Tensor:
        """Forward, nll over ``train_idx``, backward, Adam: what an eager
        step runs and a graph records. Returns the loss before the update."""
        self.model.train()
        self.optimizer.zero_grad(set_to_none=True)
        z = self.model(self.x, self.hgd, self.plan, generator=self.generator)
        loss = F.nll_loss(z.index_select(0, train_idx), self.y.index_select(0, train_idx))
        loss.backward()
        self.optimizer.step()
        return loss.detach()

    def _captured_step(self, train_idx: torch.Tensor) -> Captured:
        """The step recorded for ``train_idx``'s length; ``out`` is its
        static (index buffer, loss). The recording's warm-up runs on a
        snapshot of the parameters, Adam's state and the generator, which
        is put back before the graph is recorded."""
        g = self._steps.get(len(train_idx))
        if g is None:
            idx = train_idx.clone()
            g = record_step(lambda: (idx, self._train_step(idx)), self._state, self.optimizer,
                            self.device, self.generator)
            self._steps[len(train_idx)] = g
        return g

    def step(self, train_idx: torch.Tensor) -> torch.Tensor:
        """One training epoch: forward, nll over ``train_idx``, backward,
        Adam. Returns the loss before the update, on the device. Captured,
        ``train_idx`` is copied into the graph's buffer and the graph
        replayed; the loss returned is a copy the next step leaves alone."""
        if not self.compiled:
            return self._train_step(train_idx)
        g = self._captured_step(train_idx)
        idx, loss = g.out
        idx.copy_(train_idx)
        g.replay()
        return loss.clone()

    def fit(self, train_idx, epochs: Optional[int] = None,
            warmup: Optional[int] = None) -> Dict[str, Any]:
        """Warm-up + timed training epochs (protocol of hgsys.py:162-195).

        ``losses`` holds each timed epoch's loss, copied into a device
        buffer as the epochs run and read back once, after the timed window.
        ``step`` says whether the step ran ``"captured"`` or ``"eager"``;
        ``capture_s`` is the host time this call spent recording it (its
        warm-up of ``capture_warmup`` eager steps included; 0 where it was
        recorded before)."""
        cfg = self.cfg
        epochs = cfg.epochs if epochs is None else epochs
        warmup = cfg.warmup if warmup is None else warmup
        train_idx = self._index(train_idx)
        self.generator.manual_seed(cfg.seed + 1)
        capture_s, capture_warmup = 0.0, 0
        if self.compiled:
            recorded = len(train_idx) in self._steps
            g = self._captured_step(train_idx)
            if not recorded:
                capture_s, capture_warmup = g.build_s, CAPTURE_WARMUP
            idx, loss = g.out
            idx.copy_(train_idx)

            def one():
                g.replay()
                return loss
        else:
            def one():
                return self._train_step(train_idx)

        last = torch.zeros(())
        for _ in range(warmup):
            last = one()
        losses = torch.empty(epochs, dtype=torch.float32, device=self.device)
        with Window(self.device) as window:
            for i in range(epochs):
                losses[i].copy_(one())
        if epochs:
            last = losses[-1]
        return {
            "train_epoch_time_s": window.seconds / max(epochs, 1),
            "timer": window.timer,
            "step": "captured" if self.compiled else "eager",
            "capture_s": capture_s,
            "capture_warmup": capture_warmup,
            "final_loss": float(last),
            "losses": losses.cpu().numpy(),
            "epochs": epochs,
        }

    def epoch_device_time(self, train_idx, iters: int = 50) -> float:
        """Device time per training epoch (``:199-204``): one differenced
        window of ``iters`` chained steps. Parameters, Adam's state and the
        generator are left as they were."""
        return self._epoch_windows(train_idx, iters, windows=1, repeats=5)[0]

    def epoch_device_time_stats(
        self, train_idx, iters: int = 50, windows: int = 5, repeats: int = 3,
        min_window_s: float = 0.0,
    ) -> Dict[str, Any]:
        """Per-epoch time over ``windows`` differenced windows: median and
        spread, with JAX's keys (``:206-238``) and ``timer``. With
        ``min_window_s`` a pilot window estimates the epoch, and ``iters``
        is widened until a window holds at least ``min_window_s`` (the
        min-window rule, ``:223-226``).

        On the card each window times replays of the captured step (of the
        eager step with ``compiled=False``) behind a queued sleep
        (:func:`~hypergef_tpu_torch.utils.timing.differenced_windows`):
        the step's own graph replayed ``iters + 1`` times, not one graph of
        chained steps, so what is timed is the step a user's ``fit`` runs,
        one recording serves every ``iters``, and no pool holds ``iters``
        steps' intermediates. Replays enqueue in microseconds, so the window
        holds the card's work alone; an eager step's window holds the host
        wherever enqueuing outruns the sleep. Like JAX's, every run starts
        from the trainer's state, which is left as it was."""
        if min_window_s > 0:
            pilot = self._epoch_windows(train_idx, iters, 1, repeats)[0]
            if pilot > 0 and pilot * iters < min_window_s:
                iters = int(np.ceil(min_window_s / pilot))
        samples = self._epoch_windows(train_idx, iters, windows, repeats)
        arr = sorted(samples)
        n = len(arr)
        med = arr[n // 2] if n % 2 else 0.5 * (arr[n // 2 - 1] + arr[n // 2])
        return {
            "median_s": med,
            "min_s": arr[0],
            "max_s": arr[-1],
            "windows": n,
            "iters": iters,
            "samples_s": samples,
            "timer": "cuda_events" if self.device.type == "cuda" else "host_clock",
        }

    def _epoch_windows(self, train_idx, iters, windows, repeats) -> List[float]:
        train_idx = self._index(train_idx)
        snapshot = self._snapshot()
        if self.compiled:
            g = self._captured_step(train_idx)
            g.out[0].copy_(train_idx)
            body = g.replay
        else:
            def body():
                self._train_step(train_idx)

        def run(n):
            for _ in range(n):
                body()

        try:
            samples, _ = differenced_windows(run, self.device, iters, windows, repeats,
                                             before=lambda: self._put_back(snapshot))
        finally:
            self._put_back(snapshot)
        return samples

    def _forward_eval(self) -> torch.Tensor:
        self.model.eval()
        with torch.no_grad():
            return self.model(self.x, self.hgd, self.plan)

    def predict(self) -> torch.Tensor:
        """Full-graph log-probabilities in eval mode, on the device: a
        replay of the captured forward (recorded at the first call), or an
        eager forward. It reads the parameters the step updates in place,
        and returns a copy the next call leaves alone."""
        if not self.compiled:
            return self._forward_eval()
        if self._forward is None:  # its warm-up in eval mode draws no dropout
            self._forward = Captured(self._forward_eval, self.device,
                                     warmup=self._forward_eval)
        return self._forward.replay().clone()

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
        """Checkpoint the parameters and Adam's state
        (:mod:`hypergef_tpu_torch.train.checkpoint`)."""
        save_checkpoint(directory, step, self.model.state_dict(), self.opt_state, wait=wait)

    def restore(self, directory: str, step: Optional[int] = None) -> int:
        """Restore the training state in place (the latest step, or
        ``step``) and return the restored step. The values are copied into
        the existing tensors, so a captured step or forward goes on reading
        them."""
        step, params, opt_state = restore_checkpoint(
            directory, self.model.state_dict(), self.opt_state, step=step)
        _copy_into(self.model.state_dict(), params, "params")
        _copy_into(self.opt_state, opt_state, "opt_state")
        return step


def train_full_batch(cfg: TrainConfig, hg, x, y, split_idx, nclass=None, plan=None, *,
                     device="cuda", params: Optional[Mapping[str, Any]] = None,
                     compiled: Optional[bool] = None):
    """One call in the manner of the reference CLI run: timing + accuracy
    (the CSV row of ``hgsys.py:207-211``), on the card unless ``device``
    says otherwise."""
    tr = Trainer(cfg, hg, x, y, nclass=nclass, plan=plan, device=device, params=params,
                 compiled=compiled)
    res = tr.fit(split_idx["train"])
    res["inference_time_s"] = tr.time_inference(iters=max(cfg.epochs // 2, 1))
    res.update(tr.evaluate(split_idx))
    return res
