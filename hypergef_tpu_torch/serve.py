"""Serving: full-graph log-probabilities for one fixed hypergraph.

Port of the serving side of ``hypergef_tpu/serve.py``. A request supplies
the node features ``x``; the model, its weights, the graph and its plan
are the deployment (``serve.py:50-77``). :class:`ServingModel` holds them on
one device and answers ``predict`` (``:192-205``) under
``torch.inference_mode()``. On the card a request is one replay of the
forward recorded into a CUDA graph when the server is built, the
counterpart of JAX's ``jax.jit(exported.call)`` (``:190``). Artifact export
and load (``:50-163``) come later (ROADMAP.md queue 1, "Serving export and
checkpoints").
"""

from __future__ import annotations

import time
from typing import Any, Dict, Mapping, Optional

import numpy as np
import torch

from hypergef_tpu_torch import __version__
from hypergef_tpu_torch.models.zoo import build_model
from hypergef_tpu_torch.sparse.planner import AggregationPlan
from hypergef_tpu_torch.train.trainer import default_plan, device_plans
from hypergef_tpu_torch.utils.graphs import Captured


class ServingModel:
    """A model, its weights and its graph, ready to answer requests.

    ``params`` is a ``state_dict`` (for instance from
    :func:`hypergef_tpu_torch.models.convert.params_from_flax`); without it
    the weights are drawn from ``cfg.seed``. ``cfg.model`` is HGNN, UniGIN
    or UniGCNII. Without a ``plan``, a route gets the Trainer's default
    (:func:`~hypergef_tpu_torch.train.trainer.default_plan`): the ladder's
    plan on ``device`` for ``auto`` (the default), ``precomp`` and None (on
    the card its aligned plan runs the band kernel), none for ``cumsum``,
    the int8 table for ``dense`` and ``pallas``, the tree for ``tree``, the
    bit packs for ``bitstream`` (each with the tree for max first
    aggregation) and the plain-form ``plan_aligned(hg)`` for ``aligned``;
    pass a ``pallas_*`` form plan to run the band and argmax kernels there,
    and ``pallas_sparse`` its plan. A plan's tables go to ``device`` here.

    ``compiled`` is the Trainer's switch: None records the forward into a
    CUDA graph here on a CUDA device (``capture_s`` host seconds, warm-up
    included) and serves eagerly on the CPU; False serves eagerly; True on
    the CPU raises.
    """

    def __init__(
        self,
        cfg,
        hg,
        nfeat: int,
        nclass: int,
        device,
        params: Optional[Mapping[str, Any]] = None,
        plan: Optional[AggregationPlan] = None,
        compiled: Optional[bool] = None,
    ):
        self.device = torch.device(device)
        if compiled and self.device.type != "cuda":
            raise ValueError(
                f"compiled=True needs a CUDA device (a CUDA graph records the card's "
                f"kernels); on {self.device} the server runs eagerly")
        self.compiled = self.device.type == "cuda" if compiled is None else bool(compiled)
        if plan is None:
            plan = default_plan(cfg.backend, hg, self.device, cfg.first_aggr)
        self.plan = plan
        for p in device_plans(plan):
            p.device(self.device)
        self.hgd = hg.device_data(self.device)
        self.model = build_model(
            cfg.model, nfeat=nfeat, nhid=cfg.nhid, nclass=nclass,
            num_edges=hg.num_edges, nlayer=cfg.nlayer, first_aggr=cfg.first_aggr,
            nhead=cfg.nhead, dropout=cfg.dropout, input_drop=cfg.input_drop,
            activation=cfg.activation, backend=cfg.backend, seed=cfg.seed,
            device=self.device,
        )
        if params is not None:
            self.model.load_state_dict({k: torch.as_tensor(v) for k, v in params.items()})
        self.model.eval()
        # the fields of hypergef_tpu/serve.py:143-160
        self.meta: Dict[str, Any] = {
            "model": cfg.model,
            "nhid": cfg.nhid,
            "nlayer": cfg.nlayer,
            "nhead": cfg.nhead,
            "first_aggr": cfg.first_aggr,
            "nclass": int(nclass),
            "input_shape": [int(hg.num_nodes), int(nfeat)],
            "input_dtype": "float32",
            "output_shape": [int(hg.num_nodes), int(nclass)],
            "graph": getattr(hg, "name", None),
            "num_nodes": int(hg.num_nodes),
            "num_edges": int(hg.num_edges),
            "nnz": int(hg.nnz),
            "platforms": [self.device.type],
            "hypergef_version": __version__,
            "payload_bytes": None,  # None until export is ported (ROADMAP.md queue 1)
        }
        self._graph: Optional[Captured] = None
        self.capture_s = 0.0
        if self.compiled:
            t0 = time.perf_counter()
            self._x = torch.zeros(tuple(self.meta["input_shape"]), dtype=torch.float32,
                                  device=self.device)
            self._graph = Captured(lambda: self._forward(self._x), self.device,
                                   warmup=lambda: self._forward(self._x))
            self.capture_s = time.perf_counter() - t0

    def _forward(self, x: torch.Tensor) -> torch.Tensor:
        with torch.inference_mode():
            return self.model(x, self.hgd, self.plan)

    def predict(self, x) -> torch.Tensor:
        """Full-graph log-probabilities ``[num_nodes, nclass]`` on the device.

        Captured, ``x`` is copied into the graph's input and the graph
        replayed; the answer is a copy that the next request leaves alone,
        as JAX returns a new array."""
        x = torch.as_tensor(x, dtype=torch.float32, device=self.device)
        expect = tuple(self.meta["input_shape"])
        if tuple(x.shape) != expect:
            raise ValueError(
                f"serving input shape {tuple(x.shape)} != the model's shape "
                f"{expect} (the server is built for one graph; build another "
                "for a different graph)"
            )
        if self._graph is None:
            return self._forward(x.contiguous())
        self._x.copy_(x)
        with torch.inference_mode():
            return self._graph.replay().clone()

    def predict_labels(self, x) -> np.ndarray:
        return self.predict(x).argmax(dim=1).cpu().numpy()
