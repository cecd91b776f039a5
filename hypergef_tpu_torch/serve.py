"""Serving: full-graph log-probabilities for one fixed hypergraph, and its
export as one self-contained artifact.

Port of ``hypergef_tpu/serve.py``. A request supplies the node features
``x``; the model, its weights, the graph and its plan are the deployment
(``serve.py:50-77``). :class:`ServingModel` holds them on one device and
answers ``predict`` (``:192-205``) under ``torch.inference_mode()``. On the
card a request is one replay of the forward recorded into a CUDA graph, the
counterpart of JAX's ``jax.jit(exported.call)`` (``:190``).

Export (``:50-163``): :func:`export_forward` traces the eval-mode forward
with ``torch.export`` into a program over the single argument ``x``, whose
weights, graph tables and plan tables are constants; the kernels enter it
as the custom ops of :mod:`hypergef_tpu_torch.ops.library`.
:func:`export_trainer` writes the artifact in JAX's layout (``:80-114``)::

    magic "HGEFSRV1" | u32 header_len | header JSON (utf-8) | payload

with ``"payload_format": "torch.export"`` in the header and, as payload, a
zip of one ``<platform>.pt2`` program a platform (``cuda``, ``cpu``).
:meth:`ServingModel.load` needs no model code, no graph data and no plan:
it imports neither :mod:`hypergef_tpu_torch.models` nor
:mod:`hypergef_tpu_torch.train` (the trainer-side imports of this module
are made inside the functions that build a model).

    tr = Trainer(cfg, hg, x, y); tr.fit(split["train"])
    serve.export_trainer(tr, "model.hgefsrv", platforms=["cuda", "cpu"])
    ...
    m = serve.ServingModel.load("model.hgefsrv")   # on the card
    logp = m.predict(x)
"""

from __future__ import annotations

import copy
import io
import json
import struct
import time
import zipfile
from typing import Any, Dict, Mapping, Optional, Sequence

import numpy as np
import torch

from hypergef_tpu_torch import __version__
from hypergef_tpu_torch.ops import library  # noqa: F401  (registers the kernels' ops)
from hypergef_tpu_torch.utils.graphs import Captured

_MAGIC = b"HGEFSRV1"
_FORMAT_VERSION = 1
PAYLOAD_FORMAT = "torch.export"
# the export platforms, and the JAX lowering platform each stands for
PLATFORMS = ("cuda", "cpu")
_ALIASES = {"gpu": "cuda"}


class ExportError(RuntimeError):
    """A route whose forward ``torch.export`` cannot trace."""


class _Forward(torch.nn.Module):
    """The eval-mode forward over one graph, ``x`` → log-probs: what an
    exported program computes. The graph and the plan are held as plain
    attributes, so their tensors enter the program as constants."""

    def __init__(self, model, hgd, plan):
        super().__init__()
        self.model = model
        self.hgd = hgd
        self.plan = plan

    def forward(self, x):
        return self.model(x, self.hgd, self.plan)


def export_forward(model, state: Optional[Mapping[str, Any]], hgd, plan, example_x) -> bytes:
    """Serialize the eval-mode forward ``model(x, hgd, plan)`` as a
    ``torch.export`` program over the single argument ``x``, and return its
    bytes (``torch.export.save``).

    ``state`` (a ``state_dict``, or None for the model's own weights) is
    loaded into a copy of ``model``. One eager forward runs first, so that
    whatever a first call builds (the segment tables of ``hgd``) is built
    from real tensors, not traced. A forward that does not trace raises
    :class:`ExportError`, naming the cause."""
    model = copy.deepcopy(model)
    if state is not None:
        model.load_state_dict({k: torch.as_tensor(v) for k, v in state.items()})
    fwd = _Forward(model, hgd, plan).eval()
    with torch.no_grad():
        fwd(example_x)
        try:
            program = torch.export.export(fwd, (example_x,))
        except Exception as e:  # noqa: BLE001 — re-raised with its cause, never swallowed
            raise ExportError(
                f"the forward does not export ({type(e).__name__}: {str(e).splitlines()[0]})"
            ) from e
    # torch.export keeps the example input to save it beside the program; a
    # request's features are no part of the deployment (235 MB at coauthor_dblp)
    program.example_inputs = None
    buf = io.BytesIO()
    torch.export.save(program, buf)
    return buf.getvalue()


def save_artifact(path: str, payload: bytes, meta: Dict[str, Any]) -> None:
    header = dict(meta)
    header["format_version"] = _FORMAT_VERSION
    hdr = json.dumps(header).encode("utf-8")
    with open(path, "wb") as f:
        f.write(_MAGIC)
        f.write(struct.pack("<I", len(hdr)))
        f.write(hdr)
        f.write(payload)


def read_artifact(path: str):
    """Returns ``(meta, payload_bytes)`` without deserializing the program
    (JAX's ``:88-114``, the same errors): an artifact of either package."""
    with open(path, "rb") as f:
        magic = f.read(len(_MAGIC))
        if magic != _MAGIC:
            raise ValueError(
                f"{path}: not a hypergef serving artifact (bad magic {magic!r})"
            )
        raw_len = f.read(4)
        if len(raw_len) != 4:
            raise ValueError(f"{path}: truncated artifact (missing header length)")
        (hlen,) = struct.unpack("<I", raw_len)
        raw_hdr = f.read(hlen)
        if len(raw_hdr) != hlen:
            raise ValueError(
                f"{path}: truncated artifact (header {len(raw_hdr)}/{hlen} bytes)"
            )
        try:
            meta = json.loads(raw_hdr.decode("utf-8"))
        except (UnicodeDecodeError, json.JSONDecodeError) as e:
            raise ValueError(f"{path}: corrupt artifact header ({e})") from e
        payload = f.read()
    return meta, payload


def export_platforms(platforms: Optional[Sequence[str]], default: str) -> list:
    """The export platforms asked for: ``cuda`` and/or ``cpu`` (``gpu``
    stands for ``cuda``), by default ``default`` alone; ``tpu`` and
    anything else raise ``ValueError``."""
    if not platforms:
        return [default]
    out = []
    for p in platforms:
        p = _ALIASES.get(p, p)
        if p not in PLATFORMS:
            raise ValueError(f"export platform {p!r}: this package exports for {PLATFORMS} "
                             "(a TPU program is the JAX package's jax.export)")
        if p not in out:
            out.append(p)
    return out


def _platform_server(trainer, device: torch.device):
    """A server on ``device`` with the trainer's weights: on the trainer's
    own device its plan, on the other that device's default plan
    (``train.trainer.default_plan``: on the card the kernel forms), or the
    trainer's where the route has no default (``pallas_sparse``)."""
    from hypergef_tpu_torch.train.trainer import default_plan

    cfg = trainer.cfg
    plan = trainer.plan
    if device.type != trainer.device.type:
        try:
            plan = default_plan(cfg.backend, trainer.hg, device, cfg.first_aggr)
        except ValueError:
            plan = trainer.plan
    return ServingModel(cfg, trainer.hg, int(trainer.x.shape[1]), trainer.nclass, device,
                        params=trainer.model.state_dict(), plan=plan, compiled=False)


def export_trainer(trainer, path: Optional[str] = None,
                   platforms: Optional[Sequence[str]] = None) -> Dict[str, Any]:
    """Export a :class:`~hypergef_tpu_torch.train.Trainer`'s forward
    (``:117-163``): one ``torch.export`` program for each platform of
    ``platforms`` (by default the trainer's device type), each exported from
    a server on that device with the trainer's weights, so a ``cuda``
    program runs the kernels and a ``cpu`` one the plain forms. Writes the
    artifact to ``path`` (if given) and returns the header's fields: JAX's,
    with this package's version, ``payload_bytes`` and ``payload_format``.
    Asking for ``cuda`` without a card raises."""
    plats = export_platforms(platforms, trainer.device.type)
    members = {}
    for plat in plats:
        if plat == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("export platform 'cuda' needs a CUDA device: the program "
                               "is traced on the card it will run on")
        device = trainer.device if plat == trainer.device.type else torch.device(plat)
        server = _platform_server(trainer, device)
        members[plat] = export_forward(server.model, None, server.hgd, server.plan,
                                       trainer.x.to(device))
    buf = io.BytesIO()
    with zipfile.ZipFile(buf, "w", zipfile.ZIP_STORED) as z:
        for plat, program in members.items():
            z.writestr(f"{plat}.pt2", program)
    payload = buf.getvalue()
    cfg, hg = trainer.cfg, trainer.hg
    meta = {
        "model": cfg.model,
        "nhid": cfg.nhid,
        "nlayer": cfg.nlayer,
        "nhead": cfg.nhead,
        "first_aggr": cfg.first_aggr,
        "nclass": trainer.nclass,
        "input_shape": list(trainer.x.shape),
        "input_dtype": "float32",
        "output_shape": [int(trainer.x.shape[0]), trainer.nclass],
        "graph": getattr(hg, "name", None),
        "num_nodes": int(hg.num_nodes),
        "num_edges": int(hg.num_edges),
        "nnz": int(hg.nnz),
        "platforms": plats,
        "hypergef_version": __version__,
        "payload_bytes": len(payload),
        "payload_format": PAYLOAD_FORMAT,
    }
    if path is not None:
        save_artifact(path, payload, meta)
    return meta


def _program(payload: bytes, platform: str, path: str) -> bytes:
    """The ``<platform>.pt2`` member of an artifact's payload, or raise."""
    with zipfile.ZipFile(io.BytesIO(payload)) as z:
        names = z.namelist()
        name = f"{platform}.pt2"
        if name not in names:
            have = sorted(n.removesuffix(".pt2") for n in names)
            raise ValueError(f"{path}: the artifact holds no {platform} program (it holds "
                             f"{have}); export it with platforms=[{platform!r}]")
        return z.read(name)


class ServingModel:
    """A model, its weights and its graph, ready to answer requests: built
    from them (the constructor) or loaded from an exported artifact
    (:meth:`load`).

    ``params`` is a ``state_dict`` (for instance from
    :func:`hypergef_tpu_torch.models.convert.params_from_flax`); without it
    the weights are drawn from ``cfg.seed``. ``cfg.model`` is HGNN, UniGIN
    or UniGCNII. Without a ``plan``, a route gets the Trainer's default
    (:func:`~hypergef_tpu_torch.train.trainer.default_plan`): the ladder's
    plan on ``device`` for ``auto`` (the default), ``precomp`` and None (on
    the card its aligned plan runs the band kernel), none for ``cumsum``,
    the int8 table for ``dense`` and ``pallas``, the tree for ``tree``, the
    bit packs for ``bitstream`` (each with the tree for max first
    aggregation), the plain-form ``plan_aligned(hg)`` for ``aligned``, the
    ladder's plan with the ELL tables for ``ell`` and the tree with
    ``plan_bsr(hg)`` or ``plan_multihot(hg)`` for ``bsr`` and ``multihot``;
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
        plan=None,
        compiled: Optional[bool] = None,
    ):
        from hypergef_tpu_torch.models.zoo import build_model
        from hypergef_tpu_torch.train.trainer import default_plan, device_plans

        self.device = torch.device(device)
        _check_compiled(compiled, self.device)
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
        self.program = None
        # the fields of hypergef_tpu/serve.py:143-160
        meta = {
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
            "payload_bytes": None,  # a built server has no artifact
        }
        self._serve(meta, lambda x: self.model(x, self.hgd, self.plan), compiled)

    @classmethod
    def load(cls, path: str, device=None, compiled: Optional[bool] = None) -> "ServingModel":
        """Load an artifact of :func:`export_trainer` and serve its program
        for ``device`` (the card unless the caller passes ``device="cpu"``;
        an artifact without that platform's program raises). No model code,
        graph data or plan is needed: the program holds them. ``compiled``
        as for a built server: on the card a request is one replay of the
        loaded program. An artifact of the JAX package (a ``jax.export``
        payload) raises ``ValueError``."""
        meta, payload = read_artifact(path)
        ver = meta.get("format_version", 0)
        if ver > _FORMAT_VERSION:
            raise ValueError(
                f"{path}: artifact format_version {ver} is newer than this "
                f"library supports ({_FORMAT_VERSION}); upgrade hypergef_tpu_torch"
            )
        fmt = meta.get("payload_format")
        if fmt != PAYLOAD_FORMAT:
            what = "a jax.export payload of the JAX package" if fmt is None else repr(fmt)
            raise ValueError(f"{path}: the payload is {what}; this package serves "
                             f"{PAYLOAD_FORMAT} artifacts (export with its export_trainer)")
        device = torch.device("cuda" if device is None else device)
        if device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("no CUDA device: ServingModel.load serves on the card unless "
                               "it is given device='cpu'")
        _check_compiled(compiled, device)
        program = torch.export.load(io.BytesIO(_program(payload, device.type, path)))
        self = cls.__new__(cls)
        self.device = device
        self.plan = self.hgd = self.model = None
        self.program = program
        module = program.module()
        self._serve(meta, module, compiled)
        return self

    def _serve(self, meta: Dict[str, Any], fn, compiled: Optional[bool]) -> None:
        """Serve ``fn`` (x → log-probs): eagerly, or a recorded replay."""
        self.meta = meta
        self._fn = fn
        self.compiled = self.device.type == "cuda" if compiled is None else bool(compiled)
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
            return self._fn(x)

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


def _check_compiled(compiled: Optional[bool], device: torch.device) -> None:
    if compiled and device.type != "cuda":
        raise ValueError(
            f"compiled=True needs a CUDA device (a CUDA graph records the card's "
            f"kernels); on {device} the server runs eagerly")
