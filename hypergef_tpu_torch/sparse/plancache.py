"""Persistent plans: build a graph's schedule once, load it in later runs.

Port of ``hypergef_tpu/sparse/plancache.py`` (``:28-212``). A plan (an
:class:`~hypergef_tpu_torch.sparse.planner.AggregationPlan`, or any nesting
of the planner's NamedTuples and dataclasses over NumPy arrays and torch
tensors) is written to one compressed ``.npz`` and read back bit-exact,
keyed by a hash of the graph's content:

* NumPy leaves are stored as they are, deduplicated by identity; torch
  tensors (``DenseIncidence.h``, int8 counts or the packed-int4 nibble
  carrier, whose ``packed`` flag is a field like any other and comes back
  as saved, as JAX's cache keeps it; the bf16 ``DensePrecomp.a``) are
  stored from the host by dtype tag, bf16 as an ``int16`` view (NumPy has
  no bf16), and put back on the device the caller names;
* fields whose names start with ``_`` are derived caches and are skipped:
  the per-device tables of ``TreePlan._device`` (the band tables, live
  lists and warp runs built on the card), ``DensePrecomp._device`` and
  ``BitIncidence._device``; ``.device()`` rebuilds them on first use;
* classes are resolved by qualified name, from ``hypergef_tpu_torch`` and
  its submodules only: no pickle, no code run from a cache file, and never
  a class of the JAX package (resolving one would import JAX);
* the key hashes the package's name, the device type and the builder's
  keyword arguments beside the graph, and the default directory is the
  port's own (``~/.cache/hypergef_tpu_torch/plans``, or
  ``$HYPERGEF_TORCH_PLAN_CACHE``): on a card the ladder's aligned plan is
  the kernel form, so no file of one package or device type is ever served
  to another.

:func:`cached_plan_halo` keeps the distributed halo plan
(:func:`hypergef_tpu_torch.parallel.halo.plan_halo`) the same way
(``:217-236``).
"""

from __future__ import annotations

import dataclasses
import hashlib
import importlib
import json
import os
import zipfile
from typing import Any, Callable, Optional

import numpy as np
import torch

# bump when plan layouts change incompatibly: old cache files miss
PLAN_FORMAT_VERSION = 1
PACKAGE = "hypergef_tpu_torch"

_BF16_TAG = "bfloat16"
# what a cache file that cannot be read raises on load: it is rebuilt
_UNREADABLE = (OSError, EOFError, ValueError, KeyError, TypeError, AttributeError,
               zipfile.BadZipFile)


def _is_namedtuple(obj) -> bool:
    return isinstance(obj, tuple) and hasattr(obj, "_fields")


def _class_path(obj) -> str:
    cls = type(obj)
    return f"{cls.__module__}:{cls.__qualname__}"


def _resolve_class(path: str):
    mod_name, _, qual = path.partition(":")
    if mod_name != PACKAGE and not mod_name.startswith(PACKAGE + "."):
        raise ValueError(f"plan cache refuses to resolve a class outside {PACKAGE}: {path!r}")
    obj = importlib.import_module(mod_name)
    for part in qual.split("."):
        obj = getattr(obj, part)
    return obj


def _encode(obj, arrays: dict, seen: dict) -> Any:
    """``obj`` as a JSON-able spec; array payloads land in ``arrays``,
    deduplicated by identity."""
    if obj is None or isinstance(obj, (bool, int, float, str)):
        return {"t": "v", "v": obj}
    if isinstance(obj, np.integer):
        return {"t": "v", "v": int(obj)}
    if isinstance(obj, np.floating):
        return {"t": "v", "v": float(obj)}
    if isinstance(obj, (np.ndarray, torch.Tensor)):
        key = seen.get(id(obj))
        if isinstance(obj, torch.Tensor):
            t = obj.detach().cpu()
            dt = str(t.dtype).removeprefix("torch.")
            arr = (t.view(torch.int16) if t.dtype == torch.bfloat16 else t).numpy()
            node = "pt"
        else:
            arr, dt, node = obj, str(obj.dtype), "nd"
        if key is None:
            key = f"a{len(arrays)}"
            seen[id(obj)] = key
            arrays[key] = arr
        return {"t": node, "k": key, "dt": dt}
    if _is_namedtuple(obj):
        return {"t": "nt", "c": _class_path(obj),
                "f": {n: _encode(getattr(obj, n), arrays, seen) for n in obj._fields}}
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        fields = {f.name: _encode(getattr(obj, f.name), arrays, seen)
                  for f in dataclasses.fields(obj) if not f.name.startswith("_")}
        return {"t": "dc", "c": _class_path(obj), "f": fields}
    if isinstance(obj, tuple):
        return {"t": "tu", "i": [_encode(x, arrays, seen) for x in obj]}
    if isinstance(obj, list):
        return {"t": "li", "i": [_encode(x, arrays, seen) for x in obj]}
    if isinstance(obj, dict):
        if not all(isinstance(k, str) for k in obj):
            raise TypeError("plan cache supports str dict keys only")
        return {"t": "di", "f": {k: _encode(v, arrays, seen) for k, v in obj.items()}}
    raise TypeError(f"plan cache cannot serialize {type(obj)!r}")


def _decode(spec: Any, arrays, device, tensors: dict) -> Any:
    t = spec["t"]
    if t == "v":
        return spec["v"]
    if t == "nd":
        return arrays[spec["k"]]
    if t == "pt":
        key = spec["k"]
        if key not in tensors:  # one tensor for each array saved once
            out = torch.from_numpy(np.array(arrays[key]))
            if spec["dt"] == _BF16_TAG:
                out = out.view(torch.bfloat16)
            tensors[key] = out.to(device)
        return tensors[key]
    if t == "tu":
        return tuple(_decode(x, arrays, device, tensors) for x in spec["i"])
    if t == "li":
        return [_decode(x, arrays, device, tensors) for x in spec["i"]]
    if t == "di":
        return {k: _decode(v, arrays, device, tensors) for k, v in spec["f"].items()}
    if t in ("nt", "dc"):
        cls = _resolve_class(spec["c"])
        return cls(**{k: _decode(v, arrays, device, tensors) for k, v in spec["f"].items()})
    raise ValueError(f"unknown plan-cache node type {t!r}")


def save_plan(plan, path: str) -> str:
    """Write any plan structure to one compressed ``.npz``, through a
    temporary file renamed into place, so that a concurrent reader never
    sees a partial file."""
    arrays: dict = {}
    spec = _encode(plan, arrays, seen={})
    manifest = json.dumps({"version": PLAN_FORMAT_VERSION, "package": PACKAGE, "root": spec})
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "wb") as fh:
        np.savez_compressed(
            fh, __manifest__=np.frombuffer(manifest.encode(), dtype=np.uint8), **arrays)
    os.replace(tmp, path)
    return path


def load_plan(path: str, device="cuda"):
    """Read a plan written by :func:`save_plan`; its torch tensors go to
    ``device`` (the card unless the caller asks for the CPU)."""
    with np.load(path, allow_pickle=False) as z:
        manifest = json.loads(bytes(z["__manifest__"]).decode())
        if manifest.get("version") != PLAN_FORMAT_VERSION or manifest.get("package") != PACKAGE:
            raise ValueError(
                f"plan cache file of {manifest.get('package')!r} format "
                f"{manifest.get('version')}, not {PACKAGE!r} {PLAN_FORMAT_VERSION}: rebuild "
                f"({path})")
        arrays = {k: z[k] for k in z.files if k != "__manifest__"}
    return _decode(manifest["root"], arrays, torch.device(device), {})


def plan_key(hg, device="cuda", **kwargs) -> str:
    """Hash of the graph's content, the package, the device type and the
    builder's keyword arguments: the cache never serves a plan for another
    graph, build, package or device type."""
    h = hashlib.sha256()
    h.update(f"{PACKAGE} v{PLAN_FORMAT_VERSION} {torch.device(device).type}".encode())
    h.update(np.ascontiguousarray(hg.h_indptr).tobytes())
    h.update(np.ascontiguousarray(hg.h_indices).tobytes())
    h.update(f"{hg.num_nodes}x{hg.num_edges}".encode())
    for k in sorted(kwargs):
        h.update(f"|{k}={kwargs[k]!r}".encode())
    return h.hexdigest()[:24]


def default_cache_dir() -> str:
    return os.environ.get(
        "HYPERGEF_TORCH_PLAN_CACHE",
        os.path.join(os.path.expanduser("~"), ".cache", PACKAGE, "plans"),
    )


def cached_plan(hg, build: Callable[[], Any], cache_dir: Optional[str] = None,
                device="cuda", **key):
    """``build()`` behind a persistent cache keyed by ``hg``'s content,
    ``device``'s type and ``key``: the first call builds and saves, every
    later one (in a fresh process too) loads. A file that cannot be read is
    rebuilt and overwritten."""
    d = cache_dir or default_cache_dir()
    path = os.path.join(d, f"plan_{plan_key(hg, device, **key)}.npz")
    if os.path.exists(path):
        try:
            return load_plan(path, device)
        except _UNREADABLE:
            pass  # stale format or a broken file: rebuild below
    plan = build()
    save_plan(plan, path)
    return plan


def cached_plan_aggregation(hg, cache_dir: Optional[str] = None, device="cuda", **kwargs):
    """:func:`~hypergef_tpu_torch.sparse.planner.plan_aggregation` on
    ``device`` behind the cache (``:177-195``), keyed by its keyword
    arguments."""
    from hypergef_tpu_torch.sparse import planner

    return cached_plan(hg, lambda: planner.plan_aggregation(hg, device, **kwargs),
                       cache_dir=cache_dir, device=device, **kwargs)


def cached_plan_halo(hg, n_shards: int, cache_dir: Optional[str] = None, device="cuda",
                     **kwargs):
    """:func:`~hypergef_tpu_torch.parallel.halo.plan_halo` behind the cache
    (``:217-236``), keyed by the shard count, ``device``'s type (the device
    the ranks will run on; the plan itself is host arrays) and the keyword
    arguments. Build it once in the parent of a world and hand it to the
    ranks, or let each rank load the file."""
    from hypergef_tpu_torch.parallel.halo import plan_halo

    d = cache_dir or default_cache_dir()
    path = os.path.join(d, f"halo_{plan_key(hg, device, n_shards=n_shards, **kwargs)}.npz")
    if os.path.exists(path):
        try:
            return load_plan(path, device)
        except _UNREADABLE:
            pass  # stale format or a broken file: rebuild below
    plan = plan_halo(hg, n_shards, **kwargs)
    save_plan(plan, path)
    return plan
