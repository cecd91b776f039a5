"""Measured autotune: a per-graph sweep of routes and parameters, kept.

Port of ``hypergef_tpu/sparse/autotune.py`` (``:1-334``). The reference
tunes its partition size by timing a sweep of candidates for each dataset
and keeps the winners in a table; this times every (route, parameters)
candidate on the device, on the fused op at the real feature width:

* :func:`sweep` times each candidate over chained calls with
  :func:`~hypergef_tpu_torch.utils.timing.per_iter_time` (CUDA events
  behind a queued sleep on the card) and JAX's widening rule;
* results persist to ``~/.cache/hypergef_tpu_torch/tune/<key>.json`` (or
  ``$HYPERGEF_TORCH_TUNE_DIR``), keyed by the graph's shape and the
  device's name, so a later run plans at once;
* :func:`autotune_plan` returns an
  :class:`~hypergef_tpu_torch.sparse.planner.AggregationPlan` whose
  ``preferred_backend`` comes from the measurement, not the ladder.

The candidates are JAX's, its six ``multihot`` forms among them. Where
JAX's sweep survives any
exception, this one skips (and prints) only a candidate's named refusals:
``ValueError``, ``MemoryError`` or ``NotImplementedError`` raised by its
planner, and ``torch.cuda.OutOfMemoryError``. A kernel's build, launch or
CUDA error propagates: a sweep never hides a broken kernel behind the
next candidate.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import time
from typing import Optional

import numpy as np
import torch

# what a planner refuses a graph with
_PLAN_REFUSALS = (ValueError, MemoryError, NotImplementedError, torch.cuda.OutOfMemoryError)


def default_cache_dir() -> str:
    return os.environ.get(
        "HYPERGEF_TORCH_TUNE_DIR",
        os.path.join(os.path.expanduser("~"), ".cache", "hypergef_tpu_torch", "tune"),
    )


def device_name(device) -> str:
    device = torch.device(device)
    return torch.cuda.get_device_name(device) if device.type == "cuda" else device.type


def graph_key(hg, feature_size: int, device="cuda") -> str:
    """Identity of a tuning problem (``:35-60``): the graph's shape and
    degree quartiles, the feature width and the device's name."""
    deg_e = np.diff(np.asarray(hg.ht_indptr))
    deg_v = np.diff(np.asarray(hg.h_indptr))
    h = hashlib.sha1()
    h.update(json.dumps({
        "n": int(hg.num_nodes),
        "e": int(hg.num_edges),
        "nnz": int(hg.nnz),
        "f": int(feature_size),
        "deg_e_q": [int(x) for x in np.percentile(deg_e, [0, 25, 50, 75, 100])]
        if deg_e.size else [],
        "deg_v_q": [int(x) for x in np.percentile(deg_v, [0, 25, 50, 75, 100])]
        if deg_v.size else [],
        "dev": device_name(device),
    }, sort_keys=True).encode())
    name = getattr(hg, "name", None) or "graph"
    return f"{name}-{h.hexdigest()[:12]}"


@dataclasses.dataclass
class TuneResult:
    backend: str
    params: dict
    per_iter_s: float


def default_candidates(hg) -> list:
    """JAX's candidates (``:71-113``): ``cumsum``, the tree at each ngs of
    the reference's partition grid, ``dense`` where the int8 table fits (at
    twice the ladder's stream gate, so the sweep can catch a shape the
    model mis-prices), ``precomp`` where A fits, ``multihot`` at tile rows
    128, 256 and 512 in the compare and the precomp form, and ``aligned``
    on community-sorted graphs."""
    from hypergef_tpu_torch.sparse import planner

    cands = [("cumsum", {})] + [("tree", {"ngs": g}) for g in (2, 4, 8, 16, 32)]
    n_entries = hg.num_nodes * hg.num_edges
    if n_entries <= 32_000_000 or (
        n_entries <= planner.DENSE_STREAM_MAX_ENTRIES
        and n_entries < 2 * planner.DENSE_STREAM_VS_GATHER * max(hg.nnz, 1)
    ):
        cands.append(("dense", {}))
    if hg.num_nodes * hg.num_nodes <= 80_000_000:
        cands.append(("precomp", {}))
    for tr in (128, 256, 512):
        cands.append(("multihot", {"tile_rows": tr}))
        cands.append(("multihot", {"tile_rows": tr, "form": "multihot_precomp"}))
    spill = max(
        planner.aligned_spill_stats(hg.ht_indptr, hg.ht_indices, hg.num_nodes, window_blocks=8),
        planner.aligned_spill_stats(hg.h_indptr, hg.h_indices, hg.num_edges, window_blocks=8),
    )
    if spill <= 0.3:  # community-sorted graphs only
        cands.append(("aligned", {}))
    return cands


def _build_plan(hg, backend: str, params: dict, device="cuda"):
    """The plan a candidate runs on (``:116-152``). On a CUDA device the
    aligned plan is the kernel form, as the ladder's is there."""
    from hypergef_tpu_torch.sparse import planner

    if backend in ("cumsum", "xla"):
        return planner.plan_tree(hg)  # unused by these routes
    if backend == "tree":
        return planner.plan_tree(hg, ngs=params.get("ngs"))
    if backend == "dense":
        return planner.AggregationPlan(
            tree=planner.plan_tree(hg), dense=planner.DenseIncidence.from_hypergraph(hg, device))
    if backend == "precomp":
        return planner.AggregationPlan(
            tree=planner.plan_tree(hg), precomp=planner.DensePrecomp.from_hypergraph(hg, device))
    if backend == "aligned":
        plan = planner.plan_aligned(hg, max_spill=params.get("max_spill", 0.35))
        if torch.device(device).type == "cuda":
            plan = dataclasses.replace(plan, form="pallas_auto")
        return plan
    if backend == "multihot":
        return planner.plan_multihot(hg, tile_rows=params.get("tile_rows", 256),
                                     ngs=params.get("ngs", 8),
                                     form=params.get("form", "multihot"))
    if backend == "bsr":
        from hypergef_tpu_torch.sparse.bsr import plan_bsr

        return planner.AggregationPlan(tree=planner.plan_tree(hg), bsr=plan_bsr(hg, reorder=True))
    raise ValueError(backend)


def sweep(
    hg,
    feature_size: int = 32,
    candidates: Optional[list] = None,
    iters: int = 20,
    first_aggr: str = "sum",
    verbose: bool = False,
    device="cuda",
) -> list:
    """Time every candidate on ``device``; returns the :class:`TuneResult`
    list, fastest first (``:155-222``). A candidate whose planner refuses
    the graph, or that runs out of device memory, is skipped."""
    from hypergef_tpu_torch.ops import fused
    from hypergef_tpu_torch.train.trainer import device_plans
    from hypergef_tpu_torch.utils.timing import per_iter_time

    device = torch.device(device)
    hgd = hg.device_data(device)
    rng = np.random.default_rng(0)
    x = torch.as_tensor(rng.normal(size=(hg.num_nodes, feature_size)).astype(np.float32),
                        device=device)
    results = []
    for backend, params in candidates or default_candidates(hg):
        try:
            plan = _build_plan(hg, backend, params, device)
            for p in device_plans(plan):
                p.device(device)  # tables on the device before the windows
        except _PLAN_REFUSALS as e:
            _skip(verbose, backend, params, e)
            continue

        def run(n, plan=plan, backend=backend):
            with torch.no_grad():
                for _ in range(n):
                    fused.hgnn_aggregate(hgd, x, None, first_aggr, plan=plan, backend=backend)

        try:
            t = per_iter_time(run, device, iters)
            # JAX's small-graph guard (:199-214): widen the window until
            # it is at least twice the one-call window
            cur = iters
            while cur < 4000 and (t["noisy"] or t["per_iter_s"] * cur < 2.0 * t["short_s"]):
                cur *= 5
                if verbose:
                    print(f"  tune {backend} {params}: window below 2x one call — "
                          f"widening to {cur} iters", flush=True)
                t = per_iter_time(run, device, cur)
        except torch.cuda.OutOfMemoryError as e:
            _skip(verbose, backend, params, e)
            continue
        results.append(TuneResult(backend, params, t["per_iter_s"]))
        if verbose:
            print(f"  tune {backend} {params}: {t['per_iter_s'] * 1e6:.1f} us", flush=True)
    results.sort(key=lambda r: r.per_iter_s)
    return results


def _skip(verbose: bool, backend: str, params: dict, e: Exception) -> None:
    if verbose:
        print(f"  tune {backend} {params}: skipped, {type(e).__name__}: "
              f"{str(e).splitlines()[0][:120] if str(e) else ''}", flush=True)


def load_cached(key: str, cache_dir: Optional[str] = None) -> Optional[dict]:
    path = os.path.join(cache_dir or default_cache_dir(), f"{key}.json")
    if os.path.exists(path):
        with open(path) as f:
            return json.load(f)
    return None


def save_cached(key: str, record: dict, cache_dir: Optional[str] = None) -> str:
    d = cache_dir or default_cache_dir()
    os.makedirs(d, exist_ok=True)
    path = os.path.join(d, f"{key}.json")
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "w") as f:
        json.dump(record, f, indent=1, sort_keys=True)
    os.replace(tmp, path)
    return path


def autotune(
    hg,
    feature_size: int = 32,
    candidates: Optional[list] = None,
    iters: int = 20,
    cache: bool = True,
    cache_dir: Optional[str] = None,
    verbose: bool = False,
    device="cuda",
) -> TuneResult:
    """The measured best (route, parameters) for this graph and feature
    width on ``device``, kept across processes (``:245-285``)."""
    key = graph_key(hg, feature_size, device)
    if cache:
        rec = load_cached(key, cache_dir)
        if rec is not None:
            return TuneResult(rec["backend"], rec["params"], rec["per_iter_s"])
    results = sweep(hg, feature_size, candidates, iters, verbose=verbose, device=device)
    if not results:
        return TuneResult("tree", {}, float("inf"))
    best = results[0]
    if cache:
        save_cached(key, {
            "backend": best.backend,
            "params": best.params,
            "per_iter_s": best.per_iter_s,
            "device": device_name(device),
            "tuned_at": time.strftime("%Y-%m-%d %H:%M:%S"),
            "all": [{"backend": r.backend, "params": r.params, "per_iter_s": r.per_iter_s}
                    for r in results],
        }, cache_dir)
    return best


def autotune_plan(
    hg,
    feature_size: int = 32,
    cache: bool = True,
    cache_dir: Optional[str] = None,
    verbose: bool = False,
    device="cuda",
):
    """The ladder's plan with ``preferred_backend`` (and its parameters)
    from the measurement on ``device`` (``:288-334``). Where the ladder did
    not build the table the pick reads (the int8 ``dense`` table, the
    aligned plan), it is built here; a ``multihot`` pick gets the measured
    form's plan, and the ladder builds none of its own for a ``tree``,
    ``multihot`` or ``aligned`` pick, as in JAX."""
    from hypergef_tpu_torch.sparse import planner

    best = autotune(hg, feature_size, cache=cache, cache_dir=cache_dir, verbose=verbose,
                    device=device)
    if best.backend == "tree":
        plan = planner.plan_aggregation(hg, device, ngs=best.params.get("ngs"),
                                        with_multihot=False)
    elif best.backend in ("multihot", "aligned"):
        plan = planner.plan_aggregation(hg, device, with_multihot=False)
    else:
        plan = planner.plan_aggregation(hg, device)
    if best.backend == "multihot":
        plan.multihot = _build_plan(hg, "multihot", best.params, device)
    if best.backend == "aligned" and plan.aligned is None:
        plan.aligned = _build_plan(hg, "aligned", best.params, device)
    if best.backend == "dense" and plan.dense is None:
        plan.dense = planner.DenseIncidence.from_hypergraph(hg, device)
    plan.preferred_backend = best.backend
    return plan
