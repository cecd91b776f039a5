"""Clustered-workload route shootout on the card: the port of
``experiments/clustered_bench.py``.

Do the block (``bsr``) and tile (``multihot``) routes earn their place
beyond the dense regime? The graph is the SBM of JAX's driver
(``community_hypergraph(n, e, comm, avg, noise, 0)``, draw for draw, its
vertices numbered by community and its hyperedges sorted by median member,
``apply_vertex_order(..., sort_edges=True)``) and, beside it, a random graph
of the same size. Candidates, as in JAX: ``cumsum``, ``tree``, ``bsr`` (RCM
renumbered 128×128 blocks; over its 2 GB budget the row says ``FAILED``,
as JAX's does), ``multihot`` at tile rows 128, 256 and 512 in the compare
form (``mh``) and the host-built form (``mhp``), and ``aligned`` (on the
card its kernel form, the band kernel). Each route's output is held against
the ``xla`` route's on the same x before it is timed (the f32 routes at
1e-3·max|xla|, the bf16 ones at 3e-2). Each row's ``extra`` holds the
plan's host seconds and its tables' device MB. A time is ``cuda_time_ms``
(``--iters`` calls a window behind its queued sleep, median of 20). Each
graph's printed line names the card's fastest route beside the route the
ladder (``plan_aggregation``, JAX's v5e constants) picks. A route that
raises while it runs, or is off its bar, ends the run ``SystemExit`` after
the sweep.

    python -m hypergef_tpu_torch.experiments.clustered_bench --out clustered_r2.csv
    python -m hypergef_tpu_torch.experiments.clustered_bench --device cpu --n 2000 --e 1000 --comm 16
"""

from __future__ import annotations

import argparse
import dataclasses
import time
from typing import List, Optional

import numpy as np
import torch

from hypergef_tpu_torch.experiments import common
from hypergef_tpu_torch.experiments.scale_common import sorted_edges

HEADER = "graph,nnz,backend,params,per_iter_us,extra"
TILE_ROWS = (128, 256, 512)
MULTIHOT_FORMS = (("multihot", "mh"), ("multihot_precomp", "mhp"))


def graphs(args) -> list:
    """The SBM with sorted hyperedges and, with ``--also-random``, the
    random graph of the same size (``:77-90``)."""
    from hypergef_tpu_torch.data.synthetic import community_hypergraph, random_hypergraph

    out = [("sbm", sorted_edges(community_hypergraph(args.n, args.e, args.comm, args.avg,
                                                     args.noise, 0)))]
    if args.also_random:
        out.append(("random", random_hypergraph(args.n, args.e, avg_edge_size=float(args.avg),
                                                seed=0)))
    return out


def device_bytes(obj, seen: Optional[set] = None) -> int:
    """Bytes of the torch tensors a device plan holds (each storage once)."""
    seen = set() if seen is None else seen
    if isinstance(obj, torch.Tensor):
        key = (obj.untyped_storage().data_ptr(), obj.device)
        if key in seen:
            return 0
        seen.add(key)
        return obj.untyped_storage().nbytes()
    if isinstance(obj, (tuple, list)):
        return sum(device_bytes(o, seen) for o in obj)
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return sum(device_bytes(getattr(obj, f.name), seen) for f in dataclasses.fields(obj))
    return 0


def _label(params: dict) -> str:
    return ";".join(f"{k}={v}" for k, v in params.items())


def candidates(hg, device, gname: str, emit):
    """Yield each candidate as (backend, params, plan, plan_s), its plan
    built when it is reached; a plan its planner refuses gets JAX's row
    (``:97-127``) and no timing."""
    from hypergef_tpu_torch.sparse import planner
    from hypergef_tpu_torch.sparse.bsr import plan_bsr

    t0 = time.perf_counter()
    tree = planner.plan_tree(hg)
    tree_s = time.perf_counter() - t0
    base = planner.AggregationPlan(tree=tree)
    yield "cumsum", {}, base, 0.0
    yield "tree", {}, base, tree_s
    try:
        t0 = time.perf_counter()
        bp = plan_bsr(hg, reorder=True)
        yield ("bsr", {"fill": round(bp.fill_fraction(), 5)},
               planner.AggregationPlan(tree=tree, bsr=bp), time.perf_counter() - t0)
    except MemoryError as exc:
        emit(f"{gname},{hg.nnz},bsr,,FAILED,{type(exc).__name__}")
    for tr in TILE_ROWS:
        for form, label in MULTIHOT_FORMS:
            try:
                t0 = time.perf_counter()
                mh = planner.plan_multihot(hg, tile_rows=tr, form=form)
                plan_s = time.perf_counter() - t0
            except MemoryError:
                emit(f"{gname},{hg.nnz},multihot,tr={tr};{form},SKIP,pad-blowup")
                continue
            frag = round(mh.edge_stage.fragmentation(), 3)
            yield ("multihot", {"tile_rows": tr, "frag": frag, "form": label},
                   planner.AggregationPlan(tree=tree, multihot=mh), plan_s)
    try:
        t0 = time.perf_counter()
        al = planner.plan_aligned(hg)
        plan_s = time.perf_counter() - t0
    except (ValueError, MemoryError) as exc:
        emit(f"{gname},{hg.nnz},aligned,,REFUSED,{type(exc).__name__}")
        return
    sp = round(max(al.edge_stage.spill_fraction, al.vertex_stage.spill_fraction), 3)
    # a bucketed stage's windows are a tuple of widths: joined by "+", not
    # written with the commas that would split the CSV row
    wbs = ["+".join(map(str, np.atleast_1d(st.window_blocks)))
           for st in (al.edge_stage, al.vertex_stage)]
    if device.type == "cuda":
        al = dataclasses.replace(al, form="pallas_auto")
    yield ("aligned", {"spill": sp, "wb": f"{wbs[0]}/{wbs[1]}"},
           planner.AggregationPlan(tree=tree, aligned=al), plan_s)


def main(argv: Optional[List[str]] = None) -> list:
    """Run the shootout; returns one dict a timed route (graph, route,
    params, µs, the plan's host seconds and device MB, its gap to ``xla``)
    and one a graph (``"summary"``: the fastest route and the ladder's
    pick)."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=60_000)
    ap.add_argument("--e", type=int, default=30_000)
    ap.add_argument("--comm", type=int, default=240)
    ap.add_argument("--avg", type=int, default=12)
    ap.add_argument("--noise", type=float, default=0.02)
    ap.add_argument("--feat", type=int, default=32)
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--also-random", action="store_true", default=True)
    ap.add_argument("--out", default="clustered_r2.csv")
    common.add_device_flag(ap)
    args = ap.parse_args(argv)
    device = common.resolve_device(args.device)

    from hypergef_tpu_torch.sparse.planner import plan_aggregation
    from hypergef_tpu_torch.train.trainer import device_plans

    comment = (f"# clustered backend shootout n={args.n} e={args.e} comm={args.comm} "
               f"avg={args.avg} noise={args.noise} f={args.feat} dev={device.type}")
    results, failures = [], []
    with common.csv(args.out, device, comments=[comment], header=HEADER) as emit:
        for gname, hg in graphs(args):
            hgd = hg.device_data(device)
            x0 = torch.as_tensor(np.random.default_rng(0).normal(
                size=(hg.num_nodes, args.feat)).astype(np.float32), device=device)
            ref = common.route_call(hgd, x0, None, "xla")()
            times = {}
            for backend, params, plan, plan_s in candidates(hg, device, gname, emit):
                t0 = time.perf_counter()
                tables = [p.device(device) for p in device_plans(plan)]
                put_s = time.perf_counter() - t0
                mb = device_bytes(tables) / 2**20
                call = common.route_call(hgd, x0, plan, backend)
                try:
                    err = common.route_error(call(), ref, backend)
                    timed = common.time_call(call, device, args.iters)
                except (RuntimeError, ValueError) as exc:
                    emit(f"{gname},{hg.nnz},{backend},{_label(params)},FAILED,"
                         f"{type(exc).__name__}")
                    failures.append(f"{gname}/{backend}/{_label(params)}")
                    continue
                if not err["ok"]:
                    failures.append(f"{gname}/{backend}/{_label(params)}")
                us = timed.ms * 1e3
                emit(f"{gname},{hg.nnz},{backend},{_label(params)},{us:.1f},"
                     f"plan_s={plan_s:.3f};device_s={put_s:.3f};device_mb={mb:.1f};"
                     f"max_abs_err={err['max_abs_err']:.3e}{timed.flag()}")
                times[f"{backend} {_label(params)}".strip()] = us
                results.append({"graph": gname, "nnz": hg.nnz, "backend": backend,
                                "params": params, "us": us, "plan_s": plan_s,
                                "device_s": put_s, "device_mb": mb,
                                "host_bound": timed.host_bound, **err})
                del plan, tables, call
                if device.type == "cuda":
                    torch.cuda.empty_cache()
            t0 = time.perf_counter()
            pick = plan_aggregation(hg, device).preferred_backend
            ladder_s = time.perf_counter() - t0
            best = min(times, key=times.get) if times else None
            print(f"| {gname}: fastest {best} against the ladder's pick {pick} "
                  f"(ladder {ladder_s:.2f} s): "
                  f"{ {k: round(v, 1) for k, v in times.items()} }", flush=True)
            results.append({"graph": gname, "summary": True, "fastest": best,
                            "ladder_pick": pick, "ladder_s": ladder_s, "times_us": times})
    print("wrote", args.out, flush=True)
    if failures:
        raise SystemExit(f"clustered_bench failures: {failures}")
    return results


if __name__ == "__main__":
    main()
