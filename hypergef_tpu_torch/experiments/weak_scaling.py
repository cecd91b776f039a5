"""Weak scaling of the fully-sharded halo design: plan-derived traffic, a
link model and the card's measured compute. The port of
``experiments/weak_scaling.py``.

* per-pair traffic comes from the halo plan itself (``parallel.halo.
  plan_halo``, bit-equal to JAX's): ``send_mask`` counts the rows each
  (src → dst) pair returns, ``halo_mask`` the rows it ships out, once
  each a layer;
* ``comm_frac`` = cross-shard boundary rows / full-replication rows;
* the exchange time is modeled (``--links``, :mod:`.scale_common`):
  ``max_link_MB`` is the critical path's bytes (the largest pair's under
  ``v5e``, the busiest card's under ``nvlink4``), ``t_ici_us`` their time;
* the compute time is local nnz × ns/nnz MEASURED on the device for each
  graph: its ``tree`` route, and its ``aligned`` route (kernel form on the
  card) for the interior, where the planner takes the graph (else the
  interior runs trees, at the tree's rate). ``--ns-per-nnz`` overrides the
  tree's; ``V5E_NS_PER_NNZ`` and ``V5E_NS_ALIGNED`` (the JAX driver's TPU
  v5e figures) serve only the parity tests.

Graphs: uniform random (near-worst-case cut) and clustered (homophilic,
hyperedges sorted by community). ``--measure`` adds a gloo world of CPU
ranks (``parallel.launch.spawn``, one world for every shard count),
wall-clock per layer: structural validation only, as JAX labels its CPU
mesh. The comment rows give each graph's ns/nnz.

    python -m hypergef_tpu_torch.experiments.weak_scaling --shards 1,2,4,8 --out weak_scaling_r2.csv
"""

from __future__ import annotations

import argparse
import dataclasses
import time
from typing import List, Optional

import numpy as np
import torch

from hypergef_tpu_torch.experiments import common
from hypergef_tpu_torch.experiments.scale_common import (
    V5E_NS_ALIGNED, add_link_flags, clustered_hypergraph, link_model,
)

HEADER = ("graph,shards,nnz,comm_frac,interior_frac,total_MB,max_link_MB,"
          "t_ici_us,t_compute_us,t_compute_aligned_us,comm_over_compute,wall_ms")
KINDS = ("random", "clustered")


def graph(kind: str, d: int, nnz_per_shard: int):
    """The JAX driver's graph of ``d`` shards (``weak_scaling.py:170-178``)."""
    from hypergef_tpu_torch.data.synthetic import random_hypergraph
    avg = 10.0
    n_edges = nnz_per_shard * d // int(avg)
    n_nodes = n_edges * 2
    if kind == "random":
        return random_hypergraph(n_nodes, n_edges, avg_edge_size=avg, seed=0, name=f"ws{d}")
    return clustered_hypergraph(n_nodes, n_edges, avg, seed=0)


def analyze(hg, d, feat, link, ns_per_nnz, ns_aligned=V5E_NS_ALIGNED):
    """Plan-derived traffic and modeled times for one (graph, D) point
    (``weak_scaling.py:80-124``); at ``V5E_ICI`` and JAX's ns figures the
    numbers are JAX's bit for bit."""
    from hypergef_tpu_torch.parallel.halo import plan_halo

    plan = plan_halo(hg, d)
    # rows exchanged a (src, dst) pair a layer: the halo ships boundary-
    # touched rows, the return partial rows of the whole touched set
    ret_rows = plan.send_mask.sum(axis=2)  # [D, D]
    halo_rows = plan.halo_mask.sum(axis=2)  # [D, D]
    np.fill_diagonal(ret_rows, 0.0)  # a self-exchange is a local copy
    np.fill_diagonal(halo_rows, 0.0)
    bytes_per_row = feat * 4
    total_bytes = float(ret_rows.sum() + halo_rows.sum()) * bytes_per_row
    max_link = link.a2a_rows(ret_rows, halo_rows) * bytes_per_row
    comm_frac = float(ret_rows.sum() + halo_rows.sum()) / (2 * max(d * hg.num_nodes, 1))
    ifrac = plan.interior_fraction()
    nnz_d = hg.nnz / d
    t_aligned = nnz_d * (ifrac * ns_aligned + (1 - ifrac) * ns_per_nnz) * 1e-3
    return plan, {
        "comm_frac": comm_frac,
        "total_MB": total_bytes / 1e6,
        "max_link_MB": max_link / 1e6,
        "t_ici_us": link.a2a_us(max_link),
        "t_compute_us": nnz_d * ns_per_nnz * 1e-3,
        "t_compute_aligned_us": t_aligned,
        "interior_frac": ifrac,
    }


def measured_ns(hg, feat: int, device, iters: int, aligned: bool = True) -> dict:
    """ns an incidence of the ``tree`` route and (with ``aligned``) of the
    ``aligned`` route (kernel form on the card) on ``device``
    (``common.time_call``; the aligned rate is the tree's where the planner
    refuses the graph), each call held against the ``xla`` route first."""
    from hypergef_tpu_torch.sparse import planner

    hgd = hg.device_data(device)
    x0 = torch.as_tensor(np.random.default_rng(0).normal(
        size=(hg.num_nodes, feat)).astype(np.float32), device=device)
    ref = common.route_call(hgd, x0, None, "xla")()
    out = {"errors": {}}
    plans = {"tree": planner.plan_tree(hg)}
    try:
        if aligned:
            al = planner.plan_aligned(hg)
            plans["aligned"] = (dataclasses.replace(al, form="pallas_auto")
                                if device.type == "cuda" else al)
    except (ValueError, MemoryError) as exc:
        out["aligned_refused"] = type(exc).__name__
    for backend, plan in plans.items():
        call = common.route_call(hgd, x0, plan, backend)
        out["errors"][backend] = common.route_error(call(), ref, backend)
        r = common.time_call(call, device, iters)
        out[backend] = r.ms * 1e6 / hg.nnz
        out[f"{backend}_host_bound"] = r.host_bound
    out.setdefault("aligned", out["tree"])
    return out


def measure_rank(cases, feat: int, iters: int) -> dict:
    """In each rank of a gloo world of CPU ranks: for each (key, plan) the
    halo layer on the ranks below the plan's shard count (a group of its
    own), its wall seconds a call (rank 0's)."""
    import torch.distributed as dist

    from hypergef_tpu_torch.parallel.halo_aggr import halo_hgnn_aggregate, own_block
    from hypergef_tpu_torch.parallel.mesh import make_mesh

    rank, out = dist.get_rank(), {}
    for key, plan in cases:
        d = plan.n_shards
        group = dist.new_group(ranks=list(range(d)))
        if rank >= d:
            continue
        mesh = make_mesh(group=group)
        x = np.random.default_rng(0).normal(size=(plan.n_shards * plan.n_own, feat))
        xb = torch.as_tensor(own_block(plan, x.astype(np.float32), rank))
        with torch.no_grad():
            halo_hgnn_aggregate(plan, xb, mesh=mesh)
            dist.barrier(group=group)
            t0 = time.perf_counter()
            for _ in range(iters):
                halo_hgnn_aggregate(plan, xb, mesh=mesh)
            dist.barrier(group=group)
        out[key] = (time.perf_counter() - t0) / iters
    return out


def main(argv: Optional[List[str]] = None) -> list:
    """Run the sweep; returns one dict a (graph, D) row."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--shards", default="1,2,4,8")
    ap.add_argument("--nnz-per-shard", type=int, default=200_000)
    ap.add_argument("--feat", type=int, default=32)
    ap.add_argument("--ns-per-nnz", type=float, default=None,
                    help="the tree route's ns an incidence (default: measured on the device)")
    ap.add_argument("--measure", action="store_true",
                    help="also run a gloo world of CPU ranks (structural check)")
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--out", default="weak_scaling_r2.csv")
    common.add_device_flag(ap)
    add_link_flags(ap)
    args = ap.parse_args(argv)
    device = common.resolve_device(args.device)
    link = link_model(args.links, args.ici_gbps)
    card = common.card_label(device)
    shards = [int(s) for s in args.shards.split(",")]

    points = []
    for kind in KINDS:
        for d in shards:
            hg = graph(kind, d, args.nnz_per_shard)
            ns = measured_ns(hg, args.feat, device, args.iters)
            ns_tree = ns["tree"] if args.ns_per_nnz is None else args.ns_per_nnz
            ns_al = ns["aligned"]
            plan, m = analyze(hg, d, args.feat, link, ns_tree, ns_al)
            points.append({"kind": kind, "d": d, "hg": hg, "plan": plan, "m": m,
                           "ns_tree": ns_tree, "ns_aligned": ns_al, "ns": ns})
    walls = {}
    if args.measure:
        from hypergef_tpu_torch.parallel.launch import spawn

        cases = [(f"{p['kind']},{p['d']}", p["plan"]) for p in points]
        walls = spawn(measure_rank, max(shards), backend="gloo", platform="cpu",
                      args=(cases, args.feat, args.iters))[0]

    comments = [
        "# halo weak scaling: plan-derived traffic + modeled projection",
        f"# links: {link.label()}; max_link_MB is the critical path's bytes "
        f"({'the largest pair' if link.pairwise else 'the busiest card'}), t_ici_us MODELED",
        f"# feat={args.feat} nnz_per_shard={args.nnz_per_shard}; ns/nnz MEASURED on {card}"
        + (f" (the tree's given: {args.ns_per_nnz})" if args.ns_per_nnz is not None else "")
        + "; wall_ms: a gloo world of CPU ranks, structural validation only"]
    comments += [f"# {p['kind']} D={p['d']}: ns/nnz tree {p['ns_tree']:.4f}, aligned interior "
                 f"{p['ns_aligned']:.4f}"
                 + (f" (aligned refused: {p['ns']['aligned_refused']}; the tree's rate)"
                    if "aligned_refused" in p["ns"] else "") for p in points]
    results, failures = [], []
    with common.csv(args.out, device, comments, header=HEADER) as emit:
        for p in points:
            m, kind, d = p["m"], p["kind"], p["d"]
            wall = walls.get(f"{kind},{d}")
            ratio = m["t_ici_us"] / max(m["t_compute_us"], 1e-9)
            emit(f"{kind},{d},{p['hg'].nnz},{m['comm_frac']:.4f},"
                 f"{m['interior_frac']:.4f},"
                 f"{m['total_MB']:.3f},{m['max_link_MB']:.3f},"
                 f"{m['t_ici_us']:.2f},{m['t_compute_us']:.2f},"
                 f"{m['t_compute_aligned_us']:.2f},"
                 f"{ratio:.3f},{'' if wall is None else f'{wall * 1e3:.3f}'}")
            for backend, err in p["ns"]["errors"].items():
                if not err["ok"]:
                    failures.append(f"{kind},{d}/{backend}")
            results.append({"graph": kind, "shards": d, "nnz": p["hg"].nnz, **m,
                            "ns_tree": p["ns_tree"], "ns_aligned": p["ns_aligned"],
                            "errors": p["ns"]["errors"], "wall_s": wall})
    if failures:
        raise SystemExit(f"weak_scaling: routes off the xla route's output: {failures}")
    return results


if __name__ == "__main__":
    main()
