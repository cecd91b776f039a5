"""Halo collective / compute overlap profile: the port of
``experiments/halo_overlap.py``.

Overlap needs one structural property: the interior V→E work has no data
dependence on the halo ``all_to_all``. The JAX driver checks it on the
traced program; the port checks it on one rank's run of the halo layer
(``utils/introspect.py``'s taint walk over a gloo world of CPU ranks, one
world for every shard count) and quantifies the overlap budget a
workload:

* ``interior_frac``: the share of local V→E edge work that needs no
  exchange (from the plan);
* ``independent_elems`` / ``downstream_elems``: output elements of the
  aten ops after the first ``all_to_all`` that do not / do read its data
  (counts of aten ops, not of jaxpr equations: compared to JAX's only by
  sign);
* ``t_a2a_us``: the halo ``all_to_all`` over the link model (``--links``;
  MODELED, the critical path's bytes);
* ``t_interior_us``: interior nnz × the ``tree`` route's ns/nnz MEASURED
  on the device for that graph (``weak_scaling.measured_ns``;
  ``--ns-per-nnz`` overrides);
* ``coverage`` = min(1, t_interior / t_a2a): 1.0 means the exchange can
  hide entirely;
* ``chain_ok``: the return ``all_to_all`` reads tainted data, the output
  depends on the exchange and some work is independent.

    python -m hypergef_tpu_torch.experiments.halo_overlap --shards 2,4,8 --out halo_overlap_r2.csv
"""

from __future__ import annotations

import argparse
from typing import List, Optional

import numpy as np
import torch

from hypergef_tpu_torch.experiments import common
from hypergef_tpu_torch.experiments.scale_common import add_link_flags, link_model

HEADER = ("graph,shards,interior_frac,independent_elems,downstream_elems,"
          "halo_MB_maxlink,t_a2a_us,t_interior_us,coverage,chain_ok")


def walk_rank(cases, feat: int) -> dict:
    """In each rank of a gloo world of CPU ranks: for each (key, plan) one
    halo layer under the taint walk on the ranks below the plan's shard
    count (a group of its own); rank 0's reports."""
    import torch.distributed as dist

    from hypergef_tpu_torch.parallel.halo_aggr import halo_hgnn_aggregate, own_block
    from hypergef_tpu_torch.parallel.mesh import make_mesh
    from hypergef_tpu_torch.utils.introspect import collective_overlap_report

    rank, out = dist.get_rank(), {}
    for key, plan in cases:
        group = dist.new_group(ranks=list(range(plan.n_shards)))
        if rank >= plan.n_shards:
            continue
        mesh = make_mesh(group=group)
        x = np.zeros((plan.n_shards * plan.n_own, feat), np.float32)
        xb = torch.as_tensor(own_block(plan, x, rank))
        plan.local(rank, xb.device)  # the tables built before the walk
        with torch.no_grad():
            rep = collective_overlap_report(
                lambda xo: halo_hgnn_aggregate(plan, xo, mesh=mesh), xb)
        out[key] = rep
    return out


def main(argv: Optional[List[str]] = None) -> list:
    """Run the profile; returns one dict a (graph, D) row."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--shards", default="2,4,8")
    ap.add_argument("--nnz-per-shard", type=int, default=200_000)
    ap.add_argument("--feat", type=int, default=32)
    ap.add_argument("--ns-per-nnz", type=float, default=None,
                    help="the interior's ns an incidence (default: the tree route's, "
                    "measured on the device)")
    ap.add_argument("--iters", type=int, default=20,
                    help="calls a timed window of the ns/nnz measurement")
    ap.add_argument("--out", default="halo_overlap_r2.csv")
    common.add_device_flag(ap)
    add_link_flags(ap)
    args = ap.parse_args(argv)
    device = common.resolve_device(args.device)
    link = link_model(args.links, args.ici_gbps)
    card = common.card_label(device)

    from hypergef_tpu_torch.experiments.weak_scaling import KINDS, graph, measured_ns
    from hypergef_tpu_torch.parallel.halo import plan_halo
    from hypergef_tpu_torch.parallel.launch import spawn

    shards = [int(s) for s in args.shards.split(",")]
    points = []
    for kind in KINDS:
        for d in shards:
            hg = graph(kind, d, args.nnz_per_shard)
            ns = ({"tree": args.ns_per_nnz, "errors": {}} if args.ns_per_nnz is not None
                  else measured_ns(hg, args.feat, device, args.iters, aligned=False))
            points.append({"kind": kind, "d": d, "hg": hg, "plan": plan_halo(hg, d), "ns": ns})
    reports = spawn(walk_rank, max(shards), backend="gloo", platform="cpu",
                    args=([(f"{p['kind']},{p['d']}", p["plan"]) for p in points],
                          args.feat))[0]

    comments = [
        "# halo overlap profile: taint-walk-verified collective-independent interior "
        "compute + modeled hiding coverage",
        f"# links: {link.label()}; halo_MB_maxlink the critical path's bytes "
        f"({'the largest pair' if link.pairwise else 'the busiest card'}), t_a2a_us MODELED",
        f"# feat={args.feat} nnz_per_shard={args.nnz_per_shard}; ns/nnz (the interior's, "
        + ("given" if args.ns_per_nnz is not None else f"the tree route's MEASURED on {card}")
        + "): " + "; ".join(f"{p['kind']} D={p['d']} {p['ns']['tree']:.4f}" for p in points),
        "# elems: output elements of aten ops of rank 0 after its first all_to_all (a gloo "
        "world of CPU ranks)"]
    results, failures = [], []
    with common.csv(args.out, device, comments, header=HEADER) as emit:
        for p in points:
            plan, hg, d = p["plan"], p["hg"], p["d"]
            rep = reports[f"{p['kind']},{d}"]
            halo_rows = plan.halo_mask.sum(axis=2)
            np.fill_diagonal(halo_rows, 0.0)
            max_link_b = link.a2a_rows(halo_rows) * args.feat * 4
            t_a2a = link.a2a_us(max_link_b)
            int_nnz = hg.nnz * plan.interior_fraction() / d
            t_int = int_nnz * p["ns"]["tree"] * 1e-3
            cov = min(1.0, t_int / t_a2a) if t_a2a > 0 else 1.0
            ok = (rep["chain"] and rep["output_depends_on_collective"]
                  and rep["independent_elems"] > 0)
            emit(f"{p['kind']},{d},{plan.interior_fraction():.4f},"
                 f"{rep['independent_elems']},{rep['downstream_elems']},"
                 f"{max_link_b / 1e6:.3f},{t_a2a:.2f},{t_int:.2f},"
                 f"{cov:.3f},{ok}")
            failures += [f"{p['kind']},{d}/{b}" for b, e in p["ns"]["errors"].items()
                         if not e["ok"]]
            results.append({"graph": p["kind"], "shards": d,
                            "interior_frac": plan.interior_fraction(), **rep,
                            "halo_MB_maxlink": max_link_b / 1e6, "t_a2a_us": t_a2a,
                            "t_interior_us": t_int, "coverage": cov, "chain_ok": ok,
                            "ns_tree": p["ns"]["tree"], "errors": p["ns"]["errors"]})
    if failures:
        raise SystemExit(f"halo_overlap: routes off the xla route's output: {failures}")
    return results


if __name__ == "__main__":
    main()
