"""fig7/fig9 analogue on the card: fused routes against the baseline
formulation, on uniform-random graphs at the datasets' dims. The port of
``experiments/fig7_9.py``.

Reference: ``experiment/fig7.cu``/``fig9.cu`` compare cuSPARSE two-step
SpMM vs the fused kernel per dataset.  Here the "cuSPARSE two-step"
analogue is the plain ``xla`` route (gathered nnz intermediates, a segment
sum) and the contenders are the ``cumsum`` / ``tree`` / ``dense`` routes
(any of the port's routes can be named). Each route's output is held
against the ``xla`` route's on the same x before it is timed (a row off
its bar is flagged ``PARITY_FAIL``); a time is ``cuda_time_ms``
(``--iters`` calls a window behind its queued sleep, median of 20), and a
route the host issues more slowly than the sleep lasts is flagged ``†``.
``--vs-ref`` adds a SUMMARY row a dataset against the RTX 3090's times of
``BASELINE.md`` §1 (two different cards).

    python -m hypergef_tpu_torch.experiments.fig7_9 --out fig7.csv
"""

from __future__ import annotations

import argparse
from typing import List, Optional

import numpy as np
import torch

from hypergef_tpu_torch.experiments import common

SHAPES = {
    "cora": (2708, 2708, 4.0),
    "citeseer": (3312, 3312, 3.2),
    # "pubmed" kept the square round-1 convention for cross-round
    # comparability; "pubmed_real" matches the reference dataset's
    # actual incidence box (19717 vertices x 7963 cocitation
    # hyperedges, AllSet/dataloader.py:31) at the same ~85k nnz
    "pubmed": (19717, 19717, 4.3),
    "pubmed_real": (19717, 7963, 10.8),
    "big": (100_000, 50_000, 10.0),
    # Remaining reference fig7 suite (BASELINE.md §1), at the
    # datasets' published incidence dims (AllSet paper Table 7 /
    # reference data/load_dataset.py loaders); connectivity is
    # synthetic uniform-random at those dims (no raw data in this
    # env — worst case for us: no community structure to exploit).
    "coauthor_cora": (2708, 1072, 4.3),
    "coauthor_dblp": (41302, 22363, 4.5),
    "NTU2012": (2012, 2012, 5.0),
    "ModelNet40": (12311, 12311, 5.0),
    "Mushroom": (8124, 298, 500.0),
    "20newsW100": (16242, 100, 654.5),
    "house-committees-100": (1290, 341, 35.0),
    "zoo": (101, 43, 39.0),
    "walmart-trips-100": (88860, 69906, 6.6),
}
# Clustered variants of the two largest suite datasets: planted
# community structure (~250 vertices/community, 2% noise) at the
# same incidence dims — the regime real coauthorship/trip data
# occupies, where the aligned banded backend applies.  Suffix
# "_clustered" routes through community_hypergraph + edge sort.
CLUSTERED = {
    "coauthor_dblp_clustered": (41302, 22363, 160, 4.5, 0.02),
    "walmart-trips-100_clustered": (88860, 69906, 355, 6.6, 0.02),
}
# RTX 3090 reference times (ms, f=32): cuSPARSE two-step and the
# tuned fused kernel (BASELINE.md §1, result.xlsx "fig7,fig9").
REF_MS_F32 = {
    "cora": (0.04067, 0.004795),
    "citeseer": (0.04039, 0.003698),
    "pubmed": (0.05767, 0.012484),
    "pubmed_real": (0.05767, 0.012484),
    "coauthor_cora": (0.03248, 0.004330),
    "coauthor_dblp": (0.10162, 0.030438),
    "NTU2012": (0.03056, 0.004630),
    "ModelNet40": (0.04477, 0.012058),
    "Mushroom": (0.03265, 0.026144),
    "20newsW100": (0.04927, 0.046639),
    "house-committees-100": (0.03420, 0.007815),
    "zoo": (0.023511, 0.0039626),
    "walmart-trips-100": (0.306176, 0.131158),
    # clustered variants compare against the same dataset's ref row
    "coauthor_dblp_clustered": (0.10162, 0.030438),
    "walmart-trips-100_clustered": (0.306176, 0.131158),
}
COMMENTS = ("# SUMMARY ref_*/vs_ref_*: the RTX 3090's times (BASELINE.md §1) against "
            "this run's best route: two different cards, not a like-for-like speed-up",)


def graph(cname: str):
    """The dataset's uniform-random graph, or its clustered variant."""
    from hypergef_tpu_torch.data.synthetic import community_hypergraph, random_hypergraph
    from hypergef_tpu_torch.sparse.reorder import apply_vertex_order

    if cname in CLUSTERED:
        n, e, comm, avg, noise = CLUSTERED[cname]
        hg = community_hypergraph(n, e, comm, avg, noise, 0)
        hg, _ = apply_vertex_order(hg, np.arange(hg.num_nodes), sort_edges=True)
        return hg
    n, e, avg = SHAPES[cname]
    return random_hypergraph(n, e, avg_edge_size=avg, seed=0, name=cname)


def main(argv: Optional[List[str]] = None) -> dict:
    """Run the sweep; returns each dataset's route times (us). Each route's
    output is held against the ``xla`` route's on the same x before it is
    timed; a route that raises or is off its bar
    (``common.route_tolerance``) is flagged and ends the run ``SystemExit``
    after the sweep."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default="fig7.csv")
    ap.add_argument("--configs", default="cora,pubmed")
    ap.add_argument("--feat", type=int, default=32)
    ap.add_argument("--backends", default="xla,cumsum,tree,dense")
    ap.add_argument("--iters", type=int, default=30,
                    help="calls a timed window (a time is the median of 20 windows)")
    ap.add_argument("--vs-ref", action="store_true",
                    help="emit per-dataset SUMMARY rows vs RTX 3090 ref")
    common.add_device_flag(ap)
    args = ap.parse_args(argv)
    device = common.resolve_device(args.device)

    from hypergef_tpu_torch.sparse.planner import plan_aggregation

    results, failures = {}, []
    with common.csv(args.out, device, COMMENTS if args.vs_ref else ()) as emit:
        for cname in args.configs.split(","):
            hg = graph(cname)
            n = hg.num_nodes
            plan = plan_aggregation(hg, device)
            hgd = hg.device_data(device)
            x0 = torch.as_tensor(
                np.random.default_rng(0)
                .normal(size=(n, args.feat))
                .astype(np.float32), device=device)
            ref = common.route_call(hgd, x0, plan, "xla")()
            base_t = None
            times = {}
            for backend in args.backends.split(","):
                if backend == "dense" and plan.dense is None:
                    continue
                if backend == "precomp" and plan.precomp is None:
                    continue
                if backend == "aligned" and plan.aligned is None:
                    continue
                call = common.route_call(hgd, x0, plan, backend)
                try:
                    e = common.route_error(call(), ref, backend)
                    r = common.time_call(call, device, args.iters)
                except Exception as ex:
                    print(f"{cname}/{backend}: FAILED {ex}", flush=True)
                    failures.append(f"{cname}/{backend}")
                    continue
                t = r.ms * 1e-3
                if base_t is None:
                    base_t = t
                times[backend] = t
                speedup = base_t / t if (base_t and t > 0) else float("nan")
                row = (f"{cname},{backend},f={args.feat},nnz={hg.nnz},"
                       f"{t*1e6:.2f}us,speedup_vs_first={speedup:.2f}" + r.flag())
                if not e["ok"]:
                    failures.append(f"{cname}/{backend}")
                    row += ",PARITY_FAIL"
                emit(row)
            results[cname] = {b: t * 1e6 for b, t in times.items()}
            # fig7 summary: the best route vs the RTX 3090 reference
            # times (vs_ref > 1 means this run was faster).
            if args.vs_ref and times and cname in REF_MS_F32 and args.feat == 32:
                ref_cus, ref_fus = REF_MS_F32[cname]
                best = min(times, key=times.get)
                best_us = times[best] * 1e6
                auto = plan.preferred_backend
                emit(
                    f"SUMMARY,{cname},nnz={hg.nnz},auto={auto},best={best},"
                    f"{best_us:.2f}us,ref_cusparse={ref_cus*1e3:.1f}us,"
                    f"ref_fused={ref_fus*1e3:.2f}us,"
                    f"vs_ref_cusparse={ref_cus*1e3/best_us:.2f},"
                    f"vs_ref_fused={ref_fus*1e3/best_us:.3f}"
                )
    if failures:
        raise SystemExit(f"fig7_9 failures: {failures}")
    return results


if __name__ == "__main__":
    main()
