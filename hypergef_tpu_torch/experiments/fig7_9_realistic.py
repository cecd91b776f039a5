"""fig7/fig9 on realistic (clustered) graphs with the full routing ladder,
on the card: the port of ``experiments/fig7_9_realistic.py``.

Per dataset, connectivity is community-structured at the dataset's
published incidence dims (:func:`clustered_at_dims`, the JAX driver's
generator: the same incidences from the same seed), vertex ids are
shuffled to a raw order, and the production pipeline runs from that raw
input: ``community_reorder(method="coarsen")`` → ``plan_aggregation``
(the ladder) → the HGNN aggregation timed on the plain ``xla`` route (the
cuSPARSE two-step analogue), on the ladder's pick, and on ``aligned``
where it is planned. Before its timings each route's output is held
against the ``xla`` route's on the same x (``common.route_tolerance``); a
route off its bar is flagged ``PARITY_FAIL`` and the run ends
``SystemExit``.

A time is ``cuda_time_ms`` (``--iters`` calls a window behind its queued
sleep, median of 20); a route the host issues more slowly than the sleep
lasts is flagged ``†`` in its row. ``SUMMARY`` rows set the best route
against the RTX 3090's times of ``BASELINE.md`` §1 (two different cards),
and ``# FLOOR`` rows the aligned route against the floor model at the
card's rates (``planner.card_floor_rates``).

    python -m hypergef_tpu_torch.experiments.fig7_9_realistic --out fig7_9_r4.csv
    python -m hypergef_tpu_torch.experiments.fig7_9_realistic --configs zoo --device cpu
"""

from __future__ import annotations

import argparse
import time
from typing import List, Optional

import numpy as np
import torch

from hypergef_tpu_torch.experiments import common

# Published incidence dims (AllSet raw data via the reference loaders,
# data/load_dataset.py; see fig7_9.py for provenance notes).
SHAPES = {
    "cora": (2708, 2708, 4.0),
    "citeseer": (3312, 3312, 3.2),
    "pubmed": (19717, 7963, 10.8),  # real cocitation box (dataloader.py:31)
    "coauthor_cora": (2708, 1072, 4.3),
    "coauthor_dblp": (41302, 22363, 4.5),
    "NTU2012": (2012, 2012, 5.0),
    "ModelNet40": (12311, 12311, 5.0),
    "Mushroom": (8124, 298, 500.0),
    "20newsW100": (16242, 100, 654.5),
    "house-committees-100": (1290, 341, 35.0),
    "zoo": (101, 43, 39.0),
    "walmart-trips-100": (88860, 69906, 6.6),
    "yelp": (50758, 679302, 2.7),  # AllSet dims; no ref kernel number
}

# RTX 3090 (cuSPARSE two-step, tuned fused) ms at f=32 — BASELINE.md §1.
REF_MS_F32 = {
    "cora": (0.04067, 0.004795),
    "citeseer": (0.04039, 0.003698),
    "pubmed": (0.05767, 0.012484),
    "coauthor_cora": (0.03248, 0.004330),
    "coauthor_dblp": (0.10162, 0.030438),
    "NTU2012": (0.03056, 0.004630),
    "ModelNet40": (0.04477, 0.012058),
    "Mushroom": (0.03265, 0.026144),
    "20newsW100": (0.04927, 0.046639),
    "house-committees-100": (0.03420, 0.007815),
    "zoo": (0.023511, 0.0039626),
    "walmart-trips-100": (0.306176, 0.131158),
}

HEADER = (
    "dataset,nnz,backend,us,reorder_s,plan_s,"
    "vs_ref_cusparse,vs_ref_fused"
)
COMMENTS = (
    "# vs_ref_*: the RTX 3090's ms (BASELINE.md §1) over this run's best route: "
    "two different cards, not a like-for-like speed-up",
    "# FLOOR: the aligned floor model at the card's data-sheet rates "
    "(planner.card_floor_rates), a model, not a measurement",
)


def clustered_at_dims(name, n, e, avg, noise=0.02, seed=0):
    """Community hypergraph at the dataset's real dims with exact-k
    member sampling (without replacement) so nnz lands at the real
    dataset's scale; vertices come out community-contiguous and are
    shuffled by the caller.  Community size scales with the edge size so
    giant-edge datasets (Mushroom, 20news) keep edges community-local.
    The JAX driver's generator (``:73-104``), draw for draw."""
    from hypergef_tpu_torch.sparse.hypergraph import Hypergraph

    rng = np.random.default_rng(seed)
    n_comm = max(1, min(n // 250, n // max(int(2.5 * avg), 1)))
    comm_of = np.sort(rng.integers(0, n_comm, size=n))
    starts = np.searchsorted(comm_of, np.arange(n_comm))
    ends = np.searchsorted(comm_of, np.arange(n_comm), side="right")
    vs, es = [], []
    for ei in range(e):
        c = rng.integers(0, n_comm)
        lo, hi = int(starts[c]), int(ends[c])
        if hi - lo < 2:
            lo, hi = 0, n
        k = max(int(rng.poisson(avg)), 2)
        k = min(k, hi - lo)
        members = lo + rng.choice(hi - lo, size=k, replace=False)
        flip = rng.random(k) < noise
        members[flip] = rng.integers(0, n, size=int(flip.sum()))
        members = np.unique(members)
        vs.append(members)
        es.append(np.full(len(members), ei, dtype=np.int64))
    return Hypergraph.from_coo(
        np.concatenate(vs), np.concatenate(es),
        num_nodes=n, num_edges=e, name=name,
    )


def realistic_graph(cname: str, noise: float = 0.02):
    """The production pipeline's input and its first step for a dataset:
    ``clustered_at_dims`` at its dims, shuffled to a raw order
    (``default_rng(7)``), then ``community_reorder(method="coarsen")``.
    Returns the graph and the host seconds of the generator and the
    reorder."""
    from hypergef_tpu_torch.sparse.reorder import apply_vertex_order, community_reorder

    n, e, avg = SHAPES[cname]
    t0 = time.perf_counter()
    hg = clustered_at_dims(cname, n, e, avg, noise=noise)
    gen_s = time.perf_counter() - t0
    # raw order: shuffle away the generator's community layout
    perm = np.random.default_rng(7).permutation(hg.num_nodes)
    hg, _ = apply_vertex_order(hg, perm, sort_edges=False)
    t0 = time.perf_counter()
    hg, _ = community_reorder(hg, method="coarsen")
    return hg, gen_s, time.perf_counter() - t0


def main(argv: Optional[List[str]] = None) -> list:
    """Run the sweep; returns one dict a dataset (its graph, plan, routes'
    times and errors against ``xla``, the floor), for callers in process."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default="fig7_9_r4.csv")
    ap.add_argument("--configs", default=",".join(SHAPES))
    ap.add_argument("--feat", type=int, default=32)
    ap.add_argument("--iters", type=int, default=30,
                    help="calls a timed window (a time is the median of 20 windows)")
    ap.add_argument("--noise", type=float, default=0.02)
    common.add_device_flag(ap)
    args = ap.parse_args(argv)
    device = common.resolve_device(args.device)

    from hypergef_tpu_torch.sparse.planner import (
        aligned_plan_floor, card_floor_rates, plan_aggregation,
    )

    results, failures = [], []
    with common.csv(args.out, device, COMMENTS, HEADER) as emit:
        for cname in args.configs.split(","):
            hg, gen_s, reorder_s = realistic_graph(cname, args.noise)
            t0 = time.perf_counter()
            plan = plan_aggregation(hg, device)
            plan_s = time.perf_counter() - t0
            print(f"{cname}: generated in {gen_s:.2f} s (host)", flush=True)
            hgd = hg.device_data(device)
            x0 = torch.as_tensor(
                np.random.default_rng(0)
                .normal(size=(hg.num_nodes, args.feat))
                .astype(np.float32), device=device)
            auto = plan.preferred_backend
            backends = ["xla", auto]
            if plan.aligned is not None and auto != "aligned":
                backends.append("aligned")
            res = {"dataset": cname, "hg": hg, "plan": plan, "auto": auto, "nnz": hg.nnz,
                   "generate_s": gen_s, "reorder_s": reorder_s, "plan_s": plan_s,
                   "times_us": {}, "errors": {}, "host_bound": {}}
            ref = common.route_call(hgd, x0, plan, "xla")()
            times = res["times_us"]
            for backend in backends:
                call = common.route_call(hgd, x0, plan, backend)
                try:
                    e = common.route_error(call(), ref, backend)
                    t = common.time_call(call, device, args.iters)
                except Exception as ex:
                    print(f"{cname}/{backend}: FAILED {type(ex).__name__}: "
                          f"{str(ex).splitlines()[0][:140] if str(ex) else ''}", flush=True)
                    failures.append(f"{cname}/{backend}")
                    continue
                res["errors"][backend] = e
                res["host_bound"][backend] = t.host_bound
                times[backend] = t.ms * 1e3
                row = (f"{cname},{hg.nnz},{backend},{t.ms * 1e3:.2f},"
                       f"{reorder_s:.2f},{plan_s:.2f},,") + t.flag()
                if not e["ok"]:
                    failures.append(f"{cname}/{backend}")
                    row += ",PARITY_FAIL"
                    print(f"{cname}/{backend}: output {e['max_abs_err']:.3e} from the xla "
                          f"route's, over {e['rel_tol']:g}·{e['max_abs_xla']:.3e} — row flagged",
                          flush=True)
                emit(row)
            results.append(res)
            if not times:
                continue
            best = min(times, key=times.get)
            best_us = times[best]
            ref_ms = REF_MS_F32.get(cname)
            vs_cus = f"{ref_ms[0]*1e3/best_us:.2f}" if ref_ms else ""
            vs_fus = f"{ref_ms[1]*1e3/best_us:.3f}" if ref_ms else ""
            emit(
                f"SUMMARY,{cname},nnz={hg.nnz},auto={auto},best={best},"
                f"{best_us:.2f}us,reorder={reorder_s:.2f}s,plan={plan_s:.2f}s,"
                f"xla_us={times.get('xla', float('nan')):.2f},"
                f"vs_ref_cusparse={vs_cus},vs_ref_fused={vs_fus}"
            )
            if "aligned" in times and plan.aligned is not None:
                fl = aligned_plan_floor(plan.aligned, args.feat,
                                        rates=card_floor_rates(args.feat))
                res["floor"] = fl
                m_us = times["aligned"]
                f_us = fl["floor_s"] * 1e6
                emit(
                    f"# FLOOR,{cname},hw_floor_us={f_us:.1f},"
                    f"measured_us={m_us:.2f},"
                    f"pct_of_floor={100.0*f_us/m_us:.1f},"
                    f"unique_spill_rows="
                    f"{fl['edge_stage']['unique_spill_rows']}+"
                    f"{fl['vertex_stage']['unique_spill_rows']}"
                )
    if failures:
        raise SystemExit(f"fig7_9_realistic failures: {failures}")
    return results


if __name__ == "__main__":
    main()
