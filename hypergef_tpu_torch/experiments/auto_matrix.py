"""Auto-selection matrix on the card: the port of
``experiments/auto_matrix.py``.

For each workload: time every applicable fixed route and the ladder's
pick, in one process, and record the pick's slowdown against the best
fixed route; then run the measured autotune (``autotune(hg, 32,
cache=False)``) and say whether its pick is within 1.15× of the best.
Each route's output is held against the ``xla`` route's on the same x
before it is timed. The ladder keeps the JAX package's v5e constants, so
this is where the card's own best route for each graph is recorded beside
the v5e ladder's pick.

A time is ``cuda_time_ms`` (20 calls a window behind its queued sleep,
median of 20); a route the host issues more slowly than the sleep lasts
is listed in ``host_bound`` on the printed line.

    python -m hypergef_tpu_torch.experiments.auto_matrix --out auto_matrix_r4.csv
"""

from __future__ import annotations

import argparse
from typing import List, Optional

import numpy as np
import torch

from hypergef_tpu_torch.experiments import common

F = 32
ITERS = 20  # calls a timed window (a time is the median of 20 windows)
WORKLOADS = ("cora", "20news", "pubmed_real", "pubmed_sq", "sbm60k_sorted")
HEADER = ("workload,nnz,auto_pick,auto_us,best_fixed,best_fixed_us,"
          "auto_over_best,tuned_pick,tuned_matches_best")
# a route within this factor of the best counts as the best (the JAX
# driver's chip-jitter rule)
NEAR_BEST = 1.15


def workload(name: str):
    """The JAX driver's graphs (``:33-50``), by name."""
    from hypergef_tpu_torch.data.synthetic import community_hypergraph, random_hypergraph
    from hypergef_tpu_torch.sparse.reorder import apply_vertex_order

    if name == "cora":
        return random_hypergraph(2708, 2708, avg_edge_size=4.0, seed=0, name="cora")
    if name == "20news":
        return random_hypergraph(16242, 100, avg_edge_size=654.5, seed=0, name="20news")
    if name == "pubmed_real":
        return random_hypergraph(19717, 7963, avg_edge_size=10.8, seed=0, name="pubmed_real")
    if name == "pubmed_sq":
        return random_hypergraph(19717, 19717, avg_edge_size=4.3, seed=0, name="pubmed_sq")
    if name == "sbm60k_sorted":
        sbm = community_hypergraph(60_000, 30_000, 240, 12, 0.02, 0)
        sbm, _ = apply_vertex_order(sbm, np.arange(sbm.num_nodes), sort_edges=True)
        return sbm
    raise ValueError(f"unknown workload {name!r}; known: {WORKLOADS}")


def applicable_backends(plan):
    out = []
    if plan.precomp is not None:
        out.append("precomp")
    if plan.dense is not None:
        out.append("dense")
    if plan.aligned is not None:
        out.append("aligned")
    out += ["cumsum", "tree"]
    return out


def main(argv: Optional[List[str]] = None) -> list:
    """Run the matrix; returns one dict a workload (its plan, each route's
    time and its output's gap to the ``xla`` route's). A route that raises
    or is off its bar (``common.route_tolerance``) ends the run
    ``SystemExit`` after the sweep."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default="auto_matrix_r4.csv")
    ap.add_argument("--workloads", default=",".join(WORKLOADS))
    common.add_device_flag(ap)
    args = ap.parse_args(argv)
    device = common.resolve_device(args.device)

    from hypergef_tpu_torch.sparse.autotune import autotune
    from hypergef_tpu_torch.sparse.planner import plan_aggregation

    results, failures = [], []
    with common.csv(args.out, device, header=HEADER) as emit:
        for name in args.workloads.split(","):
            hg = workload(name)
            plan = plan_aggregation(hg, device)
            hgd = hg.device_data(device)
            x0 = torch.as_tensor(np.random.default_rng(0)
                                 .normal(size=(hg.num_nodes, F)).astype(np.float32),
                                 device=device)
            ref = common.route_call(hgd, x0, plan, "xla")()
            times, errors, host_bound = {}, {}, []
            for backend in applicable_backends(plan):
                call = common.route_call(hgd, x0, plan, backend)
                try:
                    e = common.route_error(call(), ref, backend)
                    r = common.time_call(call, device, ITERS)
                except Exception as ex:
                    print(f"{name}/{backend}: FAILED {type(ex).__name__}", flush=True)
                    failures.append(f"{name}/{backend}")
                    continue
                errors[backend] = e
                if not e["ok"]:
                    failures.append(f"{name}/{backend}")
                    print(f"{name}/{backend}: PARITY_FAIL {e['max_abs_err']:.3e} from the xla "
                          f"route's, over {e['rel_tol']:g}·{e['max_abs_xla']:.3e}", flush=True)
                times[backend] = r.ms * 1e3
                if r.host_bound:
                    host_bound.append(backend)
            if not times:
                continue
            auto_pick = plan.preferred_backend
            auto_us = times.get(auto_pick, float("nan"))
            best = min(times, key=times.get)
            # the measured tuner, with no cached pick to hide its sweep
            tuned = autotune(hg, F, cache=False, device=device)
            near_best = [b for b, t in times.items()
                         if t <= times[best] * NEAR_BEST]
            emit(f"{name},{hg.nnz},{auto_pick},{auto_us:.1f},{best},"
                 f"{times[best]:.1f},{auto_us / times[best]:.3f},"
                 f"{tuned.backend},{tuned.backend in near_best}")
            print("|", {k: round(v, 1) for k, v in times.items()},
                  f"host_bound={host_bound}" if host_bound else "", flush=True)
            results.append({"workload": name, "nnz": hg.nnz, "plan": plan,
                            "auto_pick": auto_pick, "best_fixed": best, "times_us": times,
                            "errors": errors, "tuned_pick": tuned.backend,
                            "tuned_params": tuned.params, "near_best": near_best,
                            "host_bound": host_bound})
    print("wrote", args.out, flush=True)
    if failures:
        raise SystemExit(f"auto_matrix failures: {failures}")
    return results


if __name__ == "__main__":
    main()
