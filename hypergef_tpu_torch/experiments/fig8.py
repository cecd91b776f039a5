"""fig8 analogue on the card: the memory traffic of the aggregation routes.
The port of ``experiments/fig8.py``.

Reference: ``experiment/fig8.py`` profiles DRAM sectors (Nsight Compute)
for cuSPARSE against the fused kernel; the JAX twin reads XLA's cost
analysis of each route's compiled forward. Here: the port's op-level count
of one eager forward (``utils/profiling.py::traffic_report``), after a
first call that builds the route's device tables (JAX's jit holds them as
constants): each aten op moves its distinct operands once and its outputs
once, each hand-written kernel counts as one op by its declared count. The
counts are not XLA's: XLA counts after fusion and prices cumsum as a
reduce-window; the port counts unfused eager ops and its segment-sum
kernel as one op. Where a route's aten path differs by device (the bf16
products with an f32 result, ``ops/fused.py::_mm_f32`` and
``ops/tree.py::bmm_f32``, cast both operands to f32 on the CPU), its
card and CPU counts differ.

    python -m hypergef_tpu_torch.experiments.fig8
    python -m hypergef_tpu_torch.experiments.fig8 --configs cora --device cpu
"""

from __future__ import annotations

import argparse
from typing import List, Optional

import torch

from hypergef_tpu_torch.experiments import common

SHAPES = {
    "cora": (2708, 2708, 4.0),
    "pubmed": (19717, 19717, 4.3),
}


def main(argv: Optional[List[str]] = None) -> list:
    """Count each route's forward for each graph; returns one dict a row
    (graph, route, flops, bytes, ratio to the ``xla`` route's bytes)."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default="fig8.csv")
    ap.add_argument("--configs", default="cora,pubmed")
    ap.add_argument("--feat", type=int, default=32)
    common.add_device_flag(ap)
    args = ap.parse_args(argv)
    device = common.resolve_device(args.device)

    from hypergef_tpu_torch.data.synthetic import random_hypergraph
    from hypergef_tpu_torch.sparse.planner import plan_aggregation
    from hypergef_tpu_torch.utils.profiling import traffic_report

    rows = []
    with common.csv(args.out, device) as emit:
        for cname in args.configs.split(","):
            n, e, avg = SHAPES[cname]
            hg = random_hypergraph(n, e, avg_edge_size=avg, seed=0, name=cname)
            plan = plan_aggregation(hg, device)
            hgd = hg.device_data(device)
            x = torch.ones((n, args.feat), dtype=torch.float32, device=device)
            backends = {"xla": "xla", "cumsum": "cumsum", "tree": "tree"}
            if plan.dense is not None:
                backends["dense"] = "dense"
            steps = {name: (lambda a, b=b: common.route_call(hgd, a, plan, b)())
                     for name, b in backends.items()}
            for step in steps.values():  # each route's lazy device tables, built once
                step(x)
            rep = traffic_report(steps, x, device=device)
            for name, row in rep.items():
                ratio = row.get("bytes_ratio_vs_baseline", 1.0)
                emit(f"{cname},{name},bytes={row['bytes_accessed']:.0f},"
                     f"flops={row['flops']:.0f},ratio={ratio:.3f}")
                rows.append({"graph": cname, "route": name, "bytes": row["bytes_accessed"],
                             "flops": row["flops"], "ratio": ratio})
    return rows


if __name__ == "__main__":
    main()
