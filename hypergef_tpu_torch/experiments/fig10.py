"""fig10 analogue on the card: the chunk-size (ngs) sweep of the ``tree``
route. The port of ``experiments/fig10.py``.

Reference: ``experiment/fig10.cu`` sweeps partition sizes 4…600 with and
without shared-memory grouping.  Here: sweep the planner's ngs for the
tree route (``plan_tree(hg, ngs=...)``) and report the tree's depth and the
time a call (``cuda_time_ms``: ``--iters`` calls a window behind its
queued sleep, median of 20; ``†`` where the host issues a window more
slowly than the sleep lasts). ``compile=`` is the seconds of the first
call, which puts the plan's stages on the device (there is no compile);
that call's output is held against the ``xla`` route's on the same x
(``common.route_tolerance``), and a row off its bar is flagged
``PARITY_FAIL``.

    python -m hypergef_tpu_torch.experiments.fig10 --config 20news
"""

from __future__ import annotations

import argparse
import time
from typing import List, Optional

import numpy as np
import torch

from hypergef_tpu_torch.experiments import common

SHAPES = {
    "20news": (16242, 100, 654.5),
    "Mushroom": (8124, 298, 500.0),
    "cora": (2708, 2708, 4.0),
}


def main(argv: Optional[List[str]] = None) -> list:
    """Run the sweep; returns one dict an ngs (its depth, time, and the
    tree route's gap to the ``xla`` route's output on the same x). An ngs
    off the bar ends the run ``SystemExit`` after the sweep."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default="fig10.csv")
    ap.add_argument("--config", default="20news")
    ap.add_argument("--feat", type=int, default=32)
    ap.add_argument("--ngs", default="4,8,16,32,64,128")
    ap.add_argument("--iters", type=int, default=30,
                    help="calls a timed window (a time is the median of 20 windows)")
    common.add_device_flag(ap)
    args = ap.parse_args(argv)
    device = common.resolve_device(args.device)

    from hypergef_tpu_torch.data.synthetic import random_hypergraph
    from hypergef_tpu_torch.sparse.planner import plan_tree

    n, e, avg = SHAPES[args.config]
    hg = random_hypergraph(n, e, avg_edge_size=avg, seed=0, name=args.config)
    hgd = hg.device_data(device)
    x0 = torch.as_tensor(
        np.random.default_rng(0).normal(size=(n, args.feat)).astype(np.float32), device=device)
    ref = common.route_call(hgd, x0, None, "xla")()
    results, failures = [], []
    with common.csv(args.out, device) as emit:
        for ngs in map(int, args.ngs.split(",")):
            plan = plan_tree(hg, ngs=ngs)
            call = common.route_call(hgd, x0, plan, "tree")
            t0 = time.perf_counter()
            err = common.route_error(call(), ref, "tree")
            common.sync(device)
            first_s = time.perf_counter() - t0
            r = common.time_call(call, device, args.iters)
            depth = plan.depth()
            row = (f"{args.config},ngs={ngs},depth={depth},"
                   f"{r.ms * 1e3:.2f}us,compile={first_s:.1f}s" + r.flag())
            if not err["ok"]:
                failures.append(ngs)
                row += ",PARITY_FAIL"
            emit(row)
            results.append({"ngs": ngs, "depth": depth, "us": r.ms * 1e3,
                            "first_call_s": first_s, "host_bound": r.host_bound,
                            "error": err})
    if failures:
        raise SystemExit(f"fig10: the tree route off the xla route's output at ngs {failures}")
    return results


if __name__ == "__main__":
    main()
