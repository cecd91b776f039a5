"""Large-graph scaling of the aligned aggregation on the card: the port of
``experiments/scale_aligned.py``.

Two configurations of :func:`~.scale_common.big_sbm`, edges sorted by
median member:

* ``pubmed_clustered``: pubmed-shaped (19717², nnz ≈ 85k) with planted
  communities; the reference's fused kernel takes 12.484 µs there on an
  RTX 3090 (``BASELINE.md`` §1), written ``vs_ref3090`` (that card's time
  over this one's, two cards);
* ``sbm10m``: 2M vertices × 1M hyperedges, avg 10, nnz ≈ 10M.

Each runs ``aligned`` (the kernel form on the card, the band kernel; the
plain form on the CPU) against ``tree``, each call held against the
``xla`` route's output on the same x (``common.route_tolerance``) and
timed by ``common.time_call`` (``--iters`` calls a window behind a queued
sleep, median of 20; the tree at more than 5M incidences 10 calls a
window, as JAX caps it). ``plan_s`` is the plan's host seconds,
``compile=`` the first call's seconds (the stages put on the device; there
is no compile). A plan the planner refuses is written ``REFUSED``; a route
that fails or is off its bar ``FAILED`` or ``PARITY_FAIL``, and ends the
run ``SystemExit`` after the sweep.

    python -m hypergef_tpu_torch.experiments.scale_aligned --out scale_aligned_r3.csv
"""

from __future__ import annotations

import argparse
import dataclasses
import time
from typing import List, Optional

import numpy as np
import torch

from hypergef_tpu_torch.experiments import common
from hypergef_tpu_torch.experiments.scale_common import big_sbm, sorted_edges

CONFIGS = {
    "pubmed_clustered": dict(n=19717, e=19717, comm=80, avg=4.3, noise=0.01,
                             ref_us=12.484, also_tree=True),
    "sbm10m": dict(n=2_000_000, e=1_000_000, comm=4000, avg=10.0, noise=0.01,
                   ref_us=None, also_tree=True),
}
HEADER = "config,nnz,backend,per_iter_us,ns_per_nnz,plan_s,extra"


def main(argv: Optional[List[str]] = None) -> list:
    """Run the configurations; returns one dict a timed route (config, nnz,
    µs, ns/nnz, plan seconds, its gap to ``xla``)."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--configs", nargs="*", default=list(CONFIGS))
    ap.add_argument("--feat", type=int, default=32)
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--out", default="scale_aligned_r3.csv")
    common.add_device_flag(ap)
    args = ap.parse_args(argv)
    device = common.resolve_device(args.device)

    from hypergef_tpu_torch.sparse import planner

    results, failures = [], []
    with common.csv(args.out, device, [f"# aligned scaling f={args.feat} dev={device.type}"],
                    header=HEADER) as emit:
        for cname in args.configs:
            c = CONFIGS[cname]
            t0 = time.time()
            hg = sorted_edges(big_sbm(c["n"], c["e"], c["comm"], c["avg"], c["noise"], 0))
            print(f"{cname}: nnz={hg.nnz} gen {time.time() - t0:.1f}s", flush=True)
            hgd = hg.device_data(device)
            x0 = torch.as_tensor(np.random.default_rng(0).normal(
                size=(hg.num_nodes, args.feat)).astype(np.float32), device=device)
            ref = common.route_call(hgd, x0, None, "xla")()
            cands = []
            t0 = time.time()
            try:
                al = planner.plan_aligned(hg)
                tplan = time.time() - t0
                sp = round(max(al.edge_stage.spill_fraction, al.vertex_stage.spill_fraction), 4)
                wbs = f"{al.edge_stage.window_blocks}/{al.vertex_stage.window_blocks}"
                if device.type == "cuda":
                    al = dataclasses.replace(al, form="pallas_auto")
                cands.append(("aligned", al, tplan, f"spill={sp};wb={wbs};form={al.form}"))
            except (ValueError, MemoryError) as exc:
                emit(f"{cname},{hg.nnz},aligned,REFUSED,,,{type(exc).__name__}")
            if c["also_tree"]:
                t0 = time.time()
                tp = planner.plan_tree(hg)
                cands.append(("tree", tp, time.time() - t0, ""))
            for backend, plan, tplan, extra in cands:
                try:
                    call = common.route_call(hgd, x0, plan, backend)
                    t0 = time.perf_counter()
                    err = common.route_error(call(), ref, backend)
                    common.sync(device)
                    first_s = time.perf_counter() - t0
                    leg_iters = (min(args.iters, 10) if backend == "tree" and hg.nnz > 5_000_000
                                 else args.iters)
                    r = common.time_call(call, device, leg_iters)
                    us = r.ms * 1e3
                    row = (f"{cname},{hg.nnz},{backend},{us:.1f},{1e3 * us / hg.nnz:.2f},"
                           f"{tplan:.1f},{extra};compile={first_s:.0f}s")
                    if c["ref_us"] and backend == "aligned":
                        row += f";vs_ref3090={c['ref_us'] / us:.3f}"
                    row += r.flag()
                    if not err["ok"]:
                        failures.append(f"{cname}/{backend}")
                        row += ",PARITY_FAIL"
                    results.append({"config": cname, "nnz": hg.nnz, "backend": backend,
                                    "us": us, "ns_per_nnz": 1e3 * us / hg.nnz, "plan_s": tplan,
                                    "form": getattr(plan, "form", None), "error": err,
                                    "host_bound": r.host_bound})
                except Exception as exc:  # noqa: BLE001 — written, then the run ends
                    row = (f"{cname},{hg.nnz},{backend},FAILED,,,"
                           f"{type(exc).__name__}: {str(exc)[:80]}")
                    failures.append(f"{cname}/{backend}")
                emit(row)
            del hgd, x0, ref
    if failures:
        raise SystemExit(f"scale_aligned failures: {failures}")
    return results


if __name__ == "__main__":
    main()
