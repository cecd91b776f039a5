"""The 100M-incidence projection on the card: a measured shard-size curve and
a modeled halo exchange. The port of ``experiments/scale_projection.py``.

1. MEASURES shards of :func:`~.scale_common.big_sbm` (``SHARD_SIZES``: 3.1M,
   6.2M, 12.5M and 18.7M incidences, edges sorted by median member) on the
   ``aligned`` route, in the kernel form on the card (the band kernel),
   each call held against the ``xla`` route's output on the same x and
   timed by ``common.time_call`` (10 calls a window behind a queued sleep,
   median of 20);
2. fits ``t = a + b·nnz`` over the measured points (``np.polyfit``);
3. MODELS the 8-way 100M layout: the fitted 12.5M shard plus two halo
   ``all_to_all``s of ``comm_frac`` = 0.08 of ``n_owned`` = 2.5M f32 rows
   (the JAX driver's plan-derived fraction and owned rows, properties of
   the plan, not of a chip) over the link model (``--links``).

Every measured row names the card (``nvidia-smi``'s name and power limit;
``host clock, cpu`` on the CPU), every modeled row its link model and
rate. ``--sizes N:E:COMM,...`` measures other shard sizes. A shard that
fails or is off its bar is written and ends the run ``SystemExit`` after
the sweep.

    python -m hypergef_tpu_torch.experiments.scale_projection --out scale_projection_r3.csv
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
    add_link_flags, big_sbm, link_model, sorted_edges,
)

# shard sizes: (n_nodes, n_edges, n_comm); avg edge size 10 → nnz ≈ 10·e
SHARD_SIZES = [
    (625_000, 312_500, 1250),
    (1_250_000, 625_000, 2500),
    (2_500_000, 1_250_000, 5000),
    (3_750_000, 1_875_000, 7500),
]
SHARDS = 8
FEAT = 32
COMM_FRAC = 0.08  # the JAX driver's plan-derived halo fraction (weak_scaling_r2.csv)
N_OWNED = 2_500_000  # a shard's owned rows in the 8-way 100M layout
SHARD_NNZ = 12_500_000  # the layout's shard
HEADER = "quantity,value,unit,provenance"


def parse_sizes(text: str) -> list:
    return [tuple(int(v) for v in s.split(":")) for s in text.split(",")]


def measure_shard(n, e, comm, feat, device, iters=10) -> dict:
    """One shard's aligned aggregation: its graph, plan, tables and time."""
    from hypergef_tpu_torch.sparse import planner

    t0 = time.perf_counter()
    hg = sorted_edges(big_sbm(n, e, comm, 10.0, 0.01, 0))
    gen_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    plan = planner.plan_aligned(hg)
    plan_s = time.perf_counter() - t0
    es, vs = plan.edge_stage, plan.vertex_stage
    table_gb = (es.table_bytes() + vs.table_bytes()) / 1e9
    print(f"shard nnz={hg.nnz}: gen {gen_s:.0f}s plan {plan_s:.1f}s tables {table_gb:.2f} GB "
          f"spill {es.spill_fraction:.3f}/{vs.spill_fraction:.3f}", flush=True)
    if device.type == "cuda":
        plan = dataclasses.replace(plan, form="pallas_auto")
    hgd = hg.device_data(device)
    x0 = torch.as_tensor(np.random.default_rng(0).normal(size=(n, feat)).astype(np.float32),
                         device=device)
    call = common.route_call(hgd, x0, plan, "aligned")
    err = common.route_error(call(), common.route_call(hgd, x0, None, "xla")(), "aligned")
    r = common.time_call(call, device, iters)
    t_shard = r.ms * 1e-3
    print(f"  measured {t_shard * 1e3:.1f} ms ({t_shard / hg.nnz * 1e9:.2f} ns/nnz, form "
          f"{plan.form}); against xla {err['max_abs_err']:.3e} "
          f"(bar {err['rel_tol']:g}·{err['max_abs_xla']:.3e})", flush=True)
    return dict(nnz=hg.nnz, n=n, t_s=t_shard, plan_s=plan_s, table_gb=table_gb,
                spill=float(es.spill_fraction), form=plan.form, error=err,
                host_bound=r.host_bound)


def main(argv: Optional[List[str]] = None) -> dict:
    """Measure the curve and project; returns the points, the fit and the
    projection."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default="scale_projection_r3.csv")
    ap.add_argument("--sizes", default=",".join(f"{n}:{e}:{c}" for n, e, c in SHARD_SIZES),
                    help="shard sizes to measure, N:E:COMM a shard")
    common.add_device_flag(ap)
    add_link_flags(ap)
    args = ap.parse_args(argv)
    device = common.resolve_device(args.device)
    link = link_model(args.links, args.ici_gbps)
    card = common.card_label(device)

    points, failures = [], []
    for n, e, comm in parse_sizes(args.sizes):
        try:
            p = measure_shard(n, e, comm, FEAT, device)
        except Exception as exc:  # noqa: BLE001 — reported, then the run ends
            print(f"shard ({n},{e}) FAILED: {type(exc).__name__}: {str(exc)[:120]}",
                  flush=True)
            failures.append(f"({n},{e}): {type(exc).__name__}")
            continue
        points.append(p)
        if not p["error"]["ok"]:
            failures.append(f"({n},{e}): off the xla route's output")

    comments = ["# 100M-nnz projection r3: measured shard-size CURVE + modeled halo",
                f"# comm_frac={COMM_FRAC} links={link.name} gbps={link.gbps:g} feat={FEAT} "
                "overlap_hides_collectives=yes (worst-case total adds them anyway)"]
    out = {"points": points}
    with common.csv(args.out, device, comments, header=HEADER) as emit:
        for p in points:
            emit(f"shard_compute_nnz{p['nnz']},{p['t_s'] * 1e3:.2f},ms,MEASURED on {card} "
                 f"(form {p['form']}; plan {p['plan_s']:.1f}s host; tables "
                 f"{p['table_gb']:.2f} GB; spill {p['spill']:.3f})"
                 + ("; †host-bound window" if p["host_bound"] else ""))
            emit(f"shard_ns_per_nnz_nnz{p['nnz']},{p['t_s'] / p['nnz'] * 1e9:.3f},ns/nnz,"
                 f"MEASURED on {card}")
        if len(points) >= 2:
            xs = np.array([p["nnz"] for p in points], dtype=np.float64)
            ts = np.array([p["t_s"] for p in points], dtype=np.float64)
            b, a = np.polyfit(xs, ts, 1)
            emit(f"fit_slope,{b * 1e9:.3f},ns/nnz,polyfit over {len(points)} measured shard "
                 "sizes")
            emit(f"fit_intercept,{a * 1e3:.3f},ms,per-call overhead")
            t_shard = a + b * SHARD_NNZ
            total_nnz = SHARD_NNZ * SHARDS
            t_a2a = link.halo_a2a_s(COMM_FRAC, N_OWNED, FEAT)
            t_total = t_shard + 2 * t_a2a
            emit(f"halo_a2a_per_layer,{t_a2a * 1e3:.2f},ms,{link.label()}")
            emit(f"projected_layer_100M,{t_total * 1e3:.2f},ms,"
                 "fitted shard + 2x modeled a2a (no overlap credit)")
            emit(f"projected_aggregate_ns_per_nnz,{t_total / total_nnz * 1e9:.3f},ns/nnz,"
                 f"wall time / total nnz ({SHARDS}-card throughput; MODELED exchange)")
            out.update(fit_slope_ns=b * 1e9, fit_intercept_ms=a * 1e3, t_a2a_s=t_a2a,
                       t_layer_s=t_total)
    if failures:
        raise SystemExit(f"scale_projection failures: {failures}")
    return out


if __name__ == "__main__":
    main()
