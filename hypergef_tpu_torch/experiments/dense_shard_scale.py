"""The edge-sharded int8 dense path (``parallel/dense_shard.py``) on
unstructured graphs: the port of ``experiments/dense_shard_scale.py``.

One card measures one rank's compute and models the collective:

* MEASURE: one rank's local two-stage over its int8 slice ``H_d [N,
  e_pad]`` (``dense_shard.local_two_stage``: two bf16 library products with
  f32 results, JAX's design), for the D ∈ {2, 8} slices of the shuffled
  SBM-60k; before it is timed, the D slices' partials summed and scaled by
  degV are held against the ``xla`` route's output (the bf16 bar,
  ``common.BF16_REL_TOL``);
* MODEL: the closing all-reduce of the [N, F] f32 partial as a ring over
  the link model (``--links``, :mod:`.scale_common`; a comment row names
  it: MODELED);
* COMPARE: the single-card ``tree`` route on the same graph (the ladder's
  gather route for unordered input), held against ``xla`` too.

Times by ``common.time_call`` (on the card ``cuda_time_ms``). A check off
its bar ends the run ``SystemExit`` after the sweep.

    python -m hypergef_tpu_torch.experiments.dense_shard_scale --out dense_shard_r2.csv
"""

from __future__ import annotations

import argparse
from typing import List, Optional

import numpy as np
import torch

from hypergef_tpu_torch.experiments import common
from hypergef_tpu_torch.experiments.scale_common import add_link_flags, link_model

F = 32
SHARDS = (2, 8)
HEADER = "config,backend,devices,measured_compute_us,modeled_psum_us,total_us"


def shuffled_sbm(n: int, e: int, comm: int):
    """The shuffled SBM-60k (``dense_shard_scale.py:59-65``): the structure-free
    twin of the clustered graph."""
    from hypergef_tpu_torch.data.synthetic import community_hypergraph
    from hypergef_tpu_torch.sparse.reorder import apply_vertex_order

    hg = community_hypergraph(n, e, comm, 12, 0.02, 0)
    perm = np.random.default_rng(7).permutation(hg.num_nodes)
    return apply_vertex_order(hg, perm, sort_edges=False)[0]


def main(argv: Optional[List[str]] = None) -> list:
    """Run the single-card tree and the D-way slices; returns one dict a
    row."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default="dense_shard_r2.csv")
    ap.add_argument("--nodes", type=int, default=60_000)
    ap.add_argument("--edges", type=int, default=30_000)
    ap.add_argument("--comm", type=int, default=240)
    common.add_device_flag(ap)
    add_link_flags(ap)
    args = ap.parse_args(argv)
    device = common.resolve_device(args.device)
    link = link_model(args.links, args.ici_gbps)

    from hypergef_tpu_torch.parallel.dense_shard import local_two_stage, plan_sharded_dense
    from hypergef_tpu_torch.sparse.planner import plan_aggregation

    hg = shuffled_sbm(args.nodes, args.edges, args.comm)
    n = hg.num_nodes
    print(f"graph: |V|={n} |E|={hg.num_edges} nnz={hg.nnz} "
          f"dense {n * hg.num_edges / 1e9:.2f} GB int8", flush=True)
    x0 = torch.as_tensor(np.random.default_rng(0).normal(size=(n, F)).astype(np.float32),
                         device=device)
    hgd = hg.device_data(device)
    ref = common.route_call(hgd, x0, None, "xla")()
    results, failures = [], []
    comments = [f"# modeled_psum_us: ring all-reduce of the [N, {F}] f32 partial, "
                f"{link.label()}"]
    with common.csv(args.out, device, comments, header=HEADER) as emit:
        # the single-card reference: the ladder's gather route (tree here)
        plan = plan_aggregation(hg, device, with_aligned=False)
        call = common.route_call(hgd, x0, plan, "tree")
        err = common.route_error(call(), ref, "tree")
        r = common.time_call(call, device, 10)
        tree_us = r.ms * 1e3
        print(f"single-card tree: {tree_us:.0f} us", flush=True)
        emit(f"single_chip,tree,1,{tree_us:.1f},0.0,{tree_us:.1f}" + r.flag())
        if not err["ok"]:
            failures.append("tree")
        results.append({"config": "single_chip", "backend": "tree", "devices": 1,
                        "compute_us": tree_us, "error": err, "host_bound": r.host_bound})
        degv = hgd.degV
        for d in SHARDS:
            dsplan = plan_sharded_dense(hg, d)
            locs = [dsplan.local(rank, device) for rank in range(d)]
            with torch.no_grad():
                total_out = sum(local_two_stage(loc, x0) for loc in locs) * degv
                err = common.route_error(total_out, ref, "dense")
                del total_out
                r = common.time_call(lambda: local_two_stage(locs[0], x0), device, 15)
            comp_us = r.ms * 1e3
            psum_us = link.ring_allreduce_us(n * F * 4, d)
            total = comp_us + psum_us
            mb = dsplan.table_bytes_per_device() / 1e6
            print(f"D={d}: slice {mb:.0f} MB/device, measured compute {comp_us:.0f} us, "
                  f"modeled psum {psum_us:.0f} us -> {total:.0f} us/layer "
                  f"({tree_us / total:.1f}x single-card tree); the D partials against xla "
                  f"{err['max_abs_err']:.3e} (bar {err['rel_tol']:g}·{err['max_abs_xla']:.3e})",
                  flush=True)
            emit(f"dense_shard,dense_{'i4' if dsplan.packed else 'i8'},{d},"
                 f"{comp_us:.1f},{psum_us:.1f},{total:.1f}" + r.flag())
            if not err["ok"]:
                failures.append(f"D={d}")
            results.append({"config": "dense_shard", "backend": "dense_i8", "devices": d,
                            "compute_us": comp_us, "psum_us": psum_us, "total_us": total,
                            "slice_mb": mb, "error": err, "host_bound": r.host_bound})
            del locs, dsplan
    if failures:
        raise SystemExit(f"dense_shard_scale: off the xla route's output: {failures}")
    return results


if __name__ == "__main__":
    main()
