"""The 100M-incidence halo layer measured by serialized execution on one
card: the port of ``experiments/scale_serialized.py``.

Builds the real D-shard halo plan of a :func:`~.scale_common.big_sbm`
graph (aligned interior, ``aligned_spill_limit=1 << 30``) and runs the D
shard programs back to back on the card
(``parallel.serial_halo.serialized_halo_forward``), the two exchanges staged
through the host. Reported:

* each shard's chained compute on the card: ``halo_aggr.shard_compute``
  over shard 0's ``ShardTables`` (the interior V→E on the band kernel, the
  boundary V→E over the received rows, E→V), timed by
  ``common.time_call`` (``cuda_time_ms``: ``--iters`` calls a window
  behind a queued sleep, median of 20);
* the real exchange bytes from the plan's masks; the transfer over them
  is the one modeled term (``--links``, :mod:`.scale_common`);
* the serialized layer's wall time (staging included), its output finite
  and, up to ``PARITY_MAX_NNZ`` incidences, within the bf16 bar of the
  ``xla`` route's on the same x;
* with ``--epoch``, one serialized full-batch step (forward, loss,
  backward, AdamW; ``serialized_halo_train_epochs``), its loss near ln(8)
  at initialization.

Every measured row names the card (``nvidia-smi``'s name and power limit),
every modeled row its link model and rate. ``--plan-cache DIR`` keeps the
plan on disk (``sparse.plancache.cached_plan_halo``).

    python -m hypergef_tpu_torch.experiments.scale_serialized --epoch --out scale_serialized_r5.csv
"""

from __future__ import annotations

import argparse
import time
from typing import List, Optional

import numpy as np
import torch

from hypergef_tpu_torch.experiments import common
from hypergef_tpu_torch.experiments.scale_common import (
    add_link_flags, big_sbm, link_model, sorted_edges,
)

HEADER = "quantity,value,unit,provenance"
NCLASS = 8
# the layer is also held against the xla route up to this many incidences
# (the route's [nnz, F] f32 intermediate on the card)
PARITY_MAX_NNZ = 30_000_000


def main(argv: Optional[List[str]] = None) -> dict:
    """Run the layer (and with ``--epoch`` a step); returns its numbers."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--nodes", type=int, default=20_000_000)
    ap.add_argument("--edges", type=int, default=10_000_000)
    ap.add_argument("--comm", type=int, default=40_000)
    ap.add_argument("--avg", type=float, default=10.0)
    ap.add_argument("--shards", type=int, default=8)
    ap.add_argument("--feat", type=int, default=32)
    ap.add_argument("--iters", type=int, default=5)
    ap.add_argument("--out", default="scale_serialized_r5.csv")
    ap.add_argument("--plan-cache", default=None,
                    help="a directory that keeps the halo plan across runs")
    ap.add_argument("--epoch", action="store_true",
                    help="also measure one serialized full train step (fwd+loss+bwd+AdamW)")
    ap.add_argument("--skip-layer", action="store_true",
                    help="skip the layer measurement (with --epoch: the step alone)")
    common.add_device_flag(ap)
    add_link_flags(ap)
    args = ap.parse_args(argv)
    device = common.resolve_device(args.device)
    link = link_model(args.links, args.ici_gbps)
    card = common.card_label(device)

    from hypergef_tpu_torch.parallel.halo import plan_halo
    from hypergef_tpu_torch.parallel.halo_aggr import shard_compute, shard_vertex_features
    from hypergef_tpu_torch.parallel.serial_halo import ShardTables, serialized_halo_forward
    from hypergef_tpu_torch.sparse.plancache import cached_plan_halo

    t0 = time.time()
    hg = sorted_edges(big_sbm(args.nodes, args.edges, args.comm, args.avg, 0.01, 0))
    gen_s = time.time() - t0
    print(f"graph: nnz={hg.nnz} gen {gen_s:.0f}s", flush=True)
    t0 = time.time()
    # the raised spill cap of the JAX driver: a large shard's uniform
    # interior pads its spill table past the default 2^28 guard
    kw = dict(local_form="aligned", aligned_spill_limit=1 << 30)
    if args.plan_cache:
        plan = cached_plan_halo(hg, args.shards, cache_dir=args.plan_cache, device=device.type,
                                **kw)
    else:
        plan = plan_halo(hg, args.shards, **kw)
    plan_s = time.time() - t0
    print(f"halo plan ({plan.local_form} interior): {plan_s:.0f}s, "
          f"comm_frac={plan.comm_fraction():.4f} halo_frac={plan.halo_comm_fraction():.4f}",
          flush=True)
    x = np.random.default_rng(0).normal(size=(hg.num_nodes, args.feat)).astype(np.float32)

    comments = ["# 100M-nnz halo layer r5: serialized MEASUREMENT (one card, host-staged "
                "exchanges); the link transfer is the only modeled term"]
    cut = {k: (getattr(args, k), ap.get_default(k)) for k in ("nodes", "edges", "comm")
           if getattr(args, k) != ap.get_default(k)}
    if cut:
        comments.append("# size cut from the default: " + ", ".join(
            f"--{k} {v} (default {d})" for k, (v, d) in cut.items()))
    res = {"nnz": hg.nnz, "plan_s": plan_s, "local_form": plan.local_form}
    with common.csv(args.out, device, comments, header=HEADER) as emit:
        emit(f"graph_nnz,{hg.nnz},nnz,generated community graph "
             f"({args.nodes}x{args.edges} comm={args.comm})")
        emit(f"plan_build,{plan_s:.0f},s,MEASURED host ({plan.local_form} interior)")
        if args.epoch:
            from hypergef_tpu_torch.parallel.serial_halo_train import (
                serialized_halo_train_epochs,
            )

            y = np.random.default_rng(1).integers(0, NCLASS, size=hg.num_nodes).astype(np.int32)
            mask = (np.random.default_rng(2).random(hg.num_nodes) < 0.5).astype(np.float32)
            est = {}
            t0 = time.time()
            _, losses = serialized_halo_train_epochs(plan, x, y, mask, nhid=args.feat,
                                                     nclass=NCLASS, epochs=1, stats=est,
                                                     device=device)
            ep_wall = time.time() - t0
            dev_s = float(np.sum(est.get("per_shard_wall_s", [0.0])))
            print(f"serialized TRAIN EPOCH wall {ep_wall:.1f}s (turns' wall {dev_s:.1f}s) "
                  f"loss {losses[0]:.4f}", flush=True)
            emit(f"train_epoch_wall,{ep_wall:.1f},s,MEASURED(serialized) one full-batch "
                 f"fwd+loss+bwd+AdamW step on one card ({card}) incl host staging "
                 f"(2-layer HGNN nhid={args.feat})")
            emit(f"train_epoch_loss,{losses[0]:.4f},nll,sanity (finite, "
                 f"~ln({NCLASS})={np.log(NCLASS):.2f} at init)")
            res.update(train_epoch_wall_s=ep_wall, train_epoch_loss=losses[0])
        if not args.skip_layer:
            # built after the step's own (which it drops): one set in pinned memory
            tables = ShardTables(plan, device)
            stats = {}
            t0 = time.time()
            out = serialized_halo_forward(plan, x, stats=stats, device=device, tables=tables)
            wall_s = time.time() - t0
            finite = bool(np.isfinite(out).all())
            print(f"serialized layer wall {wall_s:.1f}s; halo "
                  f"{stats['halo_bytes_real'] / 1e6:.1f} MB, return "
                  f"{stats['return_bytes_real'] / 1e6:.1f} MB", flush=True)
            err = None
            if hg.nnz <= PARITY_MAX_NNZ:
                hgd = hg.device_data(device)
                xd = torch.as_tensor(x, device=device)
                ref = common.route_call(hgd, xd, None, "xla")()
                err = common.route_error(torch.as_tensor(out, device=device), ref, "aligned")
                del hgd, xd, ref
            # shard 0's chained compute on the card (every shard runs this
            # program on its own tables)
            D, f = plan.n_shards, args.feat
            xs = shard_vertex_features(plan, x).reshape(D, plan.n_own, f)
            loc = tables.local(0)
            x_blk = torch.as_tensor(xs[0], device=device)
            halo_in = torch.zeros((D, plan.b_cap_h, f), device=device)

            def step():
                with torch.no_grad():
                    return shard_compute(plan, loc, x_blk, halo_in)

            r = common.time_call(step, device, args.iters)
            del loc, x_blk, halo_in
            t_shard = r.ms * 1e-3
            shard_nnz = hg.nnz / D
            print(f"chained shard compute: {t_shard * 1e3:.2f} ms "
                  f"({t_shard / shard_nnz * 1e9:.2f} ns/nnz)", flush=True)
            t_link = link.exchange_s(stats["halo_bytes_real"], stats["return_bytes_real"],
                                     args.shards)
            t_layer = t_shard + t_link
            emit(f"shard_compute,{t_shard * 1e3:.3f},ms,MEASURED(serialized) chained on "
                 f"{card}; all {D} shards share this program shape" + r.flag())
            emit(f"shard_ns_per_nnz,{t_shard / shard_nnz * 1e9:.3f},ns/nnz,"
                 f"MEASURED(serialized) on {card}")
            emit(f"halo_buffer,{stats['halo_bytes_real'] / 1e6:.1f},MB,REAL plan mask sum")
            emit(f"return_buffer,{stats['return_bytes_real'] / 1e6:.1f},MB,REAL plan mask sum")
            emit(f"ici_transfer,{t_link * 1e3:.3f},ms,{link.label()} over real buffer bytes")
            emit(f"layer_100M,{t_layer * 1e3:.3f},ms,MEASURED(serialized) shard compute on "
                 f"{card} + MODELED transfer only")
            emit(f"aggregate_ns_per_nnz,{t_layer / hg.nnz * 1e9:.3f},ns/nnz,"
                 f"layer time / total nnz ({args.shards}-card slice throughput)")
            emit(f"serialized_wall,{wall_s:.1f},s,full layer on one card ({card}) incl. host "
                 "staging (provenance)")
            if err is not None:
                emit(f"layer_vs_xla_max_abs,{err['max_abs_err']:.3e},abs,the serialized layer "
                     f"against the xla route, bar {err['rel_tol']:g}·{err['max_abs_xla']:.3e}")
            res.update(finite=finite, error=err, shard_compute_s=t_shard, t_link_s=t_link,
                       layer_s=t_layer, wall_s=wall_s, halo_bytes=stats["halo_bytes_real"],
                       return_bytes=stats["return_bytes_real"], host_bound=r.host_bound)
            if not finite or (err is not None and not err["ok"]):
                raise SystemExit(f"scale_serialized: the layer's output is not finite or off "
                                 f"the xla route's: finite={finite}, {err}")
    return res


if __name__ == "__main__":
    main()
