"""Serving-path measurement on the card: the port of
``experiments/serve_bench.py``.

The deployment unit is a ``torch.export`` artifact of the full-graph
forward (``serve.export_trainer``), loaded in a fresh server
(``ServingModel.load``) and called repeatedly. Per workload, in one
process:

* ``export_s``     — trained Trainer → the artifact on disk;
* ``artifact_mb``  — its size on disk;
* ``load_s``       — read + ``torch.export.load`` (the recording of the
  request's CUDA graph not included);
* ``first_call_s`` — the first ``predict`` with that recording;
* ``warm_ms_*``    — request latency on the host's clock, each call
  waited for (the host's issue included — that is serving latency):
  median and p95 over ``--calls`` calls, and the qps it gives;
* ``direct_ms_median`` — the live Trainer's captured forward
  (``Trainer.predict``), the no-serialization control;
* ``dev_us_forward`` / ``dev_us_direct`` — a loaded request's and the
  live forward's device time behind the queued sleep (``cuda_time_ms``,
  ``--dev-iters`` calls a window, median of 20);
* ``parity_max_abs`` — max |first answer − live forward|: a row at or over
  1e-4 is flagged ``PARITY_FAIL`` and the run ends ``SystemExit``.

On the CPU (``--device cpu``) every time is the host clock.

    python -m hypergef_tpu_torch.experiments.serve_bench --out serve_r5.csv
"""

from __future__ import annotations

import argparse
import os
import time
from typing import List, Optional

import numpy as np
import torch

from hypergef_tpu_torch.experiments import common

WORKLOADS = {
    # name: (n_vertices, n_hyperedges, classes, avg_edge_size, feat)
    "cora_shaped": (2708, 2708, 7, 4.0, 64),
    "pubmed_shaped": (19717, 7963, 3, 10.8, 64),
    "20news_shaped": (16242, 100, 4, 100.0, 64),
}
HEADER = (
    "workload,nnz,feat,backend,export_s,artifact_mb,load_s,first_call_s,"
    "warm_ms_median,warm_ms_p95,qps,direct_ms_median,"
    "dev_us_forward,dev_us_direct,parity_max_abs"
)
PARITY_MAX = 1e-4


def _lat_stats(fn, calls, device):
    samples = []
    for _ in range(calls):
        t0 = time.perf_counter()
        fn()
        common.sync(device)
        samples.append(time.perf_counter() - t0)
    arr = np.sort(np.asarray(samples))
    return {
        "median_ms": float(arr[len(arr) // 2] * 1e3),
        "p95_ms": float(arr[min(len(arr) - 1, int(0.95 * len(arr)))] * 1e3),
        "mean_s": float(arr.mean()),
    }


def main(argv: Optional[List[str]] = None) -> list:
    """Run the workloads; returns one dict a workload."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default="serve_r5.csv")
    ap.add_argument("--workloads", default=",".join(WORKLOADS))
    ap.add_argument("--epochs", type=int, default=30)
    ap.add_argument("--calls", type=int, default=50)
    ap.add_argument("--dev-iters", type=int, default=10,
                    help="requests a timed window (a time is the median of 20 windows)")
    ap.add_argument("--artifact-dir", default="serve_bench_artifacts")
    common.add_device_flag(ap)
    args = ap.parse_args(argv)
    device = common.resolve_device(args.device)

    from hypergef_tpu_torch import serve
    from hypergef_tpu_torch.data.synthetic import homophilic_hypergraph, random_features
    from hypergef_tpu_torch.train import TrainConfig, Trainer, rand_train_test_idx

    os.makedirs(args.artifact_dir, exist_ok=True)
    failures, results = [], []
    with common.csv(args.out, device, header=HEADER) as emit:
        for wname in args.workloads.split(","):
            n, e, ncls, avg, feat = WORKLOADS[wname]
            hg, y = homophilic_hypergraph(n, e, ncls, avg_edge_size=avg, seed=21)
            x, _ = random_features(hg.num_nodes, feat, ncls, seed=22)
            split = rand_train_test_idx(y, seed=23)
            cfg = TrainConfig(model="HGNN", nhid=32, epochs=args.epochs,
                              warmup=0, seed=24)
            tr = Trainer(cfg, hg, x, y, device=device)
            tr.fit(split["train"], epochs=args.epochs, warmup=0)
            backend = tr.plan.preferred_backend

            path = os.path.join(args.artifact_dir, f"{wname}.hgefsrv")
            t0 = time.perf_counter()
            serve.export_trainer(tr, path)
            export_s = time.perf_counter() - t0
            mb = os.path.getsize(path) / 1e6

            t0 = time.perf_counter()
            m = serve.ServingModel.load(path, device=device)
            load_s = time.perf_counter() - t0 - m.capture_s

            xd = torch.as_tensor(x, device=device)
            t0 = time.perf_counter()
            first = m.predict(xd)
            common.sync(device)
            first_call_s = m.capture_s + time.perf_counter() - t0

            warm = _lat_stats(lambda: m.predict(xd), args.calls, device)
            qps = 1.0 / max(warm["mean_s"], 1e-12)

            # no-serialization control: the live Trainer's captured forward
            direct = tr.predict()
            common.sync(device)
            direct_lat = _lat_stats(tr.predict, args.calls, device)
            parity = float((first - direct).abs().max())

            dev_fwd = common.time_call(lambda: m.predict(xd), device, args.dev_iters)
            dev_dir = common.time_call(tr.predict, device, args.dev_iters)

            row = (f"{wname},{hg.nnz},{feat},{backend},{export_s:.2f},"
                   f"{mb:.2f},{load_s:.3f},{first_call_s:.2f},"
                   f"{warm['median_ms']:.3f},{warm['p95_ms']:.3f},"
                   f"{qps:.1f},{direct_lat['median_ms']:.3f},"
                   f"{dev_fwd.ms * 1e3:.1f},{dev_dir.ms * 1e3:.1f},{parity:.2e}")
            row += dev_fwd.flag() + dev_dir.flag()
            # parity gates the row, and a failure on one workload does not
            # cut the sweep short
            if not parity < PARITY_MAX:
                failures.append(wname)
                row += ",PARITY_FAIL"
                print(f"{wname}: serving artifact diverges from live "
                      f"forward ({parity:.2e}) — row flagged", flush=True)
            emit(row)
            results.append({"workload": wname, "nnz": hg.nnz, "backend": backend,
                            "export_s": export_s, "artifact_mb": mb, "load_s": load_s,
                            "capture_s": m.capture_s, "first_call_s": first_call_s,
                            "warm_ms_median": warm["median_ms"], "warm_ms_p95": warm["p95_ms"],
                            "qps": qps, "direct_ms_median": direct_lat["median_ms"],
                            "dev_us_forward": dev_fwd.ms * 1e3,
                            "dev_us_direct": dev_dir.ms * 1e3, "parity_max_abs": parity})
    if failures:
        raise SystemExit(f"parity failures: {failures}")
    return results


if __name__ == "__main__":
    main()
