"""Minibatch-path measurement on the card (BASELINE config #4): the port of
``experiments/minibatch_bench.py``.

For each workload, in one process:

* **full-batch** (the reference-style path): the captured step's epoch
  time behind a queued sleep (``Trainer.epoch_device_time``) and the
  wall-clock seconds and epochs until the valid accuracy reaches a band;
* **minibatch** (hyperedge-sampled, padded to fixed shapes, each shape's
  step recorded into a CUDA graph): batches/s, wall-clock seconds to the
  same band, and ``compile_count``, the recordings (distinct pad shapes
  when eager) — the no-per-batch-recording guarantee.

Band protocol: train full-batch to ``--epochs`` first, take its final
valid accuracy A*, band = 0.95·A*; then train each path fresh,
evaluating every ``--eval-every`` epochs, and record the first time and
epoch where valid ≥ band.

    python -m hypergef_tpu_torch.experiments.minibatch_bench --out minibatch_r4.csv
"""

from __future__ import annotations

import argparse
import time
from typing import List, Optional

from hypergef_tpu_torch.experiments import common

WORKLOADS = {
    # name: (n, e, classes, avg_edge_size, feat)
    "pubmed_shaped": (19717, 7963, 3, 10.8, 64),
    "dblp_shaped": (41302, 22363, 6, 4.5, 64),
    "20news_shaped": (16242, 100, 4, 100.0, 64),
}
HEADER = (
    "workload,path,nnz,band_acc,reached_acc,units,unit,wall_s,"
    "rate,rate_unit,compile_count"
)


def time_to_band(fit_chunk, evaluate, band, max_units, unit_chunk):
    """Generic: call ``fit_chunk()`` (advances unit_chunk units), then
    ``evaluate()`` → valid acc; returns (units, wall_s, acc) at first
    acc ≥ band, or at max_units."""
    t0 = time.perf_counter()
    units = 0
    acc = 0.0
    while units < max_units:
        fit_chunk()
        units += unit_chunk
        acc = evaluate()
        if acc >= band:
            break
    return units, time.perf_counter() - t0, acc


def main(argv: Optional[List[str]] = None) -> list:
    """Run the workloads; returns one dict a row."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default="minibatch_r4.csv")
    ap.add_argument("--workloads", default=",".join(WORKLOADS))
    ap.add_argument("--epochs", type=int, default=150)
    ap.add_argument("--batch-edges", type=int, default=512)
    ap.add_argument("--eval-every", type=int, default=10)
    common.add_device_flag(ap)
    args = ap.parse_args(argv)
    device = common.resolve_device(args.device)

    from hypergef_tpu_torch.data.synthetic import homophilic_hypergraph, random_features
    from hypergef_tpu_torch.train import TrainConfig, Trainer, rand_train_test_idx
    from hypergef_tpu_torch.train.minibatch import MinibatchTrainer

    results = []
    with common.csv(args.out, device, header=HEADER) as emit:
        for wname in args.workloads.split(","):
            n, e, ncls, avg, feat = WORKLOADS[wname]
            hg, y = homophilic_hypergraph(n, e, ncls, avg_edge_size=avg,
                                          seed=11)
            x, _ = random_features(hg.num_nodes, feat, ncls, seed=12)
            split = rand_train_test_idx(y, seed=13)

            def cfg(seed):
                return TrainConfig(model="HGNN", nhid=32, epochs=args.epochs, warmup=0,
                                   seed=seed)

            # 1. calibration run: full-batch final valid acc → band
            tr0 = Trainer(cfg(1), hg, x, y, device=device)
            tr0.fit(split["train"], epochs=args.epochs, warmup=0)
            a_star = tr0.evaluate(split)["valid_acc"] / 100.0
            band = 0.95 * a_star
            print(f"{wname}: A*={a_star:.3f} band={band:.3f}", flush=True)
            del tr0

            # 2. full-batch fresh: time-to-band (wall clock, chunked)
            tr = Trainer(cfg(2), hg, x, y, device=device)
            units, wall, acc = time_to_band(
                lambda: tr.fit(split["train"], epochs=args.eval_every, warmup=0),
                lambda: tr.evaluate(split)["valid_acc"] / 100.0,
                band, args.epochs, args.eval_every,
            )
            # the step's own epoch time, behind a queued sleep
            ep_t = tr.epoch_device_time(split["train"], iters=30)
            emit(f"{wname},full_batch,{hg.nnz},{band:.3f},{acc:.3f},"
                     f"{units},epochs,{wall:.2f},{1.0/max(ep_t,1e-12):.1f},"
                     f"epochs_per_s_device,1")
            results.append({"workload": wname, "path": "full_batch", "band": band,
                            "reached_acc": acc, "epochs": units, "wall_s": wall,
                            "epoch_device_s": ep_t, "compile_count": 1})
            del tr

            # 3. minibatch fresh: time-to-band + batches/s + recordings
            mb = MinibatchTrainer(cfg(3), hg, x, y, split["train"],
                                  batch_edges=args.batch_edges, device=device)
            state = {"batches": 0, "time": 0.0}

            def mb_chunk():
                r = mb.fit(epochs=args.eval_every)
                state["batches"] += r["batches"]
                state["time"] += r["time_s"]

            units, wall, acc = time_to_band(
                mb_chunk, lambda: mb.evaluate_full(split)["valid_acc"] / 100.0,
                band, args.epochs, args.eval_every,
            )
            bps = state["batches"] / max(state["time"], 1e-9)
            emit(f"{wname},minibatch_be{args.batch_edges},{hg.nnz},"
                     f"{band:.3f},{acc:.3f},{units},epochs,{wall:.2f},"
                     f"{bps:.1f},batches_per_s_wall,{mb.compile_count}")
            results.append({"workload": wname, "path": f"minibatch_be{args.batch_edges}",
                            "band": band, "reached_acc": acc, "epochs": units, "wall_s": wall,
                            "batches": state["batches"], "batches_per_s": bps,
                            "compile_count": mb.compile_count, "step": "captured"
                            if mb.compiled else "eager"})
    return results


if __name__ == "__main__":
    main()
