"""fig6 analogue on the card: the end-to-end train and inference epoch
matrix. The port of ``experiments/fig6.py``.

Reference: ``experiment/fig6.py`` sweeps 13 datasets × {32,64,128} hid ×
3 backends × 3 models through hgsys.py, appending rows to fig6.csv.
Here: named datasets when their raw files exist under ``data/``, otherwise
reference-shaped synthetic graphs (``DatasetNotAvailable``); the
"backends" are the port's routes. Each row trains a ``Trainer`` (its step
a CUDA-graph replay on the card): ``fit`` (warm-up, then the timed
epochs, CUDA events with host included), ``time_inference`` (full-graph
forwards) and ``evaluate``. A row that raises prints ``FAILED`` and the
sweep goes on.

    python -m hypergef_tpu_torch.experiments.fig6 --out fig6.csv --hids 32,64 --quick
"""

from __future__ import annotations

import argparse
import gc
from typing import List, Optional

import numpy as np

from hypergef_tpu_torch.experiments import common

# reference-shaped synthetic stand-ins (|V|, |E|, avg edge size, nfeat,
# ncls) — ALL 13 names of the reference's fig6 matrix
# (HyperGsys/dataloader.py:20-58; sizes from the AllSet benchmark family,
# approximate where the raw data is unfetchable here)
SHAPES = {
    "cora": (2708, 2708, 4.0, 1433, 7),
    "citeseer": (3312, 3312, 3.2, 3703, 6),
    "pubmed": (19717, 7963, 10.8, 500, 3),
    "coauthor_cora": (2708, 1072, 4.3, 1433, 7),
    "coauthor_dblp": (41302, 22363, 4.5, 1425, 6),
    "20newsW100": (16242, 100, 654.5, 100, 4),
    "NTU2012": (2012, 2012, 5.0, 100, 67),
    "ModelNet40": (12311, 12311, 5.0, 100, 40),
    "Mushroom": (8124, 298, 500.0, 22, 2),
    "zoo": (101, 43, 10.0, 16, 7),
    "yelp": (50758, 67930, 7.0, 1862, 9),
    "walmart-trips": (88860, 69906, 6.6, 100, 11),
    "house-committees": (1290, 341, 35.0, 100, 3),
}


def run_one(name, model, nhid, backend, epochs, device):
    from hypergef_tpu_torch.data.datasets import DatasetNotAvailable, load_dataset
    from hypergef_tpu_torch.data.synthetic import homophilic_hypergraph
    from hypergef_tpu_torch.train import TrainConfig, Trainer, rand_train_test_idx

    try:
        ds = load_dataset(name)
        hg, x, y = ds.hg, ds.features, ds.labels
        src = "real"
    except (DatasetNotAvailable, FileNotFoundError):
        # only "data genuinely absent" falls back to synthetic; loader or
        # trainer bugs propagate to the per-row FAILED handler
        n, e, avg, nf, nc = SHAPES[name]
        hg, y = homophilic_hypergraph(n, e, nc, avg_edge_size=avg, seed=0,
                                      name=name)
        x = np.random.default_rng(1).normal(size=(n, nf)).astype(np.float32)
        src = "synthetic"
    split = rand_train_test_idx(y, seed=1)
    cfg = TrainConfig(model=model, nhid=nhid, epochs=epochs, warmup=5,
                      backend=backend)
    tr = Trainer(cfg, hg, x, y, device=device)
    res = tr.fit(split["train"])
    res["inference_time_s"] = tr.time_inference(iters=max(epochs // 2, 1))
    res.update(tr.evaluate(split))
    res["route"] = getattr(tr.plan, "preferred_backend", None) if backend == "auto" else backend
    return src, res


def main(argv: Optional[List[str]] = None) -> list:
    """Run the matrix; returns one dict a row (``failed`` for a row that
    raised)."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default="fig6.csv")
    ap.add_argument("--datasets", default=",".join(SHAPES))
    ap.add_argument("--hids", default="32,64,128")
    ap.add_argument("--models", default="HGNN,UniGIN,UniGCNII")
    ap.add_argument("--backends", default="auto")
    ap.add_argument("--epochs", type=int, default=50)
    ap.add_argument("--quick", action="store_true")
    common.add_device_flag(ap)
    args = ap.parse_args(argv)
    device = common.resolve_device(args.device)
    if args.quick:
        args.epochs = 10
    results = []
    with common.csv(args.out, device) as emit:
        for name in args.datasets.split(","):
            for model in args.models.split(","):
                for nhid in map(int, args.hids.split(",")):
                    for backend in args.backends.split(","):
                        key = {"dataset": name, "model": model, "nhid": nhid,
                               "backend": backend}
                        try:
                            src, res = run_one(name, model, nhid, backend, args.epochs,
                                               device)
                        except Exception as ex:
                            print(f"{name}/{model}/{nhid}/{backend}: FAILED {ex}", flush=True)
                            results.append({**key, "failed": f"{type(ex).__name__}: {ex}"})
                            continue
                        row = (
                            f"{backend},{model},{name}({src}),nhid={nhid},"
                            f"{res['train_epoch_time_s']:.6f},"
                            f"{res['inference_time_s']:.6f},"
                            f"{res.get('test_acc', float('nan')):.2f}"
                        )
                        emit(row)
                        results.append({**key, "src": src, "route": res["route"],
                                        "step": res["step"],
                                        "train_epoch_time_s": res["train_epoch_time_s"],
                                        "inference_time_s": res["inference_time_s"],
                                        "test_acc": res.get("test_acc", float("nan")),
                                        "final_loss": res["final_loss"]})
                        gc.collect()  # the row's trainer and its recordings
    return results


if __name__ == "__main__":
    main()
