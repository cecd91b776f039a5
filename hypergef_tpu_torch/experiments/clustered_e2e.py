"""End-to-end training in the sparse regime on the card: the port of
``experiments/clustered_e2e.py``.

SBM-60k (``community_hypergraph(60000, 30000, 240, 12, 0.02, 0)``, edges
sorted by median member), labels the community bucketed to 8 classes,
features noisy class centers (JAX's draws). For each of ``aligned``,
``tree`` and ``cumsum``: a HGNN ``Trainer``'s epoch behind a queued sleep
(``epoch_device_time(iters=30)``), then 30 epochs of ``fit`` and the test
accuracy (a sanity check that the route learns, not a benchmark).

On the card the ``aligned`` row runs the kernel form
(``dataclasses.replace(plan_aligned(hg), form="pallas_auto")``: the band
kernel), on the CPU the plain form; a comment row says which ran. A route
that fails is written ``FAILED`` and ends the run ``SystemExit`` after the
sweep.

    python -m hypergef_tpu_torch.experiments.clustered_e2e --out clustered_e2e_r2.csv
"""

from __future__ import annotations

import argparse
import dataclasses
from typing import List, Optional

import numpy as np

from hypergef_tpu_torch.experiments import common
from hypergef_tpu_torch.experiments.scale_common import sorted_edges

BACKENDS = ("aligned", "tree", "cumsum")
HEADER = "backend,epoch_us,test_acc"
NCLASS = 8


def aligned_form(device) -> str:
    """The ``aligned`` row's plan form: the band kernel on the card, the
    plain band products (``plan_aligned``'s own ``xla``) on the CPU."""
    return "pallas_auto" if device.type == "cuda" else "xla"


def aligned_plan(hg, device):
    from hypergef_tpu_torch.sparse.planner import plan_aligned

    return dataclasses.replace(plan_aligned(hg), form=aligned_form(device))


def problem(n: int, e: int, comm: int, avg: float = 12, noise: float = 0.02, f: int = 32):
    """JAX's graph, features, labels and split (``clustered_e2e.py:43-56``)."""
    from hypergef_tpu_torch.data.synthetic import community_hypergraph
    from hypergef_tpu_torch.train import rand_train_test_idx

    hg = sorted_edges(community_hypergraph(n, e, comm, avg, noise, 0))
    rng = np.random.default_rng(1)
    comm_of = (np.arange(n) * comm // n) % NCLASS
    centers = rng.normal(size=(NCLASS, f)).astype(np.float32)
    x = centers[comm_of] + 0.7 * rng.normal(size=(n, f)).astype(np.float32)
    y = comm_of.astype(np.int32)
    return hg, x, y, rand_train_test_idx(y, seed=2)


def main(argv: Optional[List[str]] = None) -> list:
    """Run the three routes; returns one dict a route (its epoch µs, test
    accuracy, the plan form that ran)."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default="clustered_e2e_r2.csv")
    ap.add_argument("--nodes", type=int, default=60_000)
    ap.add_argument("--edges", type=int, default=30_000)
    ap.add_argument("--comm", type=int, default=240)
    ap.add_argument("--iters", type=int, default=30,
                    help="steps a timed window of epoch_device_time")
    ap.add_argument("--epochs", type=int, default=30)
    common.add_device_flag(ap)
    args = ap.parse_args(argv)
    device = common.resolve_device(args.device)

    from hypergef_tpu_torch.train import TrainConfig, Trainer

    hg, x, y, split = problem(args.nodes, args.edges, args.comm)
    form = aligned_form(device)
    results, failures = [], []
    comments = ["# clustered e2e: HGNN train-epoch device time, SBM-60k f=32 nhid=32",
                f"# nnz={hg.nnz} dev={device.type} aligned form={form} ("
                + ("the band kernel)" if form.startswith("pallas") else "plain band products)")]
    with common.csv(args.out, device, comments, header=HEADER) as emit:
        for backend in BACKENDS:
            try:
                cfg = TrainConfig(model="HGNN", nhid=32, nlayer=2, epochs=args.epochs,
                                  backend=backend)
                plan = aligned_plan(hg, device) if backend == "aligned" else None
                tr = Trainer(cfg, hg, x, y, plan=plan, device=device)
                t_s = tr.epoch_device_time(split["train"], iters=args.iters)
                # a sanity check, not a benchmark: 30 real epochs
                tr.fit(split["train"], epochs=cfg.epochs, warmup=0)
                acc = tr.evaluate({"test": split["test"]})["test_acc"]
                row = f"{backend},{t_s * 1e6:.1f},{acc:.1f}"
                results.append({"backend": backend, "epoch_us": t_s * 1e6, "test_acc": acc,
                                "form": form if backend == "aligned" else None,
                                "step": "captured" if tr.compiled else "eager"})
                del tr
            except Exception as exc:  # noqa: BLE001 — written, then the run ends
                row = f"{backend},FAILED:{type(exc).__name__},"
                failures.append(f"{backend}: {type(exc).__name__}: {exc}")
            emit(row)
    if failures:
        raise SystemExit(f"clustered_e2e failures: {failures}")
    return results


if __name__ == "__main__":
    main()
