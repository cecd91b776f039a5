"""Minibatch memory scale on the card: the port of
``experiments/minibatch_scale.py``.

1. builds a ~42M-incidence homophilic community hypergraph with
   label-correlated noisy features (:func:`~.scale_common.big_homophilic`,
   :func:`~.scale_common.class_features`: weak signal a vertex, strong
   after aggregation over a hyperedge);
2. tries the full-batch step on the card, a ``cumsum``-route gradient of
   ``mean(z²)`` with the graph and features resident, and records what
   happened: the JAX driver expected it to fail on a 16 GB chip; where it
   fits (an 80 GB card may hold it) the run writes JAX's own
   ``full_batch_step,ok ... premise void`` row;
3. trains with the hyperedge-sampled ``MinibatchTrainer`` (on the card each
   pad shape's step recorded into a CUDA graph) for ``--epochs``, recording
   batches/s and the training loss;
4. evaluates the trained weights on the full graph on the host CPU (the
   JAX driver's design), asked for explicitly, on a class-balanced
   subsample of the held-out split.

Every measured row names where it ran.

    python -m hypergef_tpu_torch.experiments.minibatch_scale --out minibatch_scale_r5.csv
"""

from __future__ import annotations

import argparse
import time
from typing import List, Optional

import numpy as np
import torch

from hypergef_tpu_torch.experiments import common
from hypergef_tpu_torch.experiments.scale_common import big_homophilic, class_features

HEADER = "quantity,value,unit,provenance"


def full_batch_probe(hg, x, device) -> dict:
    """The full-batch step's attempt (``minibatch_scale.py:144-177``): the
    gradient of ``mean(z²)``, ``z`` the ``cumsum`` route's aggregation of
    ``x·W``, with W [F, 32] zeros. Returns ``ok`` and, where it failed, the
    exception's name and first line, and the card's peak bytes."""
    from hypergef_tpu_torch.ops import fused

    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    out = {"ok": False}
    try:
        hgd = hg.device_data(device)
        xd = torch.as_tensor(x, device=device)
        w = torch.zeros((x.shape[1], 32), device=device, requires_grad=True)
        z = fused.hgnn_aggregate(hgd, xd @ w, None, "sum", plan=None, backend="cumsum")
        (g,) = torch.autograd.grad((z * z).mean(), w)
        float(g.sum())  # fence
        out["ok"] = True
    except Exception as ex:  # noqa: BLE001 — recording the failure is the point
        out.update(error=type(ex).__name__,
                   message=str(ex).splitlines()[0][:120] if str(ex) else "")
    finally:
        hgd = xd = w = z = g = None  # noqa: F841 — release before the minibatch run
        if device.type == "cuda":
            out["peak_bytes"] = torch.cuda.max_memory_allocated(device)
            torch.cuda.empty_cache()
    return out


def host_model(mb, nfeat: int):
    """The trained model's weights in a model on the host CPU."""
    from hypergef_tpu_torch.models.zoo import build_model

    cfg = mb.cfg
    model = build_model(cfg.model, nfeat=nfeat, nhid=cfg.nhid, nclass=mb.nclass,
                        num_edges=mb.hg.num_edges, nlayer=cfg.nlayer, first_aggr=cfg.first_aggr,
                        nhead=cfg.nhead, dropout=cfg.dropout, input_drop=cfg.input_drop,
                        activation=cfg.activation, backend="cumsum", seed=cfg.seed,
                        device="cpu")
    model.load_state_dict({k: v.detach().cpu() for k, v in mb.model.state_dict().items()})
    return model.eval()


def main(argv: Optional[List[str]] = None) -> dict:
    """Run the demonstration; returns its numbers."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--nodes", type=int, default=8_000_000)
    ap.add_argument("--edges", type=int, default=6_000_000)
    ap.add_argument("--classes", type=int, default=8)
    ap.add_argument("--avg", type=float, default=7.0)
    ap.add_argument("--feat", type=int, default=64)
    ap.add_argument("--sigma", type=float, default=4.0)
    ap.add_argument("--batch-edges", type=int, default=8192)
    ap.add_argument("--epochs", type=int, default=2)
    ap.add_argument("--eval-nodes", type=int, default=200_000)
    ap.add_argument("--skip-oom-probe", action="store_true")
    ap.add_argument("--out", default="minibatch_scale_r5.csv")
    common.add_device_flag(ap)
    args = ap.parse_args(argv)
    device = common.resolve_device(args.device)
    card = common.card_label(device)

    from hypergef_tpu_torch.train import TrainConfig, rand_train_test_idx
    from hypergef_tpu_torch.train.minibatch import MinibatchTrainer

    t0 = time.time()
    hg, y = big_homophilic(args.nodes, args.edges, args.classes, args.avg, 0.05, seed=5)
    x = class_features(y, args.feat, args.sigma, seed=6)
    gen_s = time.time() - t0
    print(f"graph nnz={hg.nnz} gen {gen_s:.0f}s", flush=True)
    split = rand_train_test_idx(y, seed=7)
    cfg = TrainConfig(model="HGNN", nhid=32, epochs=args.epochs, warmup=0, seed=8)
    res = {"nnz": hg.nnz}
    comments = ["# minibatch memory-scale demo (round-5 mandate #5b)"]
    with common.csv(args.out, device, comments, header=HEADER) as emit:
        emit(f"graph_nnz,{hg.nnz},nnz,generated homophilic community graph "
             f"({args.nodes}x{args.edges} avg={args.avg})")
        if not args.skip_oom_probe:
            probe = full_batch_probe(hg, x, device)
            res["full_batch"] = probe
            peak = (f"; peak {probe['peak_bytes'] / 2**30:.2f} GiB" if "peak_bytes" in probe
                    else "")
            if probe["ok"]:
                emit("full_batch_step,ok,status,full-batch grad step unexpectedly fit — demo "
                     f"premise void; see log ({card}{peak})")
                print(f"full-batch step FIT — premise void{peak}", flush=True)
            else:
                emit(f"full_batch_step,FAILED:{probe['error']},status,MEASURED attempt on "
                     f"{card} ({probe['message'].replace(',', ';')}{peak})")
                print(f"full-batch step failed as expected: {probe['error']}: "
                      f"{probe['message']}", flush=True)

        t0 = time.time()
        mb = MinibatchTrainer(cfg, hg, x, y, split["train"], batch_edges=args.batch_edges,
                              device=device)
        init_s = time.time() - t0
        print(f"mb init {init_s:.0f}s pad_shapes={mb.pad_shapes}", flush=True)
        t0 = time.time()
        fit = mb.fit(epochs=args.epochs)
        train_s = time.time() - t0
        bps = fit["batches"] / max(train_s, 1e-9)
        print(f"train: {fit['batches']} batches in {train_s:.0f}s ({bps:.1f} batches/s wall) "
              f"loss {fit['mean_loss']:.3f} ({fit['step']} steps)", flush=True)
        emit(f"batches,{fit['batches']},count,{args.epochs} epochs at "
             f"batch_edges={args.batch_edges}")
        emit(f"batches_per_s,{bps:.2f},1/s,MEASURED wall on {card} incl host sampling "
             f"(host-in-loop is part of the design; {fit['step']} steps)")
        emit(f"mean_loss_last10,{fit['mean_loss']:.4f},nll,"
             f"vs ln({args.classes})={np.log(args.classes):.3f} chance")
        emit(f"compile_count,{mb.compile_count},programs,fixed bucket shapes")
        res.update(batches=fit["batches"], batches_per_s=bps, mean_loss=fit["mean_loss"],
                   compile_count=mb.compile_count, step=fit["step"])

        # the full-graph evaluation on the host CPU, as the JAX driver does
        print("evaluating on host CPU (full-graph forward)...", flush=True)
        t0 = time.time()
        cpu = torch.device("cpu")
        with torch.no_grad():
            z = host_model(mb, args.feat)(torch.as_tensor(x), hg.device_data(cpu)).numpy()
        eval_s = time.time() - t0
        vi = np.asarray(split["valid"])
        if len(vi) > args.eval_nodes:
            vi = np.random.default_rng(9).choice(vi, args.eval_nodes, replace=False)
        acc = float((z[vi].argmax(1) == y[vi]).mean())
        emit(f"valid_acc,{acc:.4f},fraction,full-graph forward on host CPU over {len(vi)} "
             f"valid vertices ({eval_s:.0f}s)")
        emit(f"chance,{1.0 / args.classes:.4f},fraction,{args.classes} classes")
        print(f"valid acc {acc:.3f} (chance {1.0 / args.classes:.3f}, eval {eval_s:.0f}s)",
              flush=True)
        res.update(valid_acc=acc, eval_s=eval_s)
    return res


if __name__ == "__main__":
    main()
