"""Training CLI, with the flag surface of the reference's driver ``hgsys.py``.

Port of ``hypergef_tpu/train/cli.py`` (``:1-268``): the same flags, with the
same names, destinations and defaults, and the same CSV row
(``hgsys.py:207-211``) when ``--output`` is given. It runs on the card
unless ``--platform cpu`` is given (without a card, anything else raises,
as the ``Trainer`` does).

    python -m hypergef_tpu_torch.train.cli --dname cora --data-path DIR
    python -m hypergef_tpu_torch.train.cli --synthetic powerlaw --n 5000 --e 3000
    python -m hypergef_tpu_torch.train.cli --synthetic random --platform cpu --epochs 20

``--tune`` plans by measurement (:mod:`hypergef_tpu_torch.sparse.autotune`,
its records under ``~/.cache/hypergef_tpu_torch/tune``), ``--plan-cache
[DIR]`` keeps the plan on disk (:mod:`hypergef_tpu_torch.sparse.plancache`,
by default under ``~/.cache/hypergef_tpu_torch/plans``), and
``--validate-parity`` checks a dataset (:mod:`hypergef_tpu_torch.data.parity`)
and exits 1 on any FAIL. ``--minibatch-edges B`` trains on hyperedge-sampled
minibatches of B edges (:mod:`hypergef_tpu_torch.train.minibatch`,
``epochs // 10`` epochs); ``--export PATH`` writes the trained full-batch
forward as a serving artifact (:func:`hypergef_tpu_torch.serve.export_trainer`,
for ``--export-platforms`` ``cuda,cpu``, by default the run's device).
``--shards N`` trains edge-partitioned over N ranks
(:class:`hypergef_tpu_torch.parallel.trainer.DistTrainer`) and prints JAX's
lines: under torchrun (``RANK`` in the environment) this process is one
rank; otherwise the CLI spawns N ranks on this host
(:mod:`hypergef_tpu_torch.parallel.launch`) with ``--dist-backend``
(``nccl``, one card a rank, the default; ``gloo`` lets ranks share a card,
and runs CPU ranks with ``--platform cpu``). The parent loads the data,
builds the plan and the kernels once and hands them to the ranks.
``--feature-shards F`` adds the feature mesh axis: the world is
``--shards · F`` ranks in an ``(e, f)`` grid, each aggregation
feature-sharded (``DistTrainer(n_feature=F)``).

The minibatch and nccl ``--shards`` runs record their step into a CUDA
graph on the card, as the full-batch run does (the trainers' ``compiled``
default: once a pad shape, once a world's step); gloo and CPU runs step
eagerly. Each run prints which step ran (``step: captured | eager``).
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np


def parse(argv=None):
    p = argparse.ArgumentParser(description="hypergef_tpu_torch trainer")
    # the reference's surface (hgsys.py:22-70)
    p.add_argument("--dname", default="walmart-trips")
    p.add_argument("--model", type=str, default="HGNN", help="HGNN | UniGIN | UniGCNII")
    p.add_argument("--data-path", type=str, default="data/")
    p.add_argument("--add-self-loop", action="store_true")
    p.add_argument("--activation", type=str, default="relu")
    p.add_argument("--nlayer", type=int, default=2)
    p.add_argument("--first-aggr", type=str, default="sum", choices=["sum", "mean", "max"])
    p.add_argument("--nhid", type=int, default=32)
    p.add_argument("--nhead", type=int, default=1)
    p.add_argument("--dropout", type=float, default=0.6)
    p.add_argument("--input-drop", type=float, default=0.6)
    p.add_argument("--feature_noise", default="1", type=str)
    p.add_argument("--train_prop", type=float, default=0.5)
    p.add_argument("--valid_prop", type=float, default=0.25)
    p.add_argument("--lr", type=float, default=0.01)
    p.add_argument("--wd", type=float, default=5e-4)
    p.add_argument("--epochs", type=int, default=200)
    p.add_argument("--seed", type=int, default=1)
    p.add_argument("--output", type=str, default=None)
    p.add_argument("--profile", type=int, default=0)
    # the JAX package's extensions
    p.add_argument("--tune", action="store_true",
                   help="plan by a measured per-graph sweep of routes and parameters "
                        "(sparse/autotune.py), kept in a persistent cache")
    p.add_argument("--backend", type=str, default="auto",
                   help="auto|xla|cumsum|ell|tree|dense|bsr|precomp|pallas|multihot|"
                        "pallas_sparse|aligned|bitstream")
    p.add_argument("--plan-cache", type=str, default=None, nargs="?", const="",
                   help="keep built plans in this directory, keyed by the graph's content "
                        "(no DIR: the default user cache); reruns load instead of building")
    p.add_argument("--platform", type=str, default=None,
                   help="cpu runs on the CPU; anything else (the default) on the card")
    p.add_argument("--export", type=str, default=None, metavar="PATH",
                   help="after training, write a serving artifact (the full-graph forward "
                        "as torch.export programs) to PATH (serve.ServingModel.load)")
    p.add_argument("--export-platforms", type=str, default=None,
                   help="comma-separated export platforms (cuda, cpu); default: the "
                        "run's device")
    p.add_argument("--validate-parity", action="store_true",
                   help="load --dname from --data-path and check format, shape, the fused "
                        "op against its oracle and the accuracy band "
                        "(hypergef_tpu_torch.data.parity); exit 1 on any FAIL")
    p.add_argument("--parity-record", type=str, default=None, metavar="JSON",
                   help="with --validate-parity: write the raw files' sha256 fingerprints "
                        "and the loaded stats to this JSON")
    p.add_argument("--minibatch-edges", type=int, default=0,
                   help=">0: train with hyperedge-sampled minibatches of this many edges "
                        "(the cumsum route, epochs // 10 epochs)")
    p.add_argument("--shards", type=int, default=0,
                   help=">0: edge-partitioned distributed training over this many ranks")
    p.add_argument("--feature-shards", type=int, default=1,
                   help="with --shards: the feature (tensor-parallel) mesh axis size; the "
                        "world is --shards x --feature-shards ranks")
    p.add_argument("--dist-backend", type=str, default="nccl", choices=["nccl", "gloo"],
                   help="with --shards: nccl (one card a rank) or gloo (ranks share the "
                        "cards; CPU ranks with --platform cpu)")
    p.add_argument("--synthetic", type=str, default=None,
                   choices=[None, "random", "powerlaw", "homophilic"],
                   help="use a synthetic graph instead of --dname")
    p.add_argument("--n", type=int, default=5000)
    p.add_argument("--e", type=int, default=3000)
    p.add_argument("--feat", type=int, default=32)
    p.add_argument("--classes", type=int, default=5)
    return p.parse_args(argv)


def load_problem(args):
    """(hypergraph, features, labels) of the arguments (``:94-127``)."""
    from hypergef_tpu_torch.data import synthetic

    if args.synthetic:
        if args.synthetic == "homophilic":
            hg, y = synthetic.homophilic_hypergraph(args.n, args.e, args.classes, seed=args.seed)
            x = np.random.default_rng(args.seed).normal(size=(args.n, args.feat)).astype(
                np.float32)
        else:
            gen = (synthetic.powerlaw_hypergraph if args.synthetic == "powerlaw"
                   else synthetic.random_hypergraph)
            hg = gen(args.n, args.e, seed=args.seed)
            x, y = synthetic.random_features(args.n, args.feat, args.classes, seed=args.seed)
        return hg, x, y
    from hypergef_tpu_torch.data.datasets import load_dataset

    ds = load_dataset(args.dname, root=args.data_path, feature_noise=float(args.feature_noise))
    hg = ds.hg
    if args.add_self_loop:
        from hypergef_tpu_torch.data.transforms import add_self_loops

        hg = add_self_loops(hg)
    return hg, ds.features, ds.labels


def _split(args, y):
    """The run's split (``:133-136``)."""
    from hypergef_tpu_torch.train.splits import rand_train_test_idx

    np.random.seed(args.seed)
    return rand_train_test_idx(y, train_prop=args.train_prop, valid_prop=args.valid_prop,
                               seed=args.seed)


def _dist_rank(args, plan, problem=None) -> dict:
    """One rank of ``--shards``: the DistTrainer's fit and evaluation, with
    this rank's kernel launches and, on a card, its peak MiB. A spawned
    rank loads the problem itself (the features of a large graph are not
    copied through the spawn)."""
    import torch

    from hypergef_tpu_torch.parallel.launch import kernel_launches, reset_kernel_launches
    from hypergef_tpu_torch.parallel.trainer import DistTrainer

    if problem is None:
        hg, x, y = load_problem(args)
        problem = (hg, x, y, _split(args, y))
    hg, x, y, split = problem
    reset_kernel_launches()
    tr = DistTrainer(hg, x, y, nhid=args.nhid, n_shards=args.shards,
                     n_feature=args.feature_shards, lr=args.lr, wd=args.wd, seed=args.seed,
                     model=args.model, first_aggr=args.first_aggr, plan=plan)
    res = tr.fit(split["train"], epochs=args.epochs)
    res.update(tr.evaluate(split))
    res["launches"] = kernel_launches()
    if tr.device.type == "cuda":
        res["peak_mib"] = torch.cuda.max_memory_allocated(tr.device) / 2**20
    return res


def run_distributed(args, hg, x, y, split) -> dict:
    """``--shards`` (times ``--feature-shards`` ranks): rank 0's result,
    with ``ranks`` (each rank's epoch
    time, kernel launches and, on a card, peak MiB), ``setup_s`` (the
    parent's plan and build seconds) and ``world_s`` (the world's wall
    seconds, from spawn to join)."""
    from hypergef_tpu_torch.parallel import launch
    from hypergef_tpu_torch.parallel.mesh import init_distributed
    from hypergef_tpu_torch.parallel.partition import plan_sharded_aggregation

    platform = "cpu" if args.platform == "cpu" else "cuda"
    t0 = time.perf_counter()
    plan = plan_sharded_aggregation(hg, args.shards)
    if init_distributed(args.dist_backend, platform) is not None:
        # under torchrun: this process is one rank
        res = _dist_rank(args, plan, (hg, x, y, split))
        res["ranks"] = [_rank_summary(res)]
        res["setup_s"] = time.perf_counter() - t0
        return res
    if platform == "cuda":
        # the kernels and the host library once, before the ranks start
        from hypergef_tpu_torch.ops import _build
        from hypergef_tpu_torch.sparse import native

        _build.build()
        native.build()
    setup_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    results = launch.spawn(_dist_rank, args.shards * args.feature_shards,
                           backend=args.dist_backend, platform=platform, args=(args, plan))
    res = dict(results[0])
    res.update(ranks=[_rank_summary(r) for r in results], setup_s=setup_s,
               world_s=time.perf_counter() - t0)
    return res


def _rank_summary(res: dict) -> dict:
    return {k: res[k] for k in ("train_epoch_time_s", "launches", "peak_mib", "step")
            if k in res}


def main(argv=None):
    args = parse(argv)
    device = "cpu" if args.platform == "cpu" else "cuda"

    from hypergef_tpu_torch.ops import fused
    from hypergef_tpu_torch.train import TrainConfig
    from hypergef_tpu_torch.train.minibatch import MinibatchTrainer
    from hypergef_tpu_torch.train.trainer import Trainer

    if args.validate_parity:
        from hypergef_tpu_torch.data.parity import validate

        results = validate(args.dname, root=args.data_path,
                           feature_noise=float(args.feature_noise), seed=args.seed,
                           record=args.parity_record, device=device)
        for r in results:
            print(r.line())
        failed = [r for r in results if r.status == "FAIL"]
        print(f"parity[{args.dname}]: {'FAIL' if failed else 'PASS'} "
              f"({sum(r.status == 'PASS' for r in results)} pass, {len(failed)} fail, "
              f"{sum(r.status == 'SKIP' for r in results)} skip)")
        sys.exit(1 if failed else 0)
    hg, x, y = load_problem(args)
    print(hg)
    split = _split(args, y)
    cfg = TrainConfig(
        model=args.model, nhid=args.nhid, nlayer=args.nlayer, nhead=args.nhead,
        first_aggr=args.first_aggr, dropout=args.dropout, input_drop=args.input_drop,
        activation=args.activation, lr=args.lr, wd=args.wd, epochs=args.epochs,
        seed=args.seed, backend=args.backend, tune=args.tune, plan_cache=args.plan_cache,
    )
    if args.shards > 0:
        res = run_distributed(args, hg, x, y, split)
        print(f"distributed ({res['n_shards']} shards): "
              f"avg epoch time {res['train_epoch_time_s']:.6f}")
        print(f"step: {res['step']}")
        for k in ("train_acc", "valid_acc", "test_acc", "final_loss"):
            if k in res:
                print(f"{k}: {res[k]:.4f}")
        return res
    if args.profile and device == "cuda":
        import torch

        torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    if args.minibatch_edges > 0 and not args.profile:
        tr = MinibatchTrainer(cfg, hg, x, y, split["train"], batch_edges=args.minibatch_edges,
                              device=device)
        route = "cumsum"
    else:
        tr = Trainer(cfg, hg, x, y, device=device)
        route = fused.resolve_backend(cfg.backend, tr.plan, nnz=hg.nnz)
    setup_s = time.perf_counter() - t0
    if args.profile:
        # the reference's --profile path (hgsys.py:146-159): the raw epoch
        # loop without the warm-up, then the device's memory
        # (hgsys.py:169-170,191)
        t0 = time.perf_counter()
        res = tr.fit(split["train"], epochs=args.epochs, warmup=0)
        print(f"epoch time: {time.perf_counter() - t0:.4f}")
        res.update(route=route, setup_s=setup_s)
        if device == "cuda":
            import torch

            res["device_memory_bytes"] = torch.cuda.memory_allocated()
            res["device_memory_peak_bytes"] = torch.cuda.max_memory_allocated()
            print(f"device memory: {res['device_memory_bytes'] / 2**20:.1f} MiB in use, "
                  f"{res['device_memory_peak_bytes'] / 2**20:.1f} MiB peak")
        return res
    if isinstance(tr, MinibatchTrainer):
        res = tr.fit(epochs=max(args.epochs // 10, 1))
        res.update(tr.evaluate_full(split))
        train_time = res["time_s"] / max(res["batches"], 1)
        infer_time = float("nan")
    else:
        res = tr.fit(split["train"])
        res["inference_time_s"] = tr.time_inference(iters=max(args.epochs // 2, 1))
        res.update(tr.evaluate(split))
        train_time = res["train_epoch_time_s"]
        infer_time = res["inference_time_s"]
    res.update(route=route, setup_s=setup_s)
    if args.export and isinstance(tr, Trainer):
        from hypergef_tpu_torch import serve

        plats = ([s.strip() for s in args.export_platforms.split(",") if s.strip()]
                 if args.export_platforms else None)
        meta = serve.export_trainer(tr, args.export, platforms=plats)
        print(f"exported serving artifact: {args.export} "
              f"({meta['payload_bytes']} bytes, platforms={meta['platforms']})")
        res["export_path"] = args.export
    elif args.export:
        print("--export requires the full-batch trainer path "
              "(exported programs are full-graph forwards); skipped", file=sys.stderr)
    backend = cfg.backend
    print(f"backend {backend} (route {route}): avg epoch time {train_time:.6f}")
    print(f"step: {res['step']}")
    for k in ("train_acc", "valid_acc", "test_acc", "final_loss"):
        if k in res:
            print(f"{k}: {res[k]:.4f}" if isinstance(res[k], float) else f"{k}: {res[k]}")
    if args.output:
        # the CSV row of hgsys.py:207-211
        with open(args.output, "a") as f:
            print(
                f"{backend},{args.model},{args.dname},nlayer={args.nlayer},"
                f" nhid={args.nhid}, nhead={args.nhead},"
                f"first_aggr={args.first_aggr},{train_time},{infer_time}",
                file=f,
            )
    return res


if __name__ == "__main__":
    main()
