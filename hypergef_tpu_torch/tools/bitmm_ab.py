#!/usr/bin/env python3
"""Time the bit-packed product (bitmm) and the bitstream route of checkouts on the card, in turns.

    python3 hypergef_tpu_torch/tools/bitmm_ab.py CHECKOUT [CHECKOUT ...]

Each CHECKOUT is the root of a tree holding a ``hypergef_tpu_torch``
package and its ``chip_smoke.py`` (this repo, or an older commit unpacked
with ``git archive``). For each one a worker process imports that tree's
package, builds its kernels and measures, with CUDA events (medians of 20
windows):

* ``bitmm`` on both packs of stream100k (``random_hypergraph(100000,
  20000, avg 60)``: Hᵀ, V→E, and H, E→V) and of the pubmed_real box, at
  F = 32 and 4 (the widths of the HGNN layers), behind a queued sleep,
  windows of 10 calls, each checked once against the plain twin (rtol
  1e-5, atol 1e-5·max|plain|), with the bound over the whole pack and,
  where the tree's packs carry the kernel's layout, over the layout, and
  the host's time to enqueue a call (200 calls on the host clock, then
  one synchronize);
* training steps on stream100k through ``bitstream`` (wall: 10
  back-to-back steps, host included; device: one step behind a queued
  sleep) of HGNN sum, HGNN max (the tree for the argmax) and UniGCNII;
* a stream100k HGNN request (``ServingModel.predict``, host included).

A tree whose ``bitmm`` takes (words, x, m, k) (before the kernel read a
layout) is called that way. The first checkout's worker also times one
``torch.sparse.mm`` of each pack's CSR on bf16(x) (the library yardstick).
Workers run in turns (A, B, B, A for two checkouts) so that a drift of the
card shows. One JSON line a worker; a last line with the card.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import sys


def worker(yardsticks: bool) -> dict:
    import time

    import numpy as np
    import torch

    import chip_smoke as cs
    from hypergef_tpu_torch.ops import _build, bitstream
    from hypergef_tpu_torch.ops.bitstream import BitIncidence
    from hypergef_tpu_torch.ops.fused_dense import bf16_round
    from hypergef_tpu_torch.utils.timing import cuda_time_ms

    dev = torch.device("cuda", 0)
    _build.load_library()
    res = {"tree": os.getcwd(), "kernels": {}, "steps": {}}
    layout = hasattr(bitstream, "BitLayout")

    def call(pack, x):
        if layout:
            return bitstream.bitmm(pack, x)
        return bitstream.bitmm(pack.words, x, pack.m, pack.k)

    s100k, bits, tree, _ = cs.build_stream100k()
    pub = cs.make_graph("pubmed_real")
    graphs = {"stream100k": (s100k, bits), "pubmed_real": (pub, BitIncidence.from_hypergraph(pub))}
    for gname, (hg, bi) in graphs.items():
        packs = dict(zip(("H", "Ht"), bi.device(dev)))
        for f in (32, 4):
            for name, stage in (("Ht", "edge"), ("H", "vertex")):
                p = packs[name]
                x = torch.as_tensor(np.random.default_rng(16).normal(size=(p.k, f))
                                    .astype(np.float32), device=dev)
                want = bitstream.bitmm_plain(p.words, x, p.m, p.k)
                got = call(p, x)
                scale = float(want.abs().max())
                torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5 * scale)
                rest, ops = cs.nbytes(x) + p.m * f * 4, hg.nnz * f
                r = {"ms": cuda_time_ms(lambda p=p, x=x: call(p, x), repeats=20, iters=10),
                     "max_abs_err": float((got - want).abs().max()),
                     "pack_bound_ms": cs.bound(p.m * p.words.shape[1] * 4 + rest, ops)["bound_ms"]}
                if layout:
                    r["layout_bound_ms"] = cs.bound(p.layout.nbytes() + rest, ops)["bound_ms"]
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                for _ in range(200):
                    call(p, x)
                r["host_us"] = (time.perf_counter() - t0) / 200 * 1e6
                torch.cuda.synchronize()
                if yardsticks:
                    csr, xb = cs.incidence_csr(hg, stage, dev), bf16_round(x)
                    r["library_ms"] = cuda_time_ms(lambda c=csr, v=xb: torch.sparse.mm(c, v),
                                                   repeats=20, iters=10)
                res["kernels"][f"{gname} {name} F={f}"] = r

    from hypergef_tpu_torch.data.synthetic import random_features
    from ab_eager import eager
    from hypergef_tpu_torch.serve import ServingModel
    ServingModel = eager(ServingModel)  # noqa: N806
    from hypergef_tpu_torch.sparse.planner import AggregationPlan
    from hypergef_tpu_torch.train.splits import rand_train_test_idx
    from hypergef_tpu_torch.train.trainer import TrainConfig, Trainer
    Trainer = eager(Trainer)  # noqa: N806

    x, y = random_features(s100k.num_nodes, cs.NFEAT, cs.NCLASS, seed=1)
    idx = rand_train_test_idx(y, seed=2)["train"]
    base = TrainConfig(model="HGNN", nhid=32, nlayer=2, first_aggr="sum", backend="bitstream")
    configs = {"HGNN sum": (base, None),
               "HGNN max": (dataclasses.replace(base, first_aggr="max"), tree),
               "UniGCNII": (dataclasses.replace(base, model="UniGCNII"), None)}
    for name, (cfg, t) in configs.items():
        tr = Trainer(cfg, s100k, x, y, plan=AggregationPlan(bitstream=bits, tree=t), device=dev)
        res["steps"][name] = cs.time_steps({name: tr}, idx, (name,), dev)[name]
    server = ServingModel(base, s100k, cs.NFEAT, cs.NCLASS, dev,
                          plan=AggregationPlan(bitstream=bits))
    xd = torch.as_tensor(x, device=dev)
    res["request_ms"] = cuda_time_ms(lambda: server.predict(xd), repeats=20, queue_ahead=False)
    res["card"] = torch.cuda.get_device_name(0)
    return res


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("trees", nargs="*")
    ap.add_argument("--worker", action="store_true")
    ap.add_argument("--yardsticks", action="store_true")
    args = ap.parse_args()
    if args.worker:
        print(json.dumps(worker(args.yardsticks)), flush=True)
        return 0
    if not args.trees:
        ap.error("name at least one checkout")
    runs = [[os.path.abspath(t)] + (["--yardsticks"] if i == 0 else [])
            for i, t in enumerate(args.trees)]
    failed = 0
    for tree, *opts in runs + runs[::-1]:
        cmd = [sys.executable, os.path.abspath(__file__), "--worker", *opts]
        env = {**os.environ, "PYTHONPATH": tree}
        proc = subprocess.run(cmd, cwd=tree, env=env, capture_output=True, text=True,
                              check=False)
        if proc.returncode != 0:
            failed += 1
            print(json.dumps({"tree": tree, "opts": opts, "rc": proc.returncode,
                              "stderr": proc.stderr[-3000:]}), flush=True)
        else:
            print(proc.stdout.strip().splitlines()[-1], flush=True)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=False).stdout.strip()
    print(f"card: {card}")
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
