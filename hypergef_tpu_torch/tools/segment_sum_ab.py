#!/usr/bin/env python3
"""Time the segment-sum kernel and the max backward of checkouts on the card, in turns.

    python3 hypergef_tpu_torch/tools/segment_sum_ab.py CHECKOUT [CHECKOUT ...]

Each CHECKOUT is the root of a tree holding a ``hypergef_tpu_torch``
package and its ``chip_smoke.py`` (this repo, or an older commit unpacked
with ``git archive``). For each one a worker process imports that tree's
package, builds its kernels and measures, with CUDA events behind a queued
sleep (median of 20 windows of 10 calls):

* ``gather_segment_sum`` on both directions of coauthor_dblp at F = 32 and
  6 (the widths of the cumsum route's HGNN layers), checked against its
  plain version (rtol 1e-6, atol 1e-6·max|plain|);
* the max backward's record-routed sum (``dx[v] = Σ_{e ∋ v} g[e]·[arg[e] ==
  v]``, F = 32 and the classes' width: 6 at coauthor_dblp, 4 at SBM-60k and
  stream100k) over the vertex-major CSR of each graph, with int32 ids (the
  type the tree and the aligned argmax give) and int64 ids, each id a
  member of its edge: the tree's own ``record_routed_dx`` (over
  ``HypergraphData.record`` where the tree has it, else over ``.e2v``: the
  masked form of the sum; or in a tree older than both the plain
  composition of two row gathers, a compare and a segment sum), checked
  against the plain composition;
* training steps (wall: 10 back-to-back steps, host included; device: one
  step behind a queued sleep; medians of 20) of HGNN max on SBM-60k
  (aligned kernel form and aligned plain form), stream100k (``bitstream``,
  with the tree for max) and coauthor_dblp (the default ``cumsum`` route),
  and of HGNN sum on coauthor_dblp; and the SBM-60k max steps' device busy
  time under ``torch.profiler`` (10 steps), which a step that waits on the
  host longer than the queued sleep does not inflate.

The first checkout's worker also times the plain versions and
``torch.sparse.mm`` of the segment sum's CSR (the library yardstick).
Workers run in turns (A, B, B, A for two checkouts) so that a drift of the
card shows. Each worker prints a digest of every kernel output; the last
lines say whether each output is bitwise equal across the checkouts (exit
1 if not) and name the card. One JSON line a worker.
"""

from __future__ import annotations

import argparse
import dataclasses
import hashlib
import json
import os
import subprocess
import sys

F = 32


def record_operands(hgd, f: int, seed: int, device, dtype):
    """(g [E, F], arg [E, F]) for the record-routed sum over ``hgd.e2v``: g
    normal, and for each (edge, feature) a member of the edge drawn at
    random (-1 for an empty edge), as a record table holds them."""
    import torch

    gen = torch.Generator(device=device).manual_seed(seed)
    e, ip = hgd.num_edges, hgd.ht_indptr
    g = torch.randn((e, f), generator=gen, device=device)
    size = ip[1:] - ip[:-1]
    pick = (torch.rand((e, f), generator=gen, device=device) * size[:, None]).long()
    pos = ip[:-1, None] + torch.minimum(pick, (size - 1).clamp(min=0)[:, None])
    member = hgd.ht_vertex[pos.clamp(max=max(hgd.ht_vertex.numel() - 1, 0))]
    return g, torch.where(size[:, None] > 0, member, -1).to(dtype).contiguous()


def plain_record(g, arg, hgd):
    """The record-routed sum of a tree older than
    ``segment_sum.record_routed_dx_plain``: two row gathers, a compare with
    each entry's vertex, the direct sorted segment sum."""
    import torch

    gg, ga = g.index_select(0, hgd.h_edge), arg.index_select(0, hgd.h_edge)
    vals = torch.where(ga == hgd.h_segids[:, None], gg, 0.0)
    lengths = hgd.h_indptr[1:] - hgd.h_indptr[:-1]
    return torch.segment_reduce(vals, "sum", lengths=lengths, axis=0, unsafe=True)


def busy_ms(trainer, idx, steps: int = 10) -> float:
    """The card's busy time a step under ``torch.profiler`` (the tree's
    ``utils/profiling.py::profiler`` where it has one, through
    ``ab_eager.profiler``): the sum of its kernels' device times
    over ``steps`` steps (after 5 warm-up steps), leaving out the
    optimizer's range annotation, which is no kernel."""
    import torch

    from ab_eager import profiler

    for _ in range(5):
        trainer.step(idx)
    torch.cuda.synchronize()
    with profiler() as prof:
        for _ in range(steps):
            trainer.step(idx)
        torch.cuda.synchronize()
    return sum(e.self_device_time_total for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and not e.key.startswith("Optimizer.")) / steps / 1e3


def worker(yardsticks: bool) -> dict:
    import numpy as np
    import torch

    import chip_smoke as cs
    from hypergef_tpu_torch.ops import _build, maxops, segment_sum
    from hypergef_tpu_torch.utils.timing import cuda_time_ms

    dev = torch.device("cuda", 0)
    _build.load_library()
    res = {"tree": os.getcwd(), "segment_sum": {}, "record": {}, "steps": {}, "busy_ms": {},
           "digests": {}}

    def digest(t) -> str:
        return hashlib.sha256(t.cpu().numpy().tobytes()).hexdigest()[:16]

    def timed(fn):
        return cuda_time_ms(fn, repeats=20, iters=10)

    def held(got, want):
        scale = float(want.abs().max())
        torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6 * scale)
        return float((got - want).abs().max())

    dblp = cs.make_graph("coauthor_dblp")
    dd = dblp.device_data(dev)
    for f in (F, 6):
        for stage in ("v2e", "e2v"):
            table = getattr(dd, stage)
            x = torch.as_tensor(np.random.default_rng(f).normal(size=(table.num_inputs, f))
                                .astype(np.float32), device=dev)
            want = segment_sum.gather_segment_sum_plain(x, table)
            got = segment_sum.gather_segment_sum(x, table)
            res["digests"][f"segment_sum {stage} F={f}"] = digest(got)
            r = {"max_abs_err": held(got, want),
                 "kernel_ms": timed(lambda: segment_sum.gather_segment_sum(x, table))}
            if yardsticks:
                csr = cs.incidence_csr(dblp, "edge" if stage == "v2e" else "vertex", dev)
                r["plain_ms"] = timed(lambda: segment_sum.gather_segment_sum_plain(x, table))
                r["library_ms"] = timed(lambda: torch.sparse.mm(csr, x))
            res["segment_sum"][f"{stage} F={f}"] = r

    new = hasattr(segment_sum, "record_routed_dx")
    sbm, al_plan, _ = cs.build_sbm60k()
    s100k, bits, tree, _ = cs.build_stream100k()
    graphs = {"coauthor_dblp": (dblp, cs.DBLP_NCLASS), "sbm60k": (sbm, cs.NCLASS),
              "stream100k": (s100k, cs.NCLASS)}
    for name, (hg, nclass) in graphs.items():
        hgd = hg.device_data(dev)
        table = getattr(hgd, "record", None) or hgd.e2v  # the tree's own table
        for f in (F, nclass):
            for dtype in (torch.int32, torch.int64):
                g, arg = record_operands(hgd, f, 27, dev, dtype)
                if new:
                    def call(g=g, arg=arg):
                        return segment_sum.record_routed_dx(g, arg, table)

                    def plain(g=g, arg=arg):
                        return segment_sum.record_routed_dx_plain(g, arg, table)
                else:
                    def call(g=g, arg=arg, hgd=hgd):
                        return maxops.record_routed_dx(g, arg, hgd.h_edge, hgd.h_segids,
                                                       hgd.h_indptr)

                    def plain(g=g, arg=arg, hgd=hgd):
                        return plain_record(g, arg, hgd)
                got = call()
                key = f"{name} F={f} {str(dtype).split('.')[-1]}"
                res["digests"][f"record {key}"] = digest(got)
                r = {"nnz": hg.nnz, "max_abs_err": held(got, plain()), "ms": timed(call)}
                if yardsticks:
                    r["plain_ms"] = timed(plain)
                res["record"][key] = r

    from hypergef_tpu_torch.data.synthetic import random_features
    from hypergef_tpu_torch.sparse.planner import AggregationPlan
    from hypergef_tpu_torch.train.splits import rand_train_test_idx
    from ab_eager import eager
    from hypergef_tpu_torch.train.trainer import TrainConfig, Trainer
    Trainer = eager(Trainer)  # noqa: N806

    trainers, idx = {}, {}
    cfg, hg, x, y, split, plan = cs.sbm_problem(sbm, al_plan)
    mcfg = dataclasses.replace(cfg, first_aggr="max")
    for name, p in (("sbm60k HGNN max aligned", plan),
                    ("sbm60k HGNN max aligned plain", AggregationPlan(aligned=al_plan))):
        trainers[name] = Trainer(mcfg, hg, x, y, plan=p, device=dev)
        idx[name] = split["train"]
    x, y = random_features(s100k.num_nodes, cs.NFEAT, cs.NCLASS, seed=1)
    cfg = TrainConfig(model="HGNN", nhid=32, nlayer=2, first_aggr="max", backend="bitstream")
    trainers["stream100k HGNN max bitstream"] = Trainer(
        cfg, s100k, x, y, plan=AggregationPlan(bitstream=bits, tree=tree), device=dev)
    idx["stream100k HGNN max bitstream"] = rand_train_test_idx(y, seed=2)["train"]
    for name, aggr in (("coauthor_dblp HGNN max cumsum", "max"),
                       ("coauthor_dblp HGNN sum cumsum", "sum")):
        cfg, hg, x, y, split, _ = cs.default_problem(dblp, cs.DBLP_NFEAT, cs.DBLP_NCLASS,
                                                     first_aggr=aggr)
        trainers[name] = Trainer(cfg, hg, x, y, device=dev)
        idx[name] = split["train"]
    for name, tr in trainers.items():
        res["steps"][name] = cs.time_steps({name: tr}, idx[name], (name,), dev)[name]
        if name.startswith("sbm60k"):
            res["busy_ms"][name] = busy_ms(tr, torch.as_tensor(idx[name], device=dev))
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
    failed, digests = 0, {}
    for tree, *opts in runs + runs[::-1]:
        cmd = [sys.executable, os.path.abspath(__file__), "--worker", *opts]
        env = {**os.environ, "PYTHONPATH": tree}
        proc = subprocess.run(cmd, cwd=tree, env=env, capture_output=True, text=True,
                              check=False)
        if proc.returncode != 0:
            failed += 1
            print(json.dumps({"tree": tree, "opts": opts, "rc": proc.returncode,
                              "stderr": proc.stderr[-3000:]}), flush=True)
            continue
        line = proc.stdout.strip().splitlines()[-1]
        print(line, flush=True)
        for key, d in json.loads(line)["digests"].items():
            digests.setdefault(key, set()).add(d)
    equal = {key: len(ds) == 1 for key, ds in digests.items()}
    print(json.dumps({"bitwise_equal_across_checkouts": equal}), flush=True)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=False).stdout.strip()
    print(f"card: {card}")
    return 1 if failed or not all(equal.values()) else 0


if __name__ == "__main__":
    sys.exit(main())
