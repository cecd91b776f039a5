#!/usr/bin/env python3
"""Seconds of ``chip_smoke.py``'s phases 29 and 30, for checkouts on the card, in turns.

    python3 hypergef_tpu_torch/tools/phases_ab.py [--rounds R] CHECKOUT [CHECKOUT ...]

Each CHECKOUT is the root of a tree holding a ``hypergef_tpu_torch``
package and its ``chip_smoke.py`` (this repo, or an older commit unpacked
with ``git archive``). For each one a worker process imports that tree's
package and ``chip_smoke.py``, builds what the two phases take from the
earlier ones (the kernels, SBM-60k and its aligned plan, stream100k with
its features and split) and runs ``minibatch_phase`` (phase 29) and
``dist_phase`` (phase 30) as ``chip_smoke.py`` does, timing each on the
host clock. Workers run in turns (A, B, B, A for two checkouts), ``R``
rounds of them (default 1). The phases' own lines go to the worker's
standard error; one JSON line a worker, then each checkout's medians over
its workers, then the card.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time


def worker() -> dict:
    import contextlib

    import torch

    import chip_smoke as cs
    from hypergef_tpu_torch.data.synthetic import random_features, random_hypergraph
    from hypergef_tpu_torch.ops import _build
    from hypergef_tpu_torch.train.splits import rand_train_test_idx

    device = torch.device("cuda", 0)
    card = cs.card_line()
    _build.load_library()
    with contextlib.redirect_stdout(sys.stderr):
        hg, plan, _ = cs.build_sbm60k()
        s = cs.STREAM100K
        stream = random_hypergraph(s["n"], s["e"], avg_edge_size=s["avg"], seed=0,
                                   name="stream100k")
        x, y = random_features(stream.num_nodes, cs.NFEAT, cs.NCLASS, seed=1)
        streamed = {"hg": stream, "problem": (x, y, rand_train_test_idx(y, seed=2))}
        t0 = time.perf_counter()
        cs.minibatch_phase(device, card, streamed)
        t29 = time.perf_counter() - t0
        t0 = time.perf_counter()
        cs.dist_phase(device, card, {"sbm": hg, "plan": plan})
        t30 = time.perf_counter() - t0
    return {"phase29_s": t29, "phase30_s": t30, "sum_s": t29 + t30}


def main() -> int:
    if sys.argv[1:2] == ["--worker"]:
        print(json.dumps(worker()), flush=True)
        return 0
    ap = argparse.ArgumentParser()
    ap.add_argument("--rounds", type=int, default=1)
    ap.add_argument("trees", nargs="+")
    args = ap.parse_args()
    trees = [os.path.abspath(t) for t in args.trees]
    order = (trees + trees[::-1] if len(trees) > 1 else trees) * args.rounds
    runs = {tree: [] for tree in trees}
    for tree in order:
        env = {**os.environ, "PYTHONPATH": tree}
        proc = subprocess.run([sys.executable, os.path.abspath(__file__), "--worker"],
                              env=env, cwd=tree, capture_output=True, text=True, check=False)
        if proc.returncode != 0:
            print(proc.stdout + proc.stderr, file=sys.stderr)
            return proc.returncode
        line = json.loads(proc.stdout.strip().splitlines()[-1])
        runs[tree].append(line)
        print(json.dumps({"tree": tree, **line}), flush=True)
    for tree, lines in runs.items():
        print(json.dumps({"tree": tree, "workers": len(lines), "median": {
            k: statistics.median(line[k] for line in lines) for k in lines[0]}}), flush=True)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True)
    print(f"card: {card.stdout.strip()}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
