#!/usr/bin/env python3
"""Host time to enqueue an eager step and request, for checkouts on the card, in turns.

    python3 hypergef_tpu_torch/tools/dispatch_ab.py [--rounds R] CHECKOUT [CHECKOUT ...]

Each CHECKOUT is the root of a tree holding a ``hypergef_tpu_torch``
package and its ``chip_smoke.py`` (this repo, or an older commit unpacked
with ``git archive``). For each one a worker process imports that tree's
package and ``chip_smoke.py`` and measures, as ``chip_smoke.py``'s phase 26
measures host enqueue (``host_enqueue_ms``: the median of 50 calls, each
timed alone on the host clock while the card runs behind), the host
milliseconds to enqueue one eager training step and one eager request of
HGNN on coauthor_dblp (the ``cumsum`` route, 1425 features, 6 classes;
``TrainConfig()`` otherwise), and one eager step on 20news on ``pallas``
(the fused dense kernel): what a wrapper's way to its kernel costs the
host, through a ``torch.library`` op or a direct call. Workers run in turns
(A, B, B, A for two checkouts), ``R`` rounds of them (default 1). One JSON
line a worker, then each checkout's medians over its workers, then the
card.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys

CALLS = 50


def worker() -> dict:
    import functools

    import torch

    import chip_smoke as cs
    from ab_eager import eager
    from hypergef_tpu_torch.serve import ServingModel
    from hypergef_tpu_torch.train.trainer import Trainer

    Trainer, ServingModel = eager(Trainer), eager(ServingModel)  # noqa: N806
    device = torch.device("cuda", 0)
    out = {}
    dblp = cs.make_graph("coauthor_dblp")
    cfg, hg, x, y, split, _ = cs.default_problem(dblp, cs.DBLP_NFEAT, cs.DBLP_NCLASS)
    tr = Trainer(cfg, hg, x, y, device=device)
    idx = torch.as_tensor(split["train"], device=device)
    out["coauthor_dblp step_ms"] = cs.host_enqueue_ms(functools.partial(tr.step, idx), CALLS)
    server = ServingModel(cfg, hg, cs.DBLP_NFEAT, cs.DBLP_NCLASS, device,
                          params=tr.model.state_dict())
    xd = torch.as_tensor(x, device=device)
    out["coauthor_dblp request_ms"] = cs.host_enqueue_ms(
        functools.partial(server.predict, xd), CALLS)
    news = cs.make_graph("20news")
    cfg, hg, x, y, split, _ = cs.default_problem(news, cs.NFEAT, cs.NCLASS, backend="pallas")
    tr = Trainer(cfg, hg, x, y, device=device)
    idx = torch.as_tensor(split["train"], device=device)
    out["20news pallas step_ms"] = cs.host_enqueue_ms(functools.partial(tr.step, idx), CALLS)
    return out


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
