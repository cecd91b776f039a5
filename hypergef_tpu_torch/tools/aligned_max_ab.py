#!/usr/bin/env python3
"""Time the aligned max kernels and the SBM-60k max step of checkouts on the card, in turns.

    python3 hypergef_tpu_torch/tools/aligned_max_ab.py CHECKOUT [CHECKOUT ...]

Each CHECKOUT is the root of a tree holding a ``hypergef_tpu_torch``
package and its ``chip_smoke.py`` (this repo, or an older commit unpacked
with ``git archive``). For each one a worker process imports that tree's
package, builds its kernels, builds SBM-60k from raw input
(``chip_smoke.build_sbm60k``) and measures, with CUDA events (medians of
20 windows):

* the masked argmax kernel on the bucketed plan's edge stage at F = 32 and
  4 (the widths of the HGNN layers), behind a queued sleep, windows of 10
  calls, checked once against the plain twin (values and ids bitwise), with
  the bound over the stage's flat tables and, where the tree lays out the
  live list (``aligned_max.LiveLayout``), over the layout;
* the masked arg-sum kernel on the uniform plan's vertex stage at F = 32
  and 4, its ids those of the argmax twin on the edge stage, checked once
  against its twin (rtol 1e-6, atol 1e-6·max|plain|), with both bounds;
* the SBM-60k HGNN max training step on the aligned kernel form (wall: 10
  back-to-back steps, host included; device: one step behind a queued
  sleep) and its device busy time under ``torch.profiler``, and a max
  request (``ServingModel.predict``, host included).

Each worker prints a digest of every kernel output; the last lines say
whether each output is bitwise equal across the checkouts. The first
checkout's worker also times ``torch.zeros(N, F).scatter_add_(0, ids, g)``
for the arg-sum (the library yardstick). Workers run in turns (A, B, B, A
for two checkouts) so that a drift of the card shows. One JSON line a
worker; then the digests' verdict and the card.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import sys


def worker(yardsticks: bool) -> dict:
    import hashlib

    import numpy as np
    import torch

    import chip_smoke as cs
    from hypergef_tpu_torch.ops import _build, aligned_max
    from hypergef_tpu_torch.serve import ServingModel
    from hypergef_tpu_torch.sparse.planner import plan_aligned
    from hypergef_tpu_torch.tools.segment_sum_ab import busy_ms
    from hypergef_tpu_torch.train.trainer import Trainer
    from hypergef_tpu_torch.utils.timing import cuda_time_ms

    dev = torch.device("cuda", 0)
    _build.load_library()
    res = {"tree": os.getcwd(), "kernels": {}, "digests": {}}
    layout = hasattr(aligned_max, "LiveLayout")

    def digest(*ts) -> str:
        h = hashlib.sha256()
        for t in ts:
            h.update(t.cpu().numpy().tobytes())
        return h.hexdigest()[:16]

    def normal(rows, f, seed):
        return torch.as_tensor(np.random.default_rng(seed).normal(size=(rows, f))
                               .astype(np.float32), device=dev)

    def bounds(stage, moved: int, ops: int) -> dict:
        """The bound over the stage's flat tables and, with a layout, over
        it (and the spill sources its chunks name)."""
        out = {"tables_bound_ms": cs.bound(cs.stage_table_bytes(stage) + moved, ops)["bound_ms"]}
        if layout:
            live = stage.band.live
            out["layout_bound_ms"] = cs.bound(live.nbytes() + cs.nbytes(stage.band.src) + moved,
                                              ops)["bound_ms"]
            out["layout_bytes"] = live.nbytes()
            out["layout_build_s"] = live.build_s
        return out

    sbm, al_plan, _ = cs.build_sbm60k()
    kernel = dataclasses.replace(al_plan, form="pallas_auto")
    e_st, _ = kernel.device(dev)
    uni_e, uni_v = dataclasses.replace(plan_aligned(sbm, form="uniform"),
                                       form="pallas_auto").device(dev)
    for f in (32, 4):
        x = normal(sbm.num_nodes, f, 13)
        val, arg = aligned_max.aligned_masked_argmax(x, e_st)
        want_val, want_arg = aligned_max.aligned_max_plain(x, e_st)
        cs.check(torch.equal(val, want_val) and torch.equal(arg, want_arg),
                 "argmax kernel bitwise equal to its twin")
        res["digests"][f"argmax edge F={f}"] = digest(val, arg)
        res["kernels"][f"argmax edge F={f}"] = {
            "ms": cuda_time_ms(lambda x=x: aligned_max.aligned_masked_argmax(x, e_st),
                               repeats=20, iters=10),
            **bounds(e_st, cs.nbytes(x) + e_st.num_segments * f * 8, cs.stage_live(e_st) * f)}

        _, ids = aligned_max.aligned_max_plain(normal(sbm.num_nodes, f, 71), uni_e)
        g = normal(uni_v.num_inputs, f, 72)
        got = aligned_max.aligned_masked_argsum(g, ids, uni_v)
        want = aligned_max.aligned_argsum_plain(g, ids, uni_v)
        torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6 * float(want.abs().max()))
        res["digests"][f"argsum vertex F={f}"] = digest(got)
        r = {"ms": cuda_time_ms(lambda g=g, ids=ids: aligned_max.aligned_masked_argsum(
                 g, ids, uni_v), repeats=20, iters=10),
             "max_abs_err": float((got - want).abs().max()),
             **bounds(uni_v, cs.nbytes(g, ids) + uni_v.num_segments * f * 4,
                      cs.stage_live(uni_v) * f)}
        if yardsticks:
            library, why = cs.scatter_yardstick(g, ids, uni_v.num_segments, want)
            r["library_ms"] = (cuda_time_ms(library, repeats=20, iters=10) if library
                               else None)
            if why:
                r["library_note"] = why
        res["kernels"][f"argsum vertex F={f}"] = r

    cfg, hg, x, y, split, plan = cs.sbm_problem(sbm, al_plan)
    mcfg = dataclasses.replace(cfg, first_aggr="max")
    tr = Trainer(mcfg, hg, x, y, plan=plan, device=dev)
    name = "sbm60k HGNN max aligned"
    res["step"] = cs.time_steps({name: tr}, split["train"], (name,), dev)[name]
    res["step"]["busy_ms"] = busy_ms(tr, torch.as_tensor(split["train"], device=dev))
    server = ServingModel(mcfg, sbm, cs.NFEAT, cs.NCLASS, dev, plan=plan)
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
