#!/usr/bin/env python3
"""Time the fused dense kernel of one or more checkouts on the card, in turns.

    python3 hypergef_tpu_torch/tools/fused_dense_ab.py [--flag NAME=-DMACRO ...]
        [--clock] [--clock-flag NAME=-DMACRO ...] CHECKOUT [CHECKOUT ...]

Each CHECKOUT is the root of a tree holding a ``hypergef_tpu_torch``
package (this repo, or an older commit unpacked with ``git archive``). For
each one a worker process imports that tree's package, builds its kernels
and, on the graphs of ``chip_smoke.py`` (20news, cora, pubmed_real) at
F = 32, checks ``fused_dense_two_stage`` against its plain version (rtol
1e-2, atol 1e-2·max|plain|), times it with CUDA events behind a queued
sleep (median of 20), and records one call under ``torch.profiler`` (the
tree's ``utils/profiling.py::profiler`` where it has one, through
``ab_eager.profiler``): the CUDA kernels it launched,
with their device times. The first checkout's
worker also times the plain version and the library yardstick (two
``torch.mm(..., out_dtype=torch.float32)`` on a bf16 copy of H made before
the window, with the two scalings). Workers run in turns (A, B, B, A for
two checkouts) so that a drift of the card shows. ``--flag`` adds a build
of the first checkout with extra nvcc macros (e.g. ``noskip=-DHG_FD_NO_ZERO_SKIP``).
``--clock`` adds a build with ``-DHG_FD_PHASE_CLOCK``, which makes
three calls a graph and prints the device's phase times (CTA 0's
``%globaltimer`` at each grid barrier); ``--clock-flag NAME=-DMACRO`` a
clocked build with more macros (the ablation ``-DHG_FD_ABLATE_PRODUCTS``,
no products: wrong results, for its times only). One JSON line a worker; a
last line with the card.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

GRAPHS = {
    "20news": dict(n=16242, e=100, avg=654.5),
    "cora": dict(n=2708, e=2708, avg=4.0),
    "pubmed_real": dict(n=19717, e=7963, avg=10.8),
}
F = 32


def worker(args) -> dict:
    import numpy as np
    import torch

    from hypergef_tpu_torch.data.synthetic import random_hypergraph
    from hypergef_tpu_torch.ops import _build, fused_dense
    from hypergef_tpu_torch.sparse.planner import DenseIncidence
    from hypergef_tpu_torch.utils.timing import cuda_time_ms

    _build.NVCC_FLAGS = (*_build.NVCC_FLAGS, *args.nvcc_flag)
    dev = torch.device("cuda", 0)
    _build.load_library()
    res = {"tree": os.getcwd(), "flags": args.nvcc_flag, "graphs": {}}
    for name, g in GRAPHS.items():
        hg = random_hypergraph(g["n"], g["e"], avg_edge_size=g["avg"], seed=0, name=name)
        rng = np.random.default_rng(7)
        hgd = hg.device_data(dev)
        h = DenseIncidence.from_hypergraph(hg, dev).h
        x = torch.as_tensor(rng.normal(size=(hg.num_nodes, F)).astype(np.float32), device=dev)
        wd = torch.as_tensor(rng.uniform(0.5, 1.5, size=(hg.num_edges, 1)).astype(np.float32),
                             device=dev)
        ops = (h, x, (hgd.degE * wd).contiguous(), hgd.degV)
        if args.calls_only:
            for _ in range(3):
                fused_dense.fused_dense_two_stage(*ops)
            torch.cuda.synchronize()
            continue
        got = fused_dense.fused_dense_two_stage(*ops)
        again = fused_dense.fused_dense_two_stage(*ops)
        want = fused_dense.fused_dense_two_stage_plain(*ops)
        torch.cuda.synchronize()
        scale = float(want.abs().max())
        torch.testing.assert_close(got, want, rtol=1e-2, atol=1e-2 * scale)
        r = {"max_abs_err": float((got - want).abs().max()), "max_abs_plain": scale,
             "bitwise_repeat": bool(torch.equal(got, again)),
             "kernel_ms": cuda_time_ms(lambda: fused_dense.fused_dense_two_stage(*ops))}
        if args.yardsticks:
            hb = h.to(torch.bfloat16)
            se, sv = ops[2], ops[3]

            def library():
                xe = torch.mm(hb.t(), x.to(torch.bfloat16), out_dtype=torch.float32) * se
                return torch.mm(hb, xe.to(torch.bfloat16), out_dtype=torch.float32) * sv

            lib = library()
            torch.testing.assert_close(lib, want, rtol=1e-2, atol=1e-2 * scale)
            r["plain_ms"] = cuda_time_ms(lambda: fused_dense.fused_dense_two_stage_plain(*ops))
            r["library_ms"] = cuda_time_ms(library)
        from ab_eager import profiler

        torch.cuda.synchronize()
        with profiler() as prof:
            fused_dense.fused_dense_two_stage(*ops)
            torch.cuda.synchronize()
        kernels = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
        r["cuda_kernels_per_call"] = len(kernels)
        r["kernels_ms"] = [[e.name[:60], e.device_time_total / 1e3] for e in kernels]
        res["graphs"][name] = r
    res["card"] = torch.cuda.get_device_name(0)
    return res


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("trees", nargs="*")
    ap.add_argument("--flag", action="append", default=[])
    ap.add_argument("--clock", action="store_true")
    ap.add_argument("--clock-flag", action="append", default=[])
    ap.add_argument("--calls-only", action="store_true")
    ap.add_argument("--worker", action="store_true")
    ap.add_argument("--nvcc-flag", action="append", default=[])
    ap.add_argument("--yardsticks", action="store_true")
    args = ap.parse_args()
    if args.worker:
        print(json.dumps(worker(args)), flush=True)
        return 0
    if not args.trees:
        ap.error("name at least one checkout")
    first = os.path.abspath(args.trees[0])
    runs = [[os.path.abspath(t)] + (["--yardsticks"] if i == 0 else [])
            for i, t in enumerate(args.trees)]
    runs += [[first, *(f"--nvcc-flag={m}" for m in f.split("=", 1)[1].split())]
             for f in args.flag]
    order = runs + runs[::-1]
    if args.clock:
        order.append([first, "--nvcc-flag=-DHG_FD_PHASE_CLOCK", "--calls-only"])
    for f in args.clock_flag:
        order.append([first, "--nvcc-flag=-DHG_FD_PHASE_CLOCK",
                      *(f"--nvcc-flag={m}" for m in f.split("=", 1)[1].split()), "--calls-only"])
    failed = 0
    for tree, *opts in order:
        cmd = [sys.executable, os.path.abspath(__file__), "--worker", *opts]
        env = {**os.environ, "PYTHONPATH": tree}
        proc = subprocess.run(cmd, cwd=tree, env=env, capture_output=True, text=True,
                              check=False)
        if proc.returncode != 0:
            failed += 1
            print(json.dumps({"tree": tree, "opts": opts, "rc": proc.returncode,
                              "stderr": proc.stderr[-3000:]}), flush=True)
        else:
            lines = proc.stdout.strip().splitlines()
            if "--calls-only" in opts:
                print(f"clocked: {' '.join(opts)}")
            print("\n".join([ln for ln in lines[:-1] if ln.startswith("fused_dense phases")]
                            + lines[-1:]), flush=True)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=False).stdout.strip()
    print(f"card: {card}")
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
