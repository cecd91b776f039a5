#!/usr/bin/env python3
"""Time the ELL chunk sum (gather kernel, probes' ring) of checkouts on the card, in turns.

    python3 hypergef_tpu_torch/tools/ell_gather_ab.py CHECKOUT [CHECKOUT ...]

Each CHECKOUT is the root of a tree holding a ``hypergef_tpu_torch``
package and its ``chip_smoke.py`` (this repo, or an older commit unpacked
with ``git archive``). For each one a worker process imports that tree's
package, builds its kernels and measures, with CUDA events behind a queued
sleep (median of 20 windows of 10 calls):

* ``ell_gather_sum`` on the level-0 tables of both stages of the
  pubmed_real ``plan_pallas_sparse`` plan at F = 32 and 3 (the widths of
  its HGNN layers), and on ``probe_r2_gather``'s table at its 2M-row scale
  ("big pallas_vmem": N 2,000,000, C 1,249,792, ngs 8, F 32, the probe's
  own draw);
* the probes' chunk-sum ring (``probes.chunk_masked_sum_ring``) at n_buf
  4, 8 and 16 on ``probe_r2_gather``'s table at each of its scales (tiny,
  pubmed, big), and at ``probe_r2b_bisect``'s k5 (two chunks of two rows,
  F 128);
* the pubmed_real ``pallas_sparse`` training step (wall: 10 back-to-back
  steps, host included; device: one step behind a queued sleep; medians of
  20).

Every output is checked bitwise against the plain loop on the card. The
first checkout's worker also times the plain loop and ``torch.sparse.mm``
of the table's CSR (the library yardstick) and gives two bounds: the
distinct rows of x the table names, each read once, and every named row
read once (at the 2M scale x is 5x the L2, so most of the repeats come from
HBM), each with the tables and the output, over 3.35 TB/s. Workers run in
turns (A, B, B, A for two checkouts) so that a drift of the card shows.
Each worker prints a digest of every output; the last lines say whether
each output is bitwise equal across the checkouts (exit 1 if not) and name
the card. One JSON line a worker.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import subprocess
import sys

HBM_BYTES_PER_S = 3.35e12


def r2_table(n: int, nnz: int, f: int):
    """``probes.probe_r2_gather``'s draw at one scale: x, gidx, mask (NumPy)."""
    import numpy as np

    c = nnz // 8
    rng = np.random.default_rng(0)
    gidx = rng.integers(0, n, size=(c, 8)).astype(np.int32)
    gmask = (rng.random((c, 8)) > 0.1).astype(np.float32)
    x = rng.normal(size=(n, f)).astype(np.float32)
    return x, gidx, gmask


def k5_table():
    """``probes.probe_r2b_bisect``'s k5: out[k] = x[idx[0,k]] + x[idx[1,k]]."""
    import numpy as np

    rng = np.random.default_rng(0)
    x = rng.normal(size=(1024, 128)).astype(np.float32)
    idx = rng.integers(0, 1024, size=(64, 8)).astype(np.int32)
    pair = np.ascontiguousarray(np.stack([idx[0, :2], idx[1, :2]], axis=1))
    return x, pair, np.ones((2, 2), np.float32)


def bounds(x, gidx, mask) -> dict:
    """Bytes over the memory rate: the distinct rows named, and every named
    row; each with the index and mask tables and the output."""
    import torch

    c, ngs = gidx.shape
    row = x.shape[1] * 4
    rest = 2 * gidx.numel() * 4 + c * row
    distinct = int(torch.unique(gidx).numel())
    return {"bound_distinct_ms": (distinct * row + rest) / HBM_BYTES_PER_S * 1e3,
            "bound_named_ms": (c * ngs * row + rest) / HBM_BYTES_PER_S * 1e3,
            "distinct_rows": distinct}


def worker(yardsticks: bool) -> dict:
    import numpy as np
    import torch

    import chip_smoke as cs
    from hypergef_tpu_torch import probes
    from hypergef_tpu_torch.ops import _build, ell_gather
    from hypergef_tpu_torch.sparse.planner import plan_pallas_sparse
    from hypergef_tpu_torch.utils.timing import cuda_time_ms

    dev = torch.device("cuda", 0)
    _build.load_library()
    res = {"tree": os.getcwd(), "gather": {}, "ring": {}, "steps": {}, "digests": {}}

    def digest(t) -> str:
        return hashlib.sha256(t.cpu().numpy().tobytes()).hexdigest()[:16]

    def timed(fn):
        return cuda_time_ms(fn, repeats=20, iters=10)

    def measure(key, call, plain, table_args, out, csr=None):
        got = call()
        want = plain()
        if not torch.equal(got, want):
            raise RuntimeError(f"{key}: the kernel differs from the plain loop "
                               f"({float((got - want).abs().max())})")
        res["digests"][key] = digest(got)
        r = {"ms": timed(call)}
        if yardsticks:
            r["plain_ms"] = timed(plain)
            if csr is not None:
                r["library_ms"] = timed(lambda: torch.sparse.mm(csr, table_args[0]))
            r.update(bounds(*table_args))
        out[key] = r

    def gather_case(key, x, table):
        measure(key, lambda: ell_gather.ell_gather_sum(x, table),
                lambda: ell_gather.ell_gather_sum_plain(x, table.gidx_long, table.mask),
                (x, table.gidx, table.mask), res["gather"],
                cs.gather_csr(table) if yardsticks else None)

    def ring_cases(key, x, gidx, mask):
        # one library time a table, beside its first depth
        csr = probes._chunk_csr(gidx.long(), mask, x.shape[0]) if yardsticks else None
        for nb in probes.RING_DEPTHS:
            measure(f"{key} n_buf={nb}",
                    lambda nb=nb: probes.chunk_masked_sum_ring(x, gidx, mask, nb),
                    lambda: ell_gather.ell_gather_sum_plain(x, gidx.long(), mask),
                    (x, gidx, mask), res["ring"], csr if nb == probes.RING_DEPTHS[0] else None)

    hg = cs.make_graph("pubmed_real")
    for stage, st in zip(("edge", "vertex"), plan_pallas_sparse(hg).device(dev)):
        for f in (32, 3):
            x = torch.as_tensor(np.random.default_rng(11).normal(size=(st.num_inputs, f))
                                .astype(np.float32), device=dev)
            gather_case(f"pubmed_real {stage} F={f}", x, st.gather0)
    for scale, (n, nnz, f) in probes.R2_SCALES.items():
        xn, gidx_n, mask_n = r2_table(n, nnz, f)
        x = torch.as_tensor(xn, device=dev)
        gidx = torch.as_tensor(gidx_n, device=dev)
        mask = torch.as_tensor(mask_n, device=dev)
        del xn
        if scale == "big":
            table = ell_gather.GatherTable(gidx=gidx, gidx_long=gidx.long(), mask=mask,
                                           num_inputs=n)
            gather_case("big pallas_vmem", x, table)
            del table
        ring_cases(f"{scale} pallas_dma", x, gidx, mask)
        del x, gidx, mask
        torch.cuda.empty_cache()
    xn, pair, ones = k5_table()
    ring_cases("k5 two buffers", *(torch.as_tensor(a, device=dev) for a in (xn, pair, ones)))

    cfg, hg, x, y, split, plan = cs.train_problem("pubmed_real")
    from ab_eager import eager
    from hypergef_tpu_torch.train.trainer import Trainer
    Trainer = eager(Trainer)  # noqa: N806

    trainer = Trainer(cfg, hg, x, y, plan=plan, device=dev)
    name = "pubmed_real HGNN pallas_sparse"
    res["steps"][name] = cs.time_steps({name: trainer}, split["train"], (name,), dev)[name]
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
