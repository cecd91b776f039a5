#!/usr/bin/env python3
"""Time the probes' row gather and scaled copy of checkouts on the card, in turns.

    python3 hypergef_tpu_torch/tools/probes_ab.py CHECKOUT [CHECKOUT ...]

Each CHECKOUT is the root of a tree holding a ``hypergef_tpu_torch``
package (this repo, or an older commit unpacked with ``git archive``). For
each one a worker process imports that tree's package, builds its kernels
and measures, with CUDA events behind a queued sleep (median of 20 windows
of 10 calls), on the probes' own draws:

* ``probes.row_gather``, direct and through the ring at n_buf 4, 8 and 16,
  at ``pallas_probe3``'s flat take (85,024 rows of a [19,717, 32] x) and
  ``probe_r2_gather``'s flat gather at each of its scales (tiny: 32,768
  rows of [1,024, 32]; pubmed: 86,016 of [19,968, 64]; big: 9,998,336 of
  [2,000,000, 32]); at the cases of the small probes: ``probe_r2b_bisect``'s
  k1 (direct) and k2, k3, k4, k6 (ring 4) on [1,024, 128], and
  ``pallas_probe``'s and ``pallas_probe2``'s 4,096 rows of [4,096, 128]
  (K1, K2, B, C direct; K4 ring 8; D ring 16);
* ``probes.scaled_copy`` (x · 2) at k0's [1,024, 128] and at
  [1,048,576, 128] (512 MiB each way);
* an empty launch (``torch.cuda._sleep(0)``), the floor of any launch.

Every output is checked bitwise against its plain version on the card. The
first checkout's worker also times the library call (``index_select``,
``torch.mul``) and gives the bounds over 3.35 TB/s: for a gather, the
distinct rows named, each read once, and every named row read once (what a
gather of an x larger than the L2 can reach), each with the index and the
output; for the copy, x read and out written once. Workers run in turns
(A, B, B, A for two checkouts) so that a drift of the card shows. Each
worker prints a digest of every output; the last lines say whether each
output is bitwise equal across the checkouts (exit 1 if not) and name the
card. One JSON line a worker.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import subprocess
import sys

HBM_BYTES_PER_S = 3.35e12
DEPTHS = (0, 4, 8, 16)
# probes.R2_SCALES: (N, nnz, F)
R2_SCALES = {"tiny": (1024, 32_768, 32), "pubmed": (19_968, 86_016, 64),
             "big": (2_000_000, 9_998_336, 32)}


def gather_cases():
    """(name, x, idx, depths) on the probes' draws (NumPy), smallest first."""
    import numpy as np

    rng = np.random.default_rng(0)  # pallas_probe3.py:37-38
    x3 = rng.normal(size=(19_717, 32)).astype(np.float32)
    yield "take F=32 nnz=85k", x3, rng.integers(0, 19_717, size=85_024).astype(np.int32), DEPTHS
    rng = np.random.default_rng(0)  # probe_r2b_bisect.py:38-41
    xb = rng.normal(size=(1024, 128)).astype(np.float32)
    ib = rng.integers(0, 1024, size=(64, 8)).astype(np.int32)
    r = int(ib[0, 0])
    yield "k1 one-row broadcast", xb, np.full(8, ib[0, 0], np.int32), (0,)
    yield "k2 static 8 rows", xb, np.arange(8, dtype=np.int32), (4,)
    yield "k3 8 rows at a dynamic offset", xb, np.arange(r, r + 8, dtype=np.int32), (4,)
    yield "k4 single-row copy", xb, np.full(8, ib[0, 1], np.int32), (4,)
    yield "k6 one copy a chunk", xb, np.ascontiguousarray(ib[:, 0]), (4,)
    rng = np.random.default_rng(0)  # pallas_probe.py:35-37, pallas_probe2.py:36-37
    xp = rng.normal(size=(4096, 128)).astype(np.float32)
    yield ("K1 K2 B C direct, K4 ring 8, D ring 16", xp,
           rng.integers(0, 4096, size=4096).astype(np.int32), (0, 8, 16))
    for scale, (n, nnz, f) in R2_SCALES.items():  # probe_r2_gather.py:218-231
        rng = np.random.default_rng(0)
        gidx = rng.integers(0, n, size=(nnz // 8, 8)).astype(np.int32)
        rng.random((nnz // 8, 8))
        yield f"{scale} xla_gather", rng.normal(size=(n, f)).astype(np.float32), \
            gidx.reshape(-1), DEPTHS


def gather_bounds(x, idx) -> dict:
    import torch

    row = x.shape[1] * 4
    rest = idx.numel() * 4 + idx.numel() * row
    distinct = int(torch.unique(idx).numel())
    return {"bound_ms": (distinct * row + rest) / HBM_BYTES_PER_S * 1e3,
            "bound_named_ms": (idx.numel() * row + rest) / HBM_BYTES_PER_S * 1e3,
            "distinct_rows": distinct}


def worker(yardsticks: bool) -> dict:
    import numpy as np
    import torch

    from hypergef_tpu_torch import probes
    from hypergef_tpu_torch.ops import _build
    from hypergef_tpu_torch.utils.timing import cuda_time_ms

    dev = torch.device("cuda", 0)
    _build.load_library()
    res = {"tree": os.getcwd(), "gather": {}, "copy": {}, "digests": {}}

    def timed(fn):
        return cuda_time_ms(fn, repeats=20, iters=10)

    def measure(key, call, plain, out, library=None, **extra):
        got = call()
        if not torch.equal(got, plain()):
            raise RuntimeError(f"{key}: the kernel differs from its plain version")
        res["digests"][key] = hashlib.sha256(got.cpu().numpy().tobytes()).hexdigest()[:16]
        r = {"ms": timed(call)}
        if yardsticks:
            if library is not None:
                r["library_ms"] = timed(library)
            r.update(extra)
        out[key] = r

    for name, xn, idx_n, depths in gather_cases():
        x = torch.as_tensor(xn, device=dev)
        idx = torch.as_tensor(idx_n, device=dev)
        idx_long = idx.long()
        del xn
        b = gather_bounds(x, idx) if yardsticks else {}
        for nb in depths:
            label = "direct" if nb == 0 else f"ring n_buf={nb}"
            measure(f"{name} {label}", lambda nb=nb: probes.row_gather(x, idx, nb),
                    lambda: probes.row_gather_plain(x, idx), res["gather"],
                    (lambda: x.index_select(0, idx_long)) if nb == depths[0] else None, **b)
        del x, idx, idx_long
        torch.cuda.empty_cache()
    rng = np.random.default_rng(0)
    for name, shape in (("k0 [1024, 128]", (1024, 128)), ("[1048576, 128]", (1_048_576, 128))):
        x = torch.as_tensor(rng.normal(size=shape).astype(np.float32), device=dev)
        measure(f"scaled_copy {name}", lambda: probes.scaled_copy(x, 2.0), lambda: x * 2.0,
                res["copy"], lambda: torch.mul(x, 2.0),
                bound_ms=2 * x.numel() * 4 / HBM_BYTES_PER_S * 1e3)
        del x
    res["empty_launch_ms"] = timed(lambda: torch.cuda._sleep(0))
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
