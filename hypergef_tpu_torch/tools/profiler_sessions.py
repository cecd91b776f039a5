#!/usr/bin/env python3
"""Profiler sessions late in one process, a recorded fit after each, on the card.

    python3 -m hypergef_tpu_torch.tools.profiler_sessions [--sessions N] [--age S]
    python3 -m hypergef_tpu_torch.tools.profiler_sessions --burst N [--hold S]
    PYTHONPATH=CHECKOUT python3 PATH/TO/profiler_sessions.py --raw [--sessions N] [--age S]

Opens N (default 5) profiler sessions of CPU and CUDA activity in this
process, each around one call of the fused dense kernel on a 20news-shaped
table (16242 × 100, F = 32), and after each fits a ``Trainer`` of HGNN on
a 20news-shaped graph on the ``pallas`` route, recorded and eager (3 steps
each). The second session starts S seconds (default 60) after the first,
the later ones back to back: on an H100, a session that kept CUPTI
attached from the process's first session lost its kernel from about 45 s
after that first session on. The sessions come from
``utils/profiling.py::profiler``, or with ``--raw`` from a plain
``torch.profiler.profile`` (how a tree without that helper opened them).
With ``--raw`` nothing newer than that is imported, so the tool runs
against an older checkout (the root of an unpacked ``git archive``) on
``PYTHONPATH``, run from the repo root as in the second form. One JSON line a session (its
start after the first, its CUDA events, whether it held the one fused
dense kernel, whether the recorded fit ran captured with the eager losses
bitwise, and, from the helper, the threads its stop waited for and for how
long), then the card. Exits 1 if a session lost its kernel or a recorded
fit differed. ``--burst N`` opens N sessions back to back instead, each
around one call and no fit, and prints how many held the kernel and the
kernel's stamp after its launch's (min, median, max ms); ``--hold S``
sets the helper's ``HOLD_S`` first (0: no hold).
"""

from __future__ import annotations

import argparse
import json
import sys
import time

FIT_STEPS = 3


def _operands(device):
    """A 20news-shaped int8 table with a few counts of 3, x and the scalings."""
    import numpy as np
    import torch

    n, e, f, density = 16242, 100, 32, 0.04
    rng = np.random.default_rng(3)
    h = (rng.random((n, e)) < density).astype(np.int8)
    h[rng.random((n, e)) < density / 8] = 3
    x = rng.normal(size=(n, f)).astype(np.float32)
    se = rng.uniform(0.1, 1.0, size=(e, 1)).astype(np.float32)
    sv = rng.uniform(0.1, 1.0, size=(n, 1)).astype(np.float32)
    return [torch.as_tensor(a, device=device) for a in (h, x, se, sv)]


def _session(raw: bool):
    import torch

    if raw:
        return torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                                  torch.profiler.ProfilerActivity.CUDA])
    from hypergef_tpu_torch.utils.profiling import profiler

    return profiler()


def run(sessions: int = 5, age_s: float = 60.0, raw: bool = False, device="cuda") -> list:
    """The sessions' rows (see the module's docstring) on ``device``."""
    import numpy as np
    import torch

    from hypergef_tpu_torch.data.synthetic import random_features, random_hypergraph
    from hypergef_tpu_torch.ops import fused_dense
    from hypergef_tpu_torch.train.splits import rand_train_test_idx
    from hypergef_tpu_torch.train.trainer import TrainConfig, Trainer

    dev = torch.device(device)
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    ops = _operands(dev)
    fused_dense.fused_dense_two_stage(*ops)
    sync()
    hg = random_hypergraph(16242, 100, avg_edge_size=654.5, seed=0, name="20news")
    x, y = random_features(16242, 100, 4, seed=1)
    idx = rand_train_test_idx(y, seed=2)["train"]
    cfg = TrainConfig(model="HGNN", nhid=32, nlayer=2, backend="pallas")
    rows, first = [], None
    for i in range(sessions):
        if i == 1:
            time.sleep(max(0.0, first + age_s - time.monotonic()))
        start = time.monotonic()
        first = start if first is None else first
        with _session(raw) as prof:
            fused_dense.fused_dense_two_stage(*ops)
            sync()
        names = [e.name for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
        eager, captured = (Trainer(cfg, hg, x, y, device=dev, compiled=c and dev.type == "cuda")
                           for c in (False, True))
        want, got = (t.fit(idx, epochs=FIT_STEPS, warmup=0) for t in (eager, captured))
        rows.append({"session": i + 1, "start_s": round(start - first, 3),
                     "device_events": len(names),
                     "kernel": len(names) == 1 and "fused_dense_kernel" in names[0],
                     "captured": got["step"] == "captured",
                     "bitwise": bool(np.array_equal(got["losses"], want["losses"])),
                     **({} if raw else {f"detach_{k}": v for k, v in prof.detach.items()})})
    return rows


def burst(sessions: int, raw: bool = False) -> dict:
    """``sessions`` back-to-back sessions, each around one fused dense call:
    how many held the one kernel, and the kernel's stamp after its launch's
    (ms; the runtime's launch call on the host clock), over those that did."""
    import statistics

    import torch

    from hypergef_tpu_torch.ops import fused_dense

    ops = _operands(torch.device("cuda", 0))
    fused_dense.fused_dense_two_stage(*ops)
    torch.cuda.synchronize()
    kept, gaps = 0, []
    for _ in range(sessions):
        with _session(raw) as prof:
            fused_dense.fused_dense_two_stage(*ops)
            torch.cuda.synchronize()
        events = prof.events()
        kernels = [e for e in events if e.device_type == torch.autograd.DeviceType.CUDA]
        launches = [e for e in events if e.device_type == torch.autograd.DeviceType.CPU
                    and "aunch" in e.name]
        if len(kernels) == 1 and "fused_dense_kernel" in kernels[0].name:
            kept += 1
            if launches:
                launch = max(launches, key=lambda e: e.time_range.start)
                gaps.append((kernels[0].time_range.start - launch.time_range.start) / 1e3)
    return {"sessions": sessions, "kept": kept,
            "stamp_after_launch_ms": {"min": min(gaps), "median": statistics.median(gaps),
                                      "max": max(gaps)} if gaps else None}


def main() -> int:
    import torch

    ap = argparse.ArgumentParser()
    ap.add_argument("--raw", action="store_true")
    ap.add_argument("--sessions", type=int, default=5)
    ap.add_argument("--age", type=float, default=60.0)
    ap.add_argument("--burst", type=int, default=0)
    ap.add_argument("--hold", type=float, default=None)
    args = ap.parse_args()
    kind = "raw" if args.raw else "helper"
    if args.hold is not None:
        from hypergef_tpu_torch.utils import profiling

        profiling.HOLD_S = args.hold
        kind = f"helper, hold {args.hold} s"
    if args.burst:
        out = burst(args.burst, args.raw)
        print(json.dumps({"sessions": kind, **out}), flush=True)
        print(json.dumps({"card": torch.cuda.get_device_name(0)}), flush=True)
        return 0 if out["kept"] == args.burst else 1
    rows = run(args.sessions, args.age, args.raw)
    for row in rows:
        print(json.dumps({"sessions": kind, **row}), flush=True)
    print(json.dumps({"card": torch.cuda.get_device_name(0)}), flush=True)
    return 0 if all(r["kernel"] and r["captured"] and r["bitwise"] for r in rows) else 1


if __name__ == "__main__":
    sys.exit(main())
