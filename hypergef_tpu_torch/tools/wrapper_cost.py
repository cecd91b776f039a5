#!/usr/bin/env python3
"""Host time of a kernel wrapper's call with and without its count check, on the card.

    python3 -m hypergef_tpu_torch.tools.wrapper_cost [--calls N] [--rounds R]

Each hand-written kernel's wrapper is ``@profiling.kernel``: with no count
open, a call reads one global and calls the wrapped function. This times
two wrappers as they are and their wrapped functions (``__wrapped__``)
alone, each launching its kernel on a small input: the fused dense
two-stage call through its ``torch.library`` op (``fused_dense._two_stage``,
a 120 × 80 table, F = 8) and the direct-call probe
``probes.scaled_copy`` (1024 floats). A round times N calls (default 200)
of one form on the host clock, after a synchronize, and gives the host
microseconds a call; rounds run in turns (wrapped, bare, bare, wrapped),
R pairs of them (default 20). One JSON line: each form's median and range
over its rounds, and the median of the paired differences; then the card.
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys
import time


def _round_us(fn, calls: int) -> float:
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    t = time.perf_counter() - t0
    torch.cuda.synchronize()
    return t / calls * 1e6


def main() -> int:
    import numpy as np
    import torch

    from hypergef_tpu_torch import probes
    from hypergef_tpu_torch.ops import fused_dense

    ap = argparse.ArgumentParser()
    ap.add_argument("--calls", type=int, default=200)
    ap.add_argument("--rounds", type=int, default=20)
    args = ap.parse_args()
    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(0)
    h = torch.as_tensor((rng.random((120, 80)) < 0.06).astype(np.int8), device=dev)
    x = torch.as_tensor(rng.normal(size=(120, 8)).astype(np.float32), device=dev)
    se = torch.as_tensor(rng.uniform(0.1, 1, size=(80, 1)).astype(np.float32), device=dev)
    sv = torch.as_tensor(rng.uniform(0.1, 1, size=(120, 1)).astype(np.float32), device=dev)
    v = torch.randn(1024, device=dev)
    wrappers = {"fused_dense._two_stage": (fused_dense._two_stage, (h, x, se, sv, False)),
                "probes.scaled_copy": (probes.scaled_copy, (v, 2.0))}
    out = {}
    for name, (fn, call_args) in wrappers.items():
        forms = {"wrapped": lambda: fn(*call_args),
                 "bare": lambda: fn.__wrapped__(*call_args)}
        for form in forms.values():
            _round_us(form, args.calls)
        us = {"wrapped": [], "bare": []}
        for _ in range(args.rounds):
            for form in ("wrapped", "bare", "bare", "wrapped"):
                us[form].append(_round_us(forms[form], args.calls))
        diffs = [(us["wrapped"][2 * i] + us["wrapped"][2 * i + 1]
                  - us["bare"][2 * i] - us["bare"][2 * i + 1]) / 2 for i in range(args.rounds)]
        out[name] = {**{f"{form}_us": {"median": statistics.median(v), "min": min(v),
                                       "max": max(v)} for form, v in us.items()},
                     "paired_diff_us": {"median": statistics.median(diffs), "min": min(diffs),
                                        "max": max(diffs)},
                     "calls": args.calls, "rounds": args.rounds}
    print(json.dumps(out), flush=True)
    print(json.dumps({"card": torch.cuda.get_device_name(0)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
