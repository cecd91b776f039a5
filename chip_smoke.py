#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``hypergef_tpu_torch``) on one CUDA card.

    python3 chip_smoke.py

Phases, each of which raises on failure (non-zero exit, no ``ok`` line):

1. Build the port's CUDA kernels from the sources in this checkout.
2. Hold the fused dense kernel against its plain PyTorch version at the
   main path's shapes (20news-shaped graph at F = 32 and 4, pubmed_real
   box at F = 32): rtol 1e-2, atol 1e-2·max|plain|; two runs bitwise
   equal; the launch count rises by one per call.
3. Serve five HGNN requests (2 layers, nhid 32, first_aggr sum; the
   bench's e2e configuration) on the 20news-shaped graph through the
   ``pallas`` route, with seeded random weights. Each answer must be
   finite, have rows of probability summing to 1, lie within 1e-2 of the
   same model on the kernel's plain version, and agree in argmax on ≥98%
   of the nodes with the f32 ``xla`` route.
4. Time the kernel against the plain version (both graphs, F = 32) and a
   request, with CUDA events, median of 20 runs.

The last line is ``{"ok": true, "device": {...}}``. Needs one card (an
H100: the kernels are built for sm_90a) and imports nothing of JAX.
"""

from __future__ import annotations

import dataclasses
import json
import subprocess
import sys
import time

import numpy as np
import torch

# graphs of bench.py: the e2e graph and the pubmed_real kernel box
GRAPHS = {
    "20news": dict(n=16242, e=100, avg=654.5),
    "pubmed_real": dict(n=19717, e=7963, avg=10.8),
}
NFEAT, NCLASS = 100, 4
REQUESTS = 5
# the reference's HGNN inference epoch on 20news, RTX 3090 (BASELINE.md:41)
REF_RTX3090_INFER_MS = 0.395


def card_line() -> str:
    """The card's name and power limit, as nvidia-smi reports them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def check(cond: bool, what: str) -> None:
    if not cond:
        raise RuntimeError(f"check failed: {what}")


def make_graph(name: str):
    from hypergef_tpu_torch.data.synthetic import random_hypergraph

    g = GRAPHS[name]
    return random_hypergraph(g["n"], g["e"], avg_edge_size=g["avg"], seed=0, name=name)


def kernel_operands(hg, f: int, seed: int, device):
    """(h, x, scale_e, scale_v) as the pallas route passes them, with a
    random wdiag folded into scale_e."""
    from hypergef_tpu_torch.sparse.planner import DenseIncidence

    rng = np.random.default_rng(seed)
    hgd = hg.device_data(device)
    h = DenseIncidence.from_hypergraph(hg, device).h
    x = torch.as_tensor(rng.normal(size=(hg.num_nodes, f)).astype(np.float32), device=device)
    wdiag = torch.as_tensor(
        rng.uniform(0.5, 1.5, size=(hg.num_edges, 1)).astype(np.float32), device=device)
    return h, x, (hgd.degE * wdiag).contiguous(), hgd.degV


def check_kernel(hg, f: int, seed: int, device) -> dict:
    from hypergef_tpu_torch.ops import fused_dense

    ops = kernel_operands(hg, f, seed, device)
    before = fused_dense.launches
    got = fused_dense.fused_dense_two_stage(*ops)
    again = fused_dense.fused_dense_two_stage(*ops)
    torch.cuda.synchronize()
    check(fused_dense.launches == before + 2, "one launch per kernel call")
    want = fused_dense.fused_dense_two_stage_plain(*ops)
    scale = float(want.abs().max())
    torch.testing.assert_close(got, want, rtol=1e-2, atol=1e-2 * scale)
    check(torch.equal(got, again), "two kernel runs are bitwise equal")
    return {"graph": hg.name, "f": f, "max_abs_err": float((got - want).abs().max()),
            "max_abs_plain": scale}


def time_kernel(hg, f: int, device) -> dict:
    """Kernel and plain version in turns (plain, kernel, kernel, plain)."""
    from hypergef_tpu_torch.ops import fused_dense
    from hypergef_tpu_torch.utils.timing import cuda_time_ms

    ops = kernel_operands(hg, f, seed=7, device=device)
    fns = {
        "kernel": lambda: fused_dense.fused_dense_two_stage(*ops),
        "plain": lambda: fused_dense.fused_dense_two_stage_plain(*ops),
    }
    runs = {"kernel": [], "plain": []}
    for name in ("plain", "kernel", "kernel", "plain"):
        runs[name].append(cuda_time_ms(fns[name], repeats=20, iters=10))
    return {name: float(np.median(v)) for name, v in runs.items()}


def serve(device) -> dict:
    from hypergef_tpu_torch.data.synthetic import random_features
    from hypergef_tpu_torch.ops import fused_dense
    from hypergef_tpu_torch.serve import ServingModel
    from hypergef_tpu_torch.train.trainer import TrainConfig
    from hypergef_tpu_torch.utils.timing import cuda_time_ms

    hg = make_graph("20news")
    cfg = TrainConfig(model="HGNN", nhid=32, nlayer=2, first_aggr="sum", backend="pallas")
    server = ServingModel(cfg, hg, NFEAT, NCLASS, device)
    params = {k: v.detach().cpu() for k, v in server.model.state_dict().items()}
    # the same model on the kernel's plain version (the pallas route on CPU
    # tensors), and on the f32 segment-sum route
    plain = ServingModel(cfg, hg, NFEAT, NCLASS, "cpu", params=params)
    xla = ServingModel(dataclasses.replace(cfg, backend="xla"), hg, NFEAT, NCLASS, device,
                       params=params)
    feats = [random_features(hg.num_nodes, NFEAT, NCLASS, seed=100 + i)[0]
             for i in range(REQUESTS)]
    xs = [torch.as_tensor(a, device=device) for a in feats]
    torch.cuda.synchronize()

    fused_dense.launches = 0
    answers = [server.predict(x) for x in xs]
    torch.cuda.synchronize()
    launches = fused_dense.launches
    check(launches == REQUESTS * cfg.nlayer,
          f"{REQUESTS} requests launched the kernel {REQUESTS * cfg.nlayer} times, got {launches}")

    worst = {"plain_abs": 0.0, "xla_abs": 0.0, "agree": 1.0}
    for logp, a, x in zip(answers, feats, xs):
        check(tuple(logp.shape) == (hg.num_nodes, NCLASS), "answer shape")
        check(bool(torch.isfinite(logp).all()), "finite log-probs")
        rows = logp.exp().sum(dim=1)
        check(bool(torch.allclose(rows, torch.ones_like(rows), atol=1e-4)),
              "probabilities sum to 1")
        d_plain = float((logp.cpu() - plain.predict(a)).abs().max())
        check(d_plain <= 1e-2, f"log-probs within 1e-2 of the plain version ({d_plain})")
        ref = xla.predict(x)
        agree = float((logp.argmax(1) == ref.argmax(1)).float().mean())
        check(agree >= 0.98, f"argmax agrees with the xla route on >=98% ({agree})")
        worst["plain_abs"] = max(worst["plain_abs"], d_plain)
        worst["xla_abs"] = max(worst["xla_abs"], float((logp - ref).abs().max()))
        worst["agree"] = min(worst["agree"], agree)

    request_ms = cuda_time_ms(lambda: server.predict(xs[0]), repeats=20, queue_ahead=False)
    return {"launches": launches, "worst": worst, "request_ms": request_ms}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    from hypergef_tpu_torch.ops import _build

    device = torch.device("cuda", 0)
    card = card_line()
    print(f"card: {card} | torch {torch.__version__} cuda {torch.version.cuda}", flush=True)

    # 1. build
    t0 = time.perf_counter()
    _build.load_library()
    print(f"phase 1 build: {time.perf_counter() - t0:.2f} s", flush=True)
    print(_build.build_log().strip(), flush=True)

    # 2. kernel against its plain version
    graphs = {name: make_graph(name) for name in GRAPHS}
    cases = [check_kernel(graphs["20news"], 32, 1, device),
             check_kernel(graphs["20news"], 4, 2, device),
             check_kernel(graphs["pubmed_real"], 32, 3, device)]
    for c in cases:
        print(f"phase 2 kernel vs plain: {json.dumps(c)}", flush=True)

    # 3. serve
    served = serve(device)
    print(f"phase 3 serve: {json.dumps(served)}", flush=True)

    # 4. times
    times = {name: time_kernel(hg, 32, device) for name, hg in graphs.items()}
    print("phase 4 times (ms, CUDA events, median of 20): card "
          f"{card}; fused kernel vs plain at F=32: "
          + "; ".join(f"{g} kernel {t['kernel']} plain {t['plain']}" for g, t in times.items())
          + f"; HGNN request on 20news {served['request_ms']} "
          f"(reference's RTX 3090 inference epoch {REF_RTX3090_INFER_MS}, not a claim)",
          flush=True)

    kernels = [{
        "name": "fused_dense_two_stage",
        "route": "cuda",
        "source": "hypergef_tpu_torch/csrc/fused_dense.cu",
        "replaces": "hypergef_tpu/ops/pallas_kernels.py:108",
        "launches": served["launches"],
        "max_abs_err": max(c["max_abs_err"] for c in cases),
        "ms": times["20news"]["kernel"],
        "plain_ms": times["20news"]["plain"],
    }]
    print(json.dumps({"kernels": kernels}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
