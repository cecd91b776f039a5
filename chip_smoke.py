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
5. Hold the gather kernel (``ell_gather_sum``) against its plain loop on
   the level-0 tables of both stages of the pubmed_real
   ``plan_pallas_sparse`` plan, at F = 32 and 3: bitwise equal, two runs
   bitwise equal, one launch per call.
6. Hold the fused dense op's backward (x, scale_e and scale_v all
   requiring grad) against the plain ``_fd_bwd`` formula at the shapes of
   phase 2: rtol 1e-2, atol 1e-2·max|plain|; count its launches.
7. Train 20 steps, default dropout: 20news on ``pallas`` (the bench's e2e
   configuration) and pubmed_real (500 features, 3 classes) on
   ``pallas_sparse``. Losses finite; exactly 4 fused-dense and 8 gather
   launches per step. Then 10 epochs without dropout from the same
   weights: ``pallas`` on the card within rtol 1e-3 of the same Trainer on
   CPU tensors, ``pallas_sparse`` within rtol 1e-3 of the ``tree`` route
   on the card.
8. Time, with CUDA events, median of 20 windows: the training epoch of
   20news on ``pallas`` vs ``dense`` and of pubmed_real on
   ``pallas_sparse`` vs ``tree``; the gather kernel vs its plain loop; the
   fused dense backward vs its plain formula.

The last line is ``{"ok": true, "device": {...}}``. Needs one card (an
H100: the kernels are built for sm_90a) and imports nothing of JAX.
"""

from __future__ import annotations

import dataclasses
import functools
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
# Planetoid PubMed's published widths, for training on the pubmed_real box
PUBMED_NFEAT, PUBMED_NCLASS = 500, 3
REQUESTS = 5
TRAIN_STEPS = 20
PARITY_EPOCHS = 10
# the reference's HGNN inference and training epochs on 20news, RTX 3090
# (BASELINE.md:41)
REF_RTX3090_INFER_MS = 0.395
REF_RTX3090_EPOCH_MS = 1.471


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


def check_gather(table, f: int, seed: int, device) -> dict:
    """The gather kernel against its sequential plain loop: bitwise."""
    from hypergef_tpu_torch.ops import ell_gather

    rng = np.random.default_rng(seed)
    x = torch.as_tensor(rng.normal(size=(table.num_inputs, f)).astype(np.float32),
                        device=device)
    before = ell_gather.launches
    got = ell_gather.ell_gather_sum(x, table)
    again = ell_gather.ell_gather_sum(x, table)
    torch.cuda.synchronize()
    check(ell_gather.launches == before + 2, "one gather launch per call")
    want = ell_gather.ell_gather_sum_plain(x, table.gidx_long, table.mask)
    err = float((got - want).abs().max())
    check(torch.equal(got, want), f"gather kernel bitwise equal to the plain loop ({err})")
    check(torch.equal(got, again), "two gather runs are bitwise equal")
    return {"chunks": int(table.gidx.shape[0]), "ngs": int(table.gidx.shape[1]),
            "n": table.num_inputs, "f": f, "max_abs_err": err}


def fd_backward_operands(hg, f: int, seed: int, device):
    """The op's operands, all three requiring grad, and a cotangent."""
    h, x, se, sv = kernel_operands(hg, f, seed, device)
    g = torch.as_tensor(np.random.default_rng(seed + 1).normal(size=tuple(x.shape))
                        .astype(np.float32), device=device)
    return h, [t.clone().requires_grad_(True) for t in (x, se, sv)], g


def check_fd_backward(hg, f: int, seed: int, device) -> dict:
    from hypergef_tpu_torch.ops import fused_dense

    h, ts, g = fd_backward_operands(hg, f, seed, device)
    out = fused_dense.fused_dense_two_stage(h, *ts)
    before = (fused_dense.launches, fused_dense.v2e_launches)
    grads = torch.autograd.grad(out, ts, g)
    torch.cuda.synchronize()
    launched = (fused_dense.launches - before[0], fused_dense.v2e_launches - before[1])
    check(launched == (2, 2), f"a full backward launches the op twice and phase 1 twice: {launched}")
    errs = {}
    with torch.no_grad():
        wants = fused_dense.fused_dense_backward_plain(h, *(t.detach() for t in ts), g)
    for name, got, want in zip(("dx", "d_scale_e", "d_scale_v"), grads, wants):
        scale = float(want.abs().max())
        torch.testing.assert_close(got, want, rtol=1e-2, atol=1e-2 * scale, msg=name)
        errs[name] = float((got - want).abs().max())
    return {"graph": hg.name, "f": f, "launches": launched[0], "v2e_launches": launched[1],
            "max_abs_err": errs}


def train_problem(name: str):
    """(cfg, graph, x, y, split, plan) of a training path: the bench's e2e
    configuration on 20news (bench.py:56-70), PubMed's widths on the
    pubmed_real box (bench.py:145-148)."""
    from hypergef_tpu_torch.data.synthetic import random_features
    from hypergef_tpu_torch.sparse.planner import plan_pallas_sparse
    from hypergef_tpu_torch.train.splits import rand_train_test_idx
    from hypergef_tpu_torch.train.trainer import TrainConfig

    hg = make_graph(name)
    if name == "20news":
        x, y = random_features(hg.num_nodes, NFEAT, NCLASS, seed=1)
        cfg = TrainConfig(model="HGNN", nhid=32, nlayer=2, first_aggr="sum", lr=0.01, wd=5e-4,
                          backend="pallas")
        plan = None
    else:
        x, y = random_features(hg.num_nodes, PUBMED_NFEAT, PUBMED_NCLASS, seed=1)
        cfg = TrainConfig(model="HGNN", nhid=32, nlayer=2, backend="pallas_sparse")
        plan = plan_pallas_sparse(hg)
    return cfg, hg, x, y, rand_train_test_idx(y, seed=2), plan


def train(problems, device) -> dict:
    """Each path with its counts set to 0 just before and read just after."""
    from hypergef_tpu_torch.ops import ell_gather, fused_dense
    from hypergef_tpu_torch.train.trainer import Trainer

    out = {}
    per_step = {"pallas": (4, 0), "pallas_sparse": (0, 8)}  # (fused dense, gather)
    for name, (cfg, hg, x, y, split, plan) in problems.items():
        tr = Trainer(cfg, hg, x, y, plan=plan, device=device)
        torch.cuda.synchronize()
        fused_dense.launches = fused_dense.v2e_launches = ell_gather.launches = 0
        res = tr.fit(split["train"], epochs=TRAIN_STEPS, warmup=0)
        launched = (fused_dense.launches, ell_gather.launches)
        check(fused_dense.v2e_launches == 0, "a frozen wdiag needs no d scale_e")
        want = tuple(TRAIN_STEPS * k for k in per_step[cfg.backend])
        check(launched == want, f"{name}: {TRAIN_STEPS} steps launched (fused, gather) "
              f"{launched}, want {want}")
        check(bool(np.isfinite(res["losses"]).all()), f"{name}: finite losses")
        out[name] = {"route": cfg.backend, "fused_launches": launched[0],
                     "gather_launches": launched[1], "losses": res["losses"].tolist(),
                     "train_acc": tr.evaluate(split)["train_acc"]}
    return out


def train_parity(problems, device) -> dict:
    """Without dropout from the same (seeded) weights: pallas on the card
    vs the same Trainer on CPU tensors, pallas_sparse vs the tree route on
    the card; losses of PARITY_EPOCHS epochs within rtol 1e-3."""
    from hypergef_tpu_torch.train.trainer import Trainer

    out = {}
    for name, (cfg, hg, x, y, split, plan) in problems.items():
        cfg = dataclasses.replace(cfg, dropout=0.0, input_drop=0.0)
        if cfg.backend == "pallas":
            ref_cfg, ref_plan, ref_device = cfg, None, "cpu"
        else:
            ref_cfg, ref_plan, ref_device = dataclasses.replace(cfg, backend="tree"), None, device
        got = Trainer(cfg, hg, x, y, plan=plan, device=device).fit(
            split["train"], epochs=PARITY_EPOCHS, warmup=0)["losses"]
        want = Trainer(ref_cfg, hg, x, y, plan=ref_plan, device=ref_device).fit(
            split["train"], epochs=PARITY_EPOCHS, warmup=0)["losses"]
        rel = float(np.max(np.abs(got - want) / np.abs(want)))
        check(bool(np.allclose(got, want, rtol=1e-3, atol=0.0)),
              f"{name}: {cfg.backend} losses within rtol 1e-3 of {ref_cfg.backend} on "
              f"{ref_device} (max rel {rel})")
        out[name] = {"route": cfg.backend, "ref": f"{ref_cfg.backend} on {ref_device}",
                     "max_rel": rel, "losses": got.tolist(), "ref_losses": want.tolist()}
    return out


def time_epochs(problems, device) -> dict:
    """A training epoch per route, in turns (ref, route, route, ref): CUDA
    events around 10 back-to-back steps, median of 20 windows. ``wall_ms``
    holds the card's waits for the host (the window as fit() reads it);
    ``device_ms`` starts each one-step window behind a queued sleep, so it
    holds the card's work alone."""
    from hypergef_tpu_torch.train.trainer import Trainer
    from hypergef_tpu_torch.utils.timing import cuda_time_ms

    ref_route = {"pallas": "dense", "pallas_sparse": "tree"}
    out = {}
    for name, (cfg, hg, x, y, split, plan) in problems.items():
        trainers = {
            cfg.backend: Trainer(cfg, hg, x, y, plan=plan, device=device),
            ref_route[cfg.backend]: Trainer(
                dataclasses.replace(cfg, backend=ref_route[cfg.backend]), hg, x, y,
                device=device),
        }
        idx = torch.as_tensor(split["train"], device=device)
        wall = {k: [] for k in trainers}
        dev = {k: [] for k in trainers}
        order = (ref_route[cfg.backend], cfg.backend, cfg.backend, ref_route[cfg.backend])
        for route in order:
            step = functools.partial(trainers[route].step, idx)
            wall[route].append(cuda_time_ms(step, repeats=20, iters=10, queue_ahead=False))
            dev[route].append(cuda_time_ms(step, repeats=20, iters=1, queue_ahead=True))
        out[name] = {route: {"wall_ms": float(np.median(wall[route])),
                             "device_ms": float(np.median(dev[route]))} for route in trainers}
    return out


def time_gather(table, f: int, device) -> dict:
    from hypergef_tpu_torch.ops import ell_gather
    from hypergef_tpu_torch.utils.timing import cuda_time_ms

    x = torch.as_tensor(np.random.default_rng(11).normal(size=(table.num_inputs, f))
                        .astype(np.float32), device=device)
    fns = {"kernel": lambda: ell_gather.ell_gather_sum(x, table),
           "plain": lambda: ell_gather.ell_gather_sum_plain(x, table.gidx_long, table.mask)}
    runs = {"kernel": [], "plain": []}
    for name in ("plain", "kernel", "kernel", "plain"):
        runs[name].append(cuda_time_ms(fns[name], repeats=20, iters=10))
    return {name: float(np.median(v)) for name, v in runs.items()}


def time_fd_backward(hg, f: int, device) -> dict:
    """The op's full backward (dx, d scale_e, d scale_v) vs the plain formula."""
    from hypergef_tpu_torch.ops import fused_dense
    from hypergef_tpu_torch.utils.timing import cuda_time_ms

    h, ts, g = fd_backward_operands(hg, f, seed=9, device=device)
    out = fused_dense.fused_dense_two_stage(h, *ts)
    plain_args = [t.detach() for t in ts]

    def plain():
        with torch.no_grad():
            fused_dense.fused_dense_backward_plain(h, *plain_args, g)

    fns = {"kernel": lambda: torch.autograd.grad(out, ts, g, retain_graph=True),
           "plain": plain}
    runs = {"kernel": [], "plain": []}
    for name in ("plain", "kernel", "kernel", "plain"):
        runs[name].append(cuda_time_ms(fns[name], repeats=20, iters=10))
    return {name: float(np.median(v)) for name, v in runs.items()}


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

    # 5. gather kernel against its plain loop, level 0 of both pubmed stages
    from hypergef_tpu_torch.sparse.planner import plan_pallas_sparse

    ps_plan = plan_pallas_sparse(graphs["pubmed_real"])
    tables = dict(zip(("edge", "vertex"), (st.gather0 for st in ps_plan.device(device))))
    gathers = [check_gather(tables[stage], f, seed, device)
               for seed, (stage, f) in enumerate(
                   [("edge", 32), ("edge", 3), ("vertex", 32), ("vertex", 3)])]
    for stage, g in zip(("edge", "edge", "vertex", "vertex"), gathers):
        print(f"phase 5 gather vs plain ({stage} stage): {json.dumps(g)}", flush=True)

    # 6. fused dense backward against the plain _fd_bwd formula
    bwd = [check_fd_backward(graphs["20news"], 32, 4, device),
           check_fd_backward(graphs["20news"], 4, 5, device),
           check_fd_backward(graphs["pubmed_real"], 32, 6, device)]
    for c in bwd:
        print(f"phase 6 fused backward vs plain: {json.dumps(c)}", flush=True)

    # 7. train
    problems = {"20news": train_problem("20news"), "pubmed_real": train_problem("pubmed_real")}
    trained = train(problems, device)
    for name, t in trained.items():
        print(f"phase 7 train {name}: {json.dumps(t)}", flush=True)
    parity = train_parity(problems, device)
    for name, t in parity.items():
        print(f"phase 7 no-dropout parity {name}: {json.dumps(t)}", flush=True)

    # 8. times
    epochs = time_epochs(problems, device)
    gather_times = {f"{stage} F={f}": time_gather(tables[stage], f, device)
                    for stage, f in (("edge", 32), ("vertex", 32), ("vertex", 3))}
    bwd_times = {name: time_fd_backward(graphs[name], 32, device) for name in GRAPHS}
    print(f"phase 8 times (ms, CUDA events, median of 20): card {card}; training epoch "
          f"(wall: 10 back-to-back steps, host included; device: behind a queued sleep): "
          f"{json.dumps(epochs)} (reference's RTX 3090 epoch on 20news "
          f"{REF_RTX3090_EPOCH_MS}, not a claim); gather kernel vs plain loop, pubmed_real "
          f"level 0: {json.dumps(gather_times)}; fused dense backward vs plain formula, "
          f"F=32: {json.dumps(bwd_times)}", flush=True)

    fd_bwd_err = max(max(c["max_abs_err"].values()) for c in bwd)
    kernels = [{
        "name": "fused_dense_two_stage",
        "route": "cuda",
        "source": "hypergef_tpu_torch/csrc/fused_dense.cu",
        "replaces": "hypergef_tpu/ops/pallas_kernels.py:108",
        # forward and backward launches of the serving and the pallas training paths
        "launches": served["launches"] + trained["20news"]["fused_launches"],
        "max_abs_err": max(max(c["max_abs_err"] for c in cases), fd_bwd_err),
        "ms": times["20news"]["kernel"],
        "plain_ms": times["20news"]["plain"],
        "bwd_ms": bwd_times["20news"]["kernel"],
        "bwd_plain_ms": bwd_times["20news"]["plain"],
    }, {
        "name": "ell_gather_sum",
        "route": "cuda",
        "source": "hypergef_tpu_torch/csrc/ell_gather.cu",
        "replaces": "hypergef_tpu/ops/pallas_sparse.py:111",
        "also_replaces": "hypergef_tpu/ops/pallas_sparse.py:127",
        "launches": trained["pubmed_real"]["gather_launches"],
        "max_abs_err": max(g["max_abs_err"] for g in gathers),
        "ms": gather_times["edge F=32"]["kernel"],
        "plain_ms": gather_times["edge F=32"]["plain"],
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
