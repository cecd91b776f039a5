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
9. Build the clustered SBM-60k graph from raw input as bench.py's clustered
   leg does (generator, shuffle, ``community_reorder(method="coarsen")``)
   and its ``plan_aligned`` plan. Hold the band kernel (``aligned_band``)
   against its plain twin on both stages at F = 32, 4 and 3, on the
   uniform-form plan of the same graph and on a small single-bucket plan:
   rtol 1e-5, atol 1e-5·max|plain|; two runs bitwise equal; one launch per
   stage apply.
10. Serve five HGNN requests on SBM-60k (2 layers, nhid 32, 100 features,
   4 classes) through the kernel-form aligned plan: the checks of phase 3,
   against the same model on the plain form on the card.
11. Train 20 steps on the same problem, kernel form: finite losses, exactly
   8 band launches a step (2 layers × 2 stages × forward and backward);
   then 10 epochs without dropout, kernel form vs plain form on the card,
   losses within rtol 1e-3.
12. Time, with CUDA events, median of 20 windows: the SBM-60k training
   epoch on the aligned kernel form, the aligned plain form and
   ``pallas_sparse``; the band kernel vs its plain twin per stage at
   F = 32.

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
# bench.py's clustered leg (bench.py:153, :172-176): community_hypergraph's
# arguments, then a shuffle from default_rng(7) and the coarsening reorder
SBM60K = dict(n_nodes=60000, n_edges=30000, n_comm=240, avg=12, noise=0.02, seed=0)
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


def serve(device, hg, backend, kernel, per_request, plan=None, plain_plan=None,
          plain_device="cpu") -> dict:
    """Five requests through ``backend``, whose kernel module is ``kernel``
    (``per_request`` launches each), checked against the same model on the
    kernel's plain version (``plain_plan`` on ``plain_device``) and on the
    f32 segment-sum route."""
    from hypergef_tpu_torch.data.synthetic import random_features
    from hypergef_tpu_torch.serve import ServingModel
    from hypergef_tpu_torch.train.trainer import TrainConfig
    from hypergef_tpu_torch.utils.timing import cuda_time_ms

    cfg = TrainConfig(model="HGNN", nhid=32, nlayer=2, first_aggr="sum", backend=backend)
    server = ServingModel(cfg, hg, NFEAT, NCLASS, device, plan=plan)
    params = {k: v.detach().cpu() for k, v in server.model.state_dict().items()}
    plain = ServingModel(cfg, hg, NFEAT, NCLASS, plain_device, params=params, plan=plain_plan)
    xla = ServingModel(dataclasses.replace(cfg, backend="xla"), hg, NFEAT, NCLASS, device,
                       params=params)
    feats = [random_features(hg.num_nodes, NFEAT, NCLASS, seed=100 + i)[0]
             for i in range(REQUESTS)]
    xs = [torch.as_tensor(a, device=device) for a in feats]
    torch.cuda.synchronize()

    kernel.launches = 0
    answers = [server.predict(x) for x in xs]
    torch.cuda.synchronize()
    launches = kernel.launches
    check(launches == REQUESTS * per_request,
          f"{REQUESTS} requests launched the kernel {REQUESTS * per_request} times, got {launches}")

    worst = {"plain_abs": 0.0, "xla_abs": 0.0, "agree": 1.0}
    for logp, a, x in zip(answers, feats, xs):
        check(tuple(logp.shape) == (hg.num_nodes, NCLASS), "answer shape")
        check(bool(torch.isfinite(logp).all()), "finite log-probs")
        rows = logp.exp().sum(dim=1)
        check(bool(torch.allclose(rows, torch.ones_like(rows), atol=1e-4)),
              "probabilities sum to 1")
        d_plain = float((logp.cpu() - plain.predict(a).cpu()).abs().max())
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
    from hypergef_tpu_torch.ops import aligned_band, ell_gather, fused_dense
    from hypergef_tpu_torch.train.trainer import Trainer

    out = {}
    # (fused dense, gather, band) launches a step
    per_step = {"pallas": (4, 0, 0), "pallas_sparse": (0, 8, 0), "aligned": (0, 0, 8)}
    for name, (cfg, hg, x, y, split, plan) in problems.items():
        tr = Trainer(cfg, hg, x, y, plan=plan, device=device)
        torch.cuda.synchronize()
        fused_dense.launches = fused_dense.v2e_launches = 0
        ell_gather.launches = aligned_band.launches = 0
        res = tr.fit(split["train"], epochs=TRAIN_STEPS, warmup=0)
        launched = (fused_dense.launches, ell_gather.launches, aligned_band.launches)
        check(fused_dense.v2e_launches == 0, "a frozen wdiag needs no d scale_e")
        want = tuple(TRAIN_STEPS * k for k in per_step[cfg.backend])
        check(launched == want, f"{name}: {TRAIN_STEPS} steps launched (fused, gather, band) "
              f"{launched}, want {want}")
        check(bool(np.isfinite(res["losses"]).all()), f"{name}: finite losses")
        out[name] = {"route": cfg.backend, "fused_launches": launched[0],
                     "gather_launches": launched[1], "band_launches": launched[2],
                     "losses": res["losses"].tolist(),
                     "train_acc": tr.evaluate(split)["train_acc"]}
    return out


def train_parity(problems, device) -> dict:
    """Without dropout from the same (seeded) weights: pallas on the card
    vs the same Trainer on CPU tensors, pallas_sparse vs the tree route on
    the card, the aligned kernel form vs the aligned plain form on the card;
    losses of PARITY_EPOCHS epochs within rtol 1e-3."""
    from hypergef_tpu_torch.sparse.planner import AggregationPlan
    from hypergef_tpu_torch.train.trainer import Trainer

    out = {}
    for name, (cfg, hg, x, y, split, plan) in problems.items():
        cfg = dataclasses.replace(cfg, dropout=0.0, input_drop=0.0)
        if cfg.backend == "pallas":
            ref_cfg, ref_plan, ref_device = cfg, None, "cpu"
        elif cfg.backend == "aligned":
            plain = dataclasses.replace(plan.aligned, form="xla")
            ref_cfg, ref_plan, ref_device = cfg, AggregationPlan(aligned=plain), device
        else:
            ref_cfg, ref_plan, ref_device = dataclasses.replace(cfg, backend="tree"), None, device
        got = Trainer(cfg, hg, x, y, plan=plan, device=device).fit(
            split["train"], epochs=PARITY_EPOCHS, warmup=0)["losses"]
        want = Trainer(ref_cfg, hg, x, y, plan=ref_plan, device=ref_device).fit(
            split["train"], epochs=PARITY_EPOCHS, warmup=0)["losses"]
        rel = float(np.max(np.abs(got - want) / np.abs(want)))
        check(bool(np.allclose(got, want, rtol=1e-3, atol=0.0)),
              f"{name}: {cfg.backend} losses within rtol 1e-3 of the reference on "
              f"{ref_device} (max rel {rel})")
        ref_name = ref_cfg.backend + (" plain form" if cfg.backend == "aligned" else "")
        out[name] = {"route": cfg.backend, "ref": f"{ref_name} on {ref_device}",
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
        order = (ref_route[cfg.backend], cfg.backend, cfg.backend, ref_route[cfg.backend])
        out[name] = time_steps(trainers, split["train"], order, device)
    return out


def time_steps(trainers, train_idx, order, device) -> dict:
    """``wall_ms`` and ``device_ms`` of a step of each trainer, taken in
    ``order`` (each name twice, in turns), medians over the turns."""
    from hypergef_tpu_torch.utils.timing import cuda_time_ms

    idx = torch.as_tensor(train_idx, device=device)
    wall = {k: [] for k in trainers}
    dev = {k: [] for k in trainers}
    for name in order:
        step = functools.partial(trainers[name].step, idx)
        wall[name].append(cuda_time_ms(step, repeats=20, iters=10, queue_ahead=False))
        dev[name].append(cuda_time_ms(step, repeats=20, iters=1, queue_ahead=True))
    return {k: {"wall_ms": float(np.median(wall[k])), "device_ms": float(np.median(dev[k]))}
            for k in trainers}


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


def build_sbm60k():
    """SBM-60k from raw input (bench.py:172-176) and its aligned plan, with
    the seconds of the reorder and of the plan."""
    from hypergef_tpu_torch.data.synthetic import community_hypergraph
    from hypergef_tpu_torch.sparse.planner import plan_aligned
    from hypergef_tpu_torch.sparse.reorder import apply_vertex_order, community_reorder

    hg = community_hypergraph(**SBM60K)
    perm = np.random.default_rng(7).permutation(hg.num_nodes)
    hg, _ = apply_vertex_order(hg, perm, sort_edges=False)  # raw order
    t0 = time.perf_counter()
    hg, _ = community_reorder(hg, method="coarsen")
    reorder_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    plan = plan_aligned(hg)
    plan_s = time.perf_counter() - t0
    info = {"graph": "sbm60k", "n": hg.num_nodes, "e": hg.num_edges, "nnz": hg.nnz,
            "reorder_s": reorder_s, "plan_s": plan_s}
    for name, st in (("edge", plan.edge_stage), ("vertex", plan.vertex_stage)):
        info[name] = {
            "buckets": [list(b.win_block.shape) for b in st.buckets],  # [groups, width]
            "spills": [list(sp.spill_src.shape) for sp in st.spills],  # [groups, slots]
            "spill_fraction": st.spill_fraction, "table_bytes": st.table_bytes()}
    return hg, plan, info


def check_band(stage, f: int, seed: int, device) -> dict:
    """The band kernel against its plain twin on one device stage."""
    from hypergef_tpu_torch.ops import aligned_band

    rng = np.random.default_rng(seed)
    x = torch.as_tensor(rng.normal(size=(stage.num_inputs, f)).astype(np.float32),
                        device=device)
    before = aligned_band.launches
    got = aligned_band.aligned_band(x, stage)
    again = aligned_band.aligned_band(x, stage)
    torch.cuda.synchronize()
    check(aligned_band.launches == before + 2, "one band launch per stage apply")
    want = aligned_band.aligned_band_plain(x, stage)
    scale = float(want.abs().max())
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5 * scale)
    check(torch.equal(got, again), "two band runs are bitwise equal")
    return {"groups": stage.band.num_groups, "n": stage.num_inputs, "s": stage.num_segments,
            "f": f, "max_abs_err": float((got - want).abs().max()), "max_abs_plain": scale}


def time_band(stage, f: int, device) -> dict:
    from hypergef_tpu_torch.ops import aligned_band
    from hypergef_tpu_torch.utils.timing import cuda_time_ms

    x = torch.as_tensor(np.random.default_rng(12).normal(size=(stage.num_inputs, f))
                        .astype(np.float32), device=device)
    fns = {"kernel": lambda: aligned_band.aligned_band(x, stage),
           "plain": lambda: aligned_band.aligned_band_plain(x, stage)}
    runs = {"kernel": [], "plain": []}
    for name in ("plain", "kernel", "kernel", "plain"):
        runs[name].append(cuda_time_ms(fns[name], repeats=20, iters=10))
    return {name: float(np.median(v)) for name, v in runs.items()}


def sbm_problem(hg, plan):
    """(cfg, graph, x, y, split, plan) of HGNN on SBM-60k through the
    kernel-form aligned plan: 100 random features and 4 classes, as 20news."""
    from hypergef_tpu_torch.data.synthetic import random_features
    from hypergef_tpu_torch.sparse.planner import AggregationPlan
    from hypergef_tpu_torch.train.splits import rand_train_test_idx
    from hypergef_tpu_torch.train.trainer import TrainConfig

    x, y = random_features(hg.num_nodes, NFEAT, NCLASS, seed=1)
    cfg = TrainConfig(model="HGNN", nhid=32, nlayer=2, first_aggr="sum", backend="aligned")
    kernel = dataclasses.replace(plan, form="pallas_auto")
    return cfg, hg, x, y, rand_train_test_idx(y, seed=2), AggregationPlan(aligned=kernel)


def aligned_phases(device, card: str) -> dict:
    """Phases 9-12: the aligned route on SBM-60k."""
    # 9. SBM-60k from raw input; band kernel against its plain twin
    from hypergef_tpu_torch.data.synthetic import community_hypergraph
    from hypergef_tpu_torch.ops import aligned_band
    from hypergef_tpu_torch.sparse.planner import AggregationPlan, plan_aligned
    from hypergef_tpu_torch.sparse.reorder import community_reorder

    sbm, al_plan, sbm_info = build_sbm60k()
    print(f"phase 9 graph: {json.dumps(sbm_info)}", flush=True)
    al_kernel = dataclasses.replace(al_plan, form="pallas_auto")
    sbm_stages = dict(zip(("edge", "vertex"), al_kernel.device(device)))
    small, _ = community_reorder(community_hypergraph(2000, 1600, 25, 5, 0.02, 3))
    extra = {
        "sbm60k uniform": dataclasses.replace(plan_aligned(sbm, form="uniform"),
                                              form="pallas_auto"),
        "small 2000x1600": dataclasses.replace(plan_aligned(small), form="pallas_auto"),
    }
    bands = []
    for seed, (stage, f) in enumerate([(s, f) for s in ("edge", "vertex") for f in (32, 4, 3)]):
        bands.append({"plan": "sbm60k", "stage": stage,
                      **check_band(sbm_stages[stage], f, 20 + seed, device)})
    for name, p in extra.items():
        for stage, st in zip(("edge", "vertex"), p.device(device)):
            bands.append({"plan": name, "stage": stage, "layout": type(st).__name__,
                          **check_band(st, 32, 30 + len(bands), device)})
    for b in bands:
        print(f"phase 9 band kernel vs plain: {json.dumps(b)}", flush=True)

    # 10. serve SBM-60k through the kernel-form aligned plan
    served_al = serve(device, sbm, "aligned", aligned_band, per_request=4,
                      plan=AggregationPlan(aligned=al_kernel),
                      plain_plan=AggregationPlan(aligned=al_plan), plain_device=device)
    print(f"phase 10 serve sbm60k: {json.dumps(served_al)}", flush=True)

    # 11. train SBM-60k, kernel form
    sbm_problems = {"sbm60k": sbm_problem(sbm, al_plan)}
    trained_al = train(sbm_problems, device)
    print(f"phase 11 train sbm60k: {json.dumps(trained_al['sbm60k'])}", flush=True)
    parity_al = train_parity(sbm_problems, device)
    print(f"phase 11 no-dropout parity sbm60k: {json.dumps(parity_al['sbm60k'])}", flush=True)

    # 12. times
    from hypergef_tpu_torch.sparse.planner import plan_pallas_sparse
    from hypergef_tpu_torch.train.trainer import Trainer

    cfg, hg, x, y, split, plan = sbm_problems["sbm60k"]
    trainers = {
        "aligned kernel": Trainer(cfg, hg, x, y, plan=plan, device=device),
        "aligned plain": Trainer(cfg, hg, x, y, plan=AggregationPlan(aligned=al_plan),
                                 device=device),
        "pallas_sparse": Trainer(dataclasses.replace(cfg, backend="pallas_sparse"), hg, x, y,
                                 plan=plan_pallas_sparse(hg), device=device),
    }
    order = ("aligned plain", "aligned kernel", "pallas_sparse",
             "pallas_sparse", "aligned kernel", "aligned plain")
    sbm_epochs = time_steps(trainers, split["train"], order, device)
    band_times = {f"{stage} F=32": time_band(sbm_stages[stage], 32, device)
                  for stage in ("edge", "vertex")}
    print(f"phase 12 times (ms, CUDA events, median of 20): card {card}; SBM-60k training "
          f"epoch (wall: 10 back-to-back steps, host included; device: behind a queued "
          f"sleep): {json.dumps(sbm_epochs)}; band kernel vs plain twin: "
          f"{json.dumps(band_times)}; HGNN request on SBM-60k, kernel form "
          f"{served_al['request_ms']}", flush=True)

    return {"bands": bands, "served": served_al, "trained": trained_al["sbm60k"],
            "band_times": band_times}


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
    from hypergef_tpu_torch.ops import fused_dense

    served = serve(device, make_graph("20news"), "pallas", fused_dense, per_request=2)
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

    aligned = aligned_phases(device, card)

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
    }, {
        "name": "aligned_band",
        "route": "cuda",
        "source": "hypergef_tpu_torch/csrc/aligned_band.cu",
        "replaces": "hypergef_tpu/ops/aligned_pallas.py:126",
        # forward and backward launches of the aligned serving and training paths
        "launches": aligned["served"]["launches"] + aligned["trained"]["band_launches"],
        "max_abs_err": max(b["max_abs_err"] for b in aligned["bands"]),
        "ms": aligned["band_times"]["edge F=32"]["kernel"],
        "plain_ms": aligned["band_times"]["edge F=32"]["plain"],
        "vertex_ms": aligned["band_times"]["vertex F=32"]["kernel"],
        "vertex_plain_ms": aligned["band_times"]["vertex F=32"]["plain"],
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
