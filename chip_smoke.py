#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``hypergef_tpu_torch``) on one CUDA card.

    python3 chip_smoke.py

Phases, each of which raises on failure (non-zero exit, no ``ok`` line):

1. Build the port's CUDA kernels from the sources in this checkout.
2. Hold the fused dense kernel against its plain PyTorch version at the
   main path's shapes (20news-shaped graph at F = 32, 4 and 100,
   pubmed_real box at F = 32, cora at F = 32 and 7, and a 20news table
   whose counts reach 2): rtol 1e-2, atol 1e-2·max|plain|; two runs bitwise
   equal; the launch count rises by one per call; one call is one CUDA
   kernel under ``torch.profiler``.
3. Serve five HGNN requests (2 layers, nhid 32, first_aggr sum; the
   bench's e2e configuration) on the 20news-shaped graph through the
   ``pallas`` route, with seeded random weights. Each answer must be
   finite, have rows of probability summing to 1, lie within 1e-2 of the
   same model on the kernel's plain version, and agree in argmax on ≥98%
   of the nodes with the f32 ``xla`` route.
4. Time the kernel against the plain version, the two library products
   (``torch.mm`` with an f32 result on a bf16 copy of H, the yardstick
   only) and its bound (20news, pubmed_real and cora, F = 32), and a
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
   uniform-form plan of the same graph and on a small single-bucket plan, and
   at F = 100 (two passes of the kernel's 64 features) on the SBM-60k plan:
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
   ``pallas_sparse``; the band kernel vs its plain twin vs one
   ``torch.sparse.mm`` per stage at F = 32.
13. On phase 9's plans: hold the masked argmax kernel against its plain
   twin on both stages of the SBM-60k plan at F = 32, 4 and 3, with
   tie-heavy inputs (integers in [-2, 2]) at F = 32, on the edge stage at
   F = 48 and 100 (passes of 32 features), and on the uniform and the small
   plans: values and ids bitwise equal, two runs bitwise equal, one launch
   per stage apply. Print each SBM-60k stage's live layout (the lists the
   two kernels walk): its bytes and host build seconds beside the flat
   tables' bytes. Hold the masked arg-sum kernel on the uniform plan's
   vertex stage at F = 32 and 4, with the arg table of the argmax kernel on
   its edge stage: rtol 1e-6, atol 1e-6·max|plain|; two runs bitwise equal.
14. Serve five HGNN max requests on SBM-60k through the kernel-form aligned
   plan: the checks of phase 3, against the plain form on the card;
   exactly 2 argmax and 2 band launches a request.
15. Train 20 steps of HGNN max on SBM-60k, kernel form (its stages carry
   their live layouts): finite losses,
   exactly 2 argmax, 4 band, 2 record-routed sum and 0 arg-sum launches a
   step; 10 epochs without dropout, kernel form vs plain form on the card,
   losses within rtol 1e-3. One forward and backward of
   ``aligned_max_matvec`` on the uniform plan at F = 32: one argmax and one
   arg-sum launch, dx within rtol 1e-6, atol 1e-6·max of
   ``v2e_max_aligned``'s CSR-routed dx (the masked segment-sum kernel).
16. Time, with CUDA events, median of 20 windows: the argmax kernel vs its
   twin (edge stage, F = 32 and 4), the arg-sum kernel vs its twin and one
   ``scatter_add_`` (uniform vertex stage, F = 32 and 4), each beside two
   bounds (over the live layout the kernels read, and over the flat tables
   the earlier design read), the record-routed sum (the max
   backward: the masked segment-sum kernel over SBM-60k's vertex-major CSR,
   int32 ids, F = 32) vs its plain twin and its bound, and each arg-sum and
   record-routed sum vs one ``torch.zeros(N, F).scatter_add_(0, ids, g)``
   where no id is -1 (the library yardstick, ids cast to int64 before the
   window), the SBM-60k max
   training epoch on the aligned kernel form, on ``AggregationPlan(tree,
   aligned kernel form)`` (tree argmax V→E, band kernel E→V) and on the
   aligned plain form, and a max request.
17. Build stream100k from raw input (``random_hypergraph(100000, 20000,
   avg_edge_size=60, seed=0)``, N·E/nnz about 1670: the band where the JAX
   package's routing ladder picks ``bitstream``, ``planner.py:735-754``),
   its bit packs and its tree plan, with their host times. Hold the
   bit-packed product kernel (``bitmm``) against its plain twin on both
   packs at F = 32, 4 and 3, on both packs of the pubmed_real box at
   F = 32, on ``bit_matvec``'s backward, and on packs of the kernel
   layout's edge cases at F = 32, 4 and 3 (rows with no bit, a pack with
   none, a word with all 32 bits set, rows with every word nonzero, 35 K
   tiles a row, rows around the runs' cuts): rtol 1e-5, atol
   1e-5·max|plain| (exact 0/1 × bf16 products, f32 sums in another
   order); two runs bitwise equal; one launch per call. Each stream100k
   layout (the nonzero words the kernel reads, ``BitLayout``) holds at most
   1/16 of its pack's bytes, with its host build seconds and bytes printed;
   and zero words go unread: the pubmed_real Hᵀ pack four times as wide
   (zero words appended to each row, x padded with rows no bit names)
   gives the same output bitwise and times within 1.2× of the pack.
18. Serve five requests each of HGNN (sum) and UniGCNII on stream100k
   through ``bitstream`` (the server builds its own packs): the checks of
   phase 3, against the same model on the f32 ``tree`` route on the card
   at the bf16 bar, 3e-2 (the kernel rounds x to bf16 before each of the
   four products; phase 17 holds it to its twin); exactly 4 bitmm
   launches a request.
19. Train 20 steps on stream100k through ``bitstream`` with no ``plan=``,
   default dropout: HGNN sum, HGNN max, UniGIN and UniGCNII. Losses finite;
   exactly 8, 4, 8 and 8 bitmm launches a step, and 2 record-routed sums a
   HGNN max step. Then 10 epochs without dropout from the same weights,
   each within rtol 1e-2 of the ``tree`` route on the card (bitstream
   rounds x to bf16, tree does not); and HGNN
   sum on the pubmed_real box, ``bitstream`` against ``dense`` on the card:
   the first loss (the forward: both round x to bf16 and sum exact
   products) within rtol 1e-5, all within rtol 1e-3 (the backward of
   ``dense`` rounds its cotangent after the product, the kernel's before,
   as in JAX: tests/test_bitstream.py:86-89).
20. Time, with CUDA events, median of 20 windows: the kernel vs its twin vs
   one ``torch.sparse.mm`` of the same CSR on bf16-rounded x, per pack at
   F = 32 and 4, on stream100k and the pubmed_real box, with two bounds
   (the layout's bytes, what the kernel reads; the whole pack's, what a
   kernel that streams the words must read); the record-routed sum over
   stream100k's vertex-major CSR (int64 ids, as the tree gives them) vs its
   twin and its bound; the stream100k training epoch on ``bitstream``,
   ``tree`` and ``pallas_sparse`` (HGNN sum), of HGNN max and of UniGCNII
   on ``bitstream``; a request.
21. The routing ladder on the card: ``plan_aggregation`` on 20news and
   pubmed_real (``dense``), cora 2708×2708 (``precomp``), coauthor_dblp
   41302×22363 (``cumsum``), SBM-60k after the reorder (``aligned``, in the
   kernel form) and stream100k (``bitstream``); each pick must equal the JAX
   package's (``LADDER_PICKS``, held against JAX on the CPU by
   tests/test_torch_port_ladder.py); the host seconds of each plan.
22. Hold the segment-sum kernel (``gather_segment_sum``, the ``cumsum``
   route's) against its plain version on both directions of coauthor_dblp at
   F = 32, 4, 3 and 1425, on identity gathers at the one-hot probes' shapes
   (TS 8, R 64; TS 256, R 4096), on a CSR with empty segments and on a
   long one: rtol 1e-6, atol 1e-6·max|plain|; two runs bitwise equal; one
   launch per call; and ``incidence_gather_sum``'s backward (one launch
   each way). Hold its masked form, the record-routed sum
   (``record_routed_dx``), against its plain twin on the vertex-major CSRs
   of coauthor_dblp (int64 ids at F = 32, int32 at F = 6 and 3), SBM-60k
   (int32, F = 32) and stream100k (int64, F = 32), each id a member of
   its edge: the same bar, repeats bitwise equal, one launch a call.
23. Serve and train with ``TrainConfig()``'s defaults, no ``backend=`` and no
   ``plan=``: coauthor_dblp at AllSet's widths (1425 features, 6 classes),
   five HGNN requests (exactly 4 segment-sum launches each, within 1e-3 of
   the f32 ``tree`` route) and 20 steps each of HGNN sum, HGNN max and
   UniGCNII (exactly 8, 4 and 8 launches a step, and 2 record-routed sums a
   HGNN max step), then 10 no-dropout epochs within rtol 1e-3 of ``tree``;
   cora (1433 features, 7 classes) on
   ``precomp``: requests within 1e-2 of the same route on CPU tensors and
   within 3e-2·max|log-probs| of the f32 ``xla`` route, losses within rtol
   1e-2 of ``tree``; 20news trains on ``dense``.
24. Time, with CUDA events, median of 20 windows: the segment-sum kernel vs
   its plain version vs one ``torch.sparse.mm`` of the same CSR per direction
   at F = 32; the record-routed sum on coauthor_dblp (int64 ids, F = 32) vs
   its twin, ``scatter_add_`` and its bound; the coauthor_dblp epoch on
   ``cumsum``, ``tree`` and
   ``pallas_sparse``, the cora epoch on ``precomp``, ``dense`` and
   ``pallas``; a request on each; beside the reference's RTX 3090 fused
   kernel times (not a claim).
25. The ports of the TPU probes of ``scripts/`` (``hypergef_tpu_torch.probes``)
   at their scripts' shapes, probe_r2_gather's 2M-row scale included: each
   case against its script's oracle (bitwise for gathers and copies, rtol
   1e-5 for sums) and timed against a library call; the row gather, chunk sum
   and scaled copy kernels against their plain versions.

Phases 8 and 12 also time one ``torch.sparse.mm`` of the gather table's
and of each aligned stage's CSR matrix (the library yardstick; the port
never calls it). The ``kernels`` line gives, for each kernel, its launches
on the main paths, its largest error against its plain version, its time,
the plain version's and the library call's (null where no single PyTorch
call computes the same function), and its bound: the larger of its bytes
over the card's memory rate and its operations over the rate of the unit
that does them (the f32 rate; the bf16 tensor-core rate for the band
kernel's dense tile products).

Every ``pl.pallas_call`` of the repo appears in one kernel's ``replaces``
or ``also_replaces`` (``KERNEL_SITES``). The last line is ``{"ok": true,
"device": {...}}``. Needs one card (an H100: the kernels are built for
sm_90a) and imports nothing of JAX.

    python3 chip_smoke.py --profile

times the band kernel beside its ablations (``BAND_ABLATIONS``) on
SBM-60k, then profiles training steps (``profile_band``,
``profile_steps``); it checks no result and prints no ``ok`` line.
"""

from __future__ import annotations

import ctypes
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
# a dense-ish unstructured graph in the bitstream band of the JAX ladder
# (N·E in (0.8G, 6.4G] and N·E < 2000·nnz, planner.py:735-754)
STREAM100K = dict(n=100_000, e=20_000, avg=60.0)
# the routing ladder's phase: the random graphs it plans (random_hypergraph(n,
# e, avg, seed=0); coauthor_dblp and cora at the dims of
# experiments/fig7_9_realistic.py:45,49), and JAX's plan_aggregation pick for
# each graph the script builds (hypergef_tpu/sparse/planner.py:638-782). The
# card has no JAX, so the picks are constants;
# tests/test_torch_port_ladder.py holds the random graphs' against JAX.
LADDER_GRAPHS = {**GRAPHS, "cora": dict(n=2708, e=2708, avg=4.0),
                 "coauthor_dblp": dict(n=41302, e=22363, avg=4.5)}
LADDER_PICKS = {"20news": "dense", "pubmed_real": "dense", "cora": "precomp",
                "coauthor_dblp": "cumsum", "sbm60k": "aligned", "stream100k": "bitstream"}
# AllSet's published widths: co-authorship DBLP (1425 features, 6 classes)
# and Cora (1433 features, 7 classes)
DBLP_NFEAT, DBLP_NCLASS = 1425, 6
CORA_NFEAT, CORA_NCLASS = 1433, 7
# the reference's fused kernel at F = 32 on an RTX 3090
# (experiments/fig7_9_realistic.py:61,67; BASELINE.md §1)
REF_RTX3090_FUSED_MS = {"coauthor_dblp": 0.030438, "cora": 0.004795}
# every pl.pallas_call of the repo, by the kernel of the port that replaces it
KERNEL_SITES = {
    "fused_dense_two_stage": ["hypergef_tpu/ops/pallas_kernels.py:108"],
    "ell_gather_sum": ["hypergef_tpu/ops/pallas_sparse.py:111",
                       "hypergef_tpu/ops/pallas_sparse.py:127",
                       "scripts/probe_r2_gather.py:109", "scripts/probe_r2b_bisect.py:242",
                       "scripts/probe_r2b_bisect.py:271", "scripts/probe_r2b_bisect.py:309",
                       "scripts/probe_r2b_bisect.py:341", "scripts/probe_r2b_bisect.py:374"],
    "aligned_band": ["hypergef_tpu/ops/aligned_pallas.py:126"],
    "aligned_masked_argmax": ["hypergef_tpu/ops/aligned_max.py:107"],
    "aligned_masked_argsum": ["hypergef_tpu/ops/aligned_max.py:285"],
    "bitstream_bitmm": ["hypergef_tpu/ops/bitstream.py:195"],
    "gather_segment_sum": ["scripts/pallas_probe.py:98", "scripts/pallas_probe2.py:184",
                           "scripts/pallas_probe3.py:108"],
    "row_gather": ["scripts/pallas_probe.py:47", "scripts/pallas_probe.py:69",
                   "scripts/pallas_probe.py:147", "scripts/pallas_probe2.py:59",
                   "scripts/pallas_probe2.py:81", "scripts/pallas_probe2.py:126",
                   "scripts/probe_r2b_bisect.py:64", "scripts/probe_r2b_bisect.py:82",
                   "scripts/probe_r2b_bisect.py:102", "scripts/probe_r2b_bisect.py:124",
                   "scripts/probe_r2b_bisect.py:149", "scripts/probe_r2b_bisect.py:214"],
    "chunk_masked_sum": ["scripts/pallas_probe.py:176", "scripts/pallas_probe2.py:151",
                         "scripts/pallas_probe3.py:85", "scripts/probe_r2_gather.py:168",
                         "scripts/probe_r2b_bisect.py:184"],
    "scaled_copy": ["scripts/probe_r2b_bisect.py:49"],
}
# the record-routed sum replaces no pl.pallas_call: JAX computes the max
# backward with XLA ops (gathers, a compare, a segment sum)
RECORD_SUM_SITE = "hypergef_tpu/ops/maxops.py:106"
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


# the least time the card could take for a function: the larger of its
# bytes (each input read once, each output written once) over the H100 SXM's
# memory rate and its operations over the rate of the unit that does them:
# the f32 rate outside the tensor cores, where every port kernel but the
# band kernel does its arithmetic, or the dense bf16 tensor-core rate, where
# the band kernel does its tile products (NVIDIA's data sheet, 700 W)
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
BF16_TC_OPS_PER_S = 989e12


def bound(nbytes: int, ops: int, ops_per_s: float = F32_OPS_PER_S) -> dict:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / ops_per_s * 1e3
    return {"bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bytes": int(nbytes), "ops": int(ops)}


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def rows_read_bytes(x, idx) -> int:
    """The bytes of the rows of ``x`` that ``idx`` names, each read once (a
    row no index names need not move)."""
    return int(torch.unique(idx).numel()) * x[0].numel() * x.element_size()


def stage_table_bytes(stage) -> int:
    """The kernel tables a stage apply reads: bands, spills, windows,
    sources and the directory."""
    t = stage.band
    return nbytes(t.band, t.win, t.spill, t.src, t.groups)


def max_bounds(stage, moved: int, ops: int) -> dict:
    """The max kernels' bound over the live layout they read (with the
    spill sources its chunks name), and beside it the bound over the flat
    band and spill tables they read before; ``moved``: the operands' and
    outputs' bytes."""
    live = stage.band.live
    out = bound(live.nbytes() + nbytes(stage.band.src) + moved, ops)
    out["tables_bound_ms"] = bound(stage_table_bytes(stage) + moved, ops)["bound_ms"]
    return out


def layout_info(stage) -> dict:
    """The live layout's bytes and host build seconds beside the flat
    tables' bytes."""
    live = stage.band.live
    return {"layout_bytes": live.nbytes(), "layout_build_s": live.build_s,
            "chunks": int(live.chunks.shape[0]), "table_bytes": stage_table_bytes(stage)}


def stage_live(stage) -> int:
    """Non-zero entries of a stage's band and spill tables."""
    t = stage.band
    return int((t.band != 0).sum()) + int((t.spill != 0).sum())


def stage_dense(stage) -> int:
    """Entries of a stage's band tiles, zeros included: what the band
    kernel's tensor-core products multiply."""
    return stage.band.tiles.numel()


def make_graph(name: str):
    from hypergef_tpu_torch.data.synthetic import random_hypergraph

    g = LADDER_GRAPHS[name]
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


def duplicate_incidences(hg, share: float, seed: int):
    """``hg`` with ``share`` of its incidences listed twice: a table whose
    counts reach 2."""
    from hypergef_tpu_torch.sparse.hypergraph import Hypergraph

    v = hg.ht_indices.astype(np.int64)
    ed = np.repeat(np.arange(hg.num_edges), np.diff(hg.ht_indptr))
    twice = np.random.default_rng(seed).random(v.size) < share
    return Hypergraph.from_coo(np.concatenate([v, v[twice]]), np.concatenate([ed, ed[twice]]),
                               num_nodes=hg.num_nodes, num_edges=hg.num_edges, dedup=False,
                               name=f"{hg.name} counts 2")


def cuda_kernels_per_call(fn) -> int:
    """CUDA kernels that one call of ``fn`` runs, under ``torch.profiler``."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sum(1 for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA)


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
            "max_abs_plain": scale, "max_count": int(ops[0].max())}


def time_kernel(hg, f: int, device) -> dict:
    """Kernel, plain version and library yardstick in turns, and the bound:
    the int8 table, x, the scales and the output moved once; a
    multiply-add a feature for each non-zero entry in each stage. Where the
    table is larger than the 50 MB L2, each stage must read it from HBM:
    ``bound_table_twice_ms`` counts it twice. The yardstick is the ``dense``
    route's form, two ``torch.mm`` with an f32 result on a bf16 copy of H
    made before the window, and the two scalings; the port never calls it."""
    from hypergef_tpu_torch.ops import fused_dense

    ops = kernel_operands(hg, f, seed=7, device=device)
    h, x, se, sv = ops
    hb = h.to(torch.bfloat16)

    def library():
        xe = torch.mm(hb.t(), x.to(torch.bfloat16), out_dtype=torch.float32) * se
        return torch.mm(hb, xe.to(torch.bfloat16), out_dtype=torch.float32) * sv

    want = fused_dense.fused_dense_two_stage_plain(*ops)
    torch.testing.assert_close(library(), want, rtol=1e-2, atol=1e-2 * float(want.abs().max()))
    fns = {
        "kernel": lambda: fused_dense.fused_dense_two_stage(*ops),
        "plain": lambda: fused_dense.fused_dense_two_stage_plain(*ops),
        "library": library,
    }
    out = time_turns(fns, ("plain", "kernel", "library", "library", "kernel", "plain"))
    ops_count = 4 * int((h != 0).sum()) * f
    out.update(bound(nbytes(*ops) + nbytes(x), ops_count))
    out["bound_table_twice_ms"] = bound(nbytes(*ops) + nbytes(x) + nbytes(h),
                                        ops_count)["bound_ms"]
    return out


def serve(device, hg, backend, counters, plan=None, plain_plan=None, plain_device="cpu",
          first_aggr="sum", model="HGNN", ref_backend=None, ref_atol=1e-2, nfeat=NFEAT,
          nclass=NCLASS, xla_atol=None) -> dict:
    """Five requests through ``backend`` (None: ``TrainConfig``'s default,
    no ``backend=``). ``counters`` maps a kernel's name to (module, counter
    attribute, launches a request); every count is set to 0 just before the
    requests and read just after. Each answer is checked against the same
    model on the kernels' plain versions (``plain_plan`` on
    ``plain_device``), or on ``ref_backend`` if given, within ``ref_atol``,
    and on the f32 segment-reduce route: argmax agreement, and with
    ``xla_atol`` the log-probs within ``xla_atol`` of it."""
    from hypergef_tpu_torch.data.synthetic import random_features
    from hypergef_tpu_torch.serve import ServingModel
    from hypergef_tpu_torch.train.trainer import TrainConfig
    from hypergef_tpu_torch.utils.timing import cuda_time_ms

    cfg = TrainConfig(model=model, nhid=32, nlayer=2, first_aggr=first_aggr)
    if backend is not None:
        cfg = dataclasses.replace(cfg, backend=backend)
    server = ServingModel(cfg, hg, nfeat, nclass, device, plan=plan)
    params = {k: v.detach().cpu() for k, v in server.model.state_dict().items()}
    ref_cfg = dataclasses.replace(cfg, backend=ref_backend or cfg.backend)
    plain = ServingModel(ref_cfg, hg, nfeat, nclass, plain_device, params=params, plan=plain_plan)
    xla = ServingModel(dataclasses.replace(cfg, backend="xla"), hg, nfeat, nclass, device,
                       params=params)
    feats = [random_features(hg.num_nodes, nfeat, nclass, seed=100 + i)[0]
             for i in range(REQUESTS)]
    xs = [torch.as_tensor(a, device=device) for a in feats]
    torch.cuda.synchronize()

    for module, attr, _ in counters.values():
        setattr(module, attr, 0)
    answers = [server.predict(x) for x in xs]
    torch.cuda.synchronize()
    launches = {name: getattr(module, attr) for name, (module, attr, _) in counters.items()}
    for name, (_, _, per_request) in counters.items():
        check(launches[name] == REQUESTS * per_request,
              f"{REQUESTS} requests launched {name} {REQUESTS * per_request} times, "
              f"got {launches[name]}")

    worst = {"plain_abs": 0.0, "xla_abs": 0.0, "xla_scale": 0.0, "agree": 1.0}
    for logp, a, x in zip(answers, feats, xs):
        check(tuple(logp.shape) == (hg.num_nodes, nclass), "answer shape")
        check(bool(torch.isfinite(logp).all()), "finite log-probs")
        rows = logp.exp().sum(dim=1)
        check(bool(torch.allclose(rows, torch.ones_like(rows), atol=1e-4)),
              "probabilities sum to 1")
        d_plain = float((logp.cpu() - plain.predict(a).cpu()).abs().max())
        check(d_plain <= ref_atol, f"log-probs within {ref_atol} of the reference ({d_plain})")
        ref = xla.predict(x)
        agree = float((logp.argmax(1) == ref.argmax(1)).float().mean())
        check(agree >= 0.98, f"argmax agrees with the xla route on >=98% ({agree})")
        if xla_atol is not None:
            d_xla = float((logp - ref).abs().max())
            check(d_xla <= xla_atol, f"log-probs within {xla_atol} of the xla route ({d_xla})")
        worst["plain_abs"] = max(worst["plain_abs"], d_plain)
        worst["xla_abs"] = max(worst["xla_abs"], float((logp - ref).abs().max()))
        worst["xla_scale"] = max(worst["xla_scale"], float(ref.abs().max()))
        worst["agree"] = min(worst["agree"], agree)

    request_ms = cuda_time_ms(lambda: server.predict(xs[0]), repeats=20, queue_ahead=False)
    return {"route": fused_route(cfg.backend, server.plan, hg), "launches": launches,
            "worst": worst, "request_ms": request_ms}


def fused_route(backend, plan, hg) -> str:
    """The route a call with ``backend`` and ``plan`` takes on ``hg``."""
    from hypergef_tpu_torch.ops import fused

    return fused.resolve_backend(backend, plan, hg.nnz)


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


def kernel_counters():
    """Every kernel's launch counter: name -> (module, attribute)."""
    from hypergef_tpu_torch import probes
    from hypergef_tpu_torch.ops import (
        aligned_band, aligned_max, bitstream, ell_gather, fused_dense, segment_sum,
    )

    return {"fused": (fused_dense, "launches"), "gather": (ell_gather, "launches"),
            "band": (aligned_band, "launches"), "argmax": (aligned_max, "argmax_launches"),
            "argsum": (aligned_max, "argsum_launches"), "bitmm": (bitstream, "launches"),
            "segsum": (segment_sum, "launches"),
            "recsum": (segment_sum, "record_launches"),
            "row_gather": (probes, "row_gather_launches"),
            "chunk_sum": (probes, "chunk_sum_launches"),
            "scaled_copy": (probes, "scaled_copy_launches")}


def train(problems, device) -> dict:
    """Each path with its counts set to 0 just before and read just after."""
    from hypergef_tpu_torch.ops import fused_dense
    from hypergef_tpu_torch.train.trainer import Trainer

    out = {}
    # launches a step (2 layers), by (model, route, first aggregation); every
    # other count is 0. A layer's aggregation is two products forward and
    # their adjoints backward; max takes V→E from the tree or the argmax
    # kernel and its backward from the CSR: one record-routed sum a layer.
    per_step = {("HGNN", "pallas", "sum"): {"fused": 4},
                ("HGNN", "pallas_sparse", "sum"): {"gather": 8},
                ("HGNN", "aligned", "sum"): {"band": 8},
                ("HGNN", "aligned", "max"): {"argmax": 2, "band": 4, "recsum": 2},
                ("HGNN", "bitstream", "sum"): {"bitmm": 8},
                ("HGNN", "bitstream", "max"): {"bitmm": 4, "recsum": 2},
                ("UniGIN", "bitstream", "sum"): {"bitmm": 8},
                ("UniGCNII", "bitstream", "sum"): {"bitmm": 8},
                # cumsum's max takes V→E from the tree and its backward from
                # the record-routed sum
                ("HGNN", "cumsum", "sum"): {"segsum": 8},
                ("HGNN", "cumsum", "max"): {"segsum": 4, "recsum": 2},
                ("UniGCNII", "cumsum", "sum"): {"segsum": 8},
                ("HGNN", "precomp", "sum"): {}, ("HGNN", "dense", "sum"): {}}
    counters = kernel_counters()
    for name, (cfg, hg, x, y, split, plan) in problems.items():
        tr = Trainer(cfg, hg, x, y, plan=plan, device=device)
        torch.cuda.synchronize()
        fused_dense.v2e_launches = 0
        for module, attr in counters.values():
            setattr(module, attr, 0)
        res = tr.fit(split["train"], epochs=TRAIN_STEPS, warmup=0)
        launched = {k: getattr(module, attr) for k, (module, attr) in counters.items()}
        check(fused_dense.v2e_launches == 0, "a frozen wdiag needs no d scale_e")
        route = fused_route(cfg.backend, tr.plan, hg)
        want = {k: TRAIN_STEPS * per_step[cfg.model, route, cfg.first_aggr].get(k, 0)
                for k in counters}
        check(launched == want, f"{name}: {TRAIN_STEPS} steps launched {launched}, want {want}")
        check(bool(np.isfinite(res["losses"]).all()), f"{name}: finite losses")
        out[name] = {"model": cfg.model, "backend": cfg.backend, "route": route,
                     "first_aggr": cfg.first_aggr,
                     "launches": launched,
                     "losses": res["losses"].tolist(),
                     "train_acc": tr.evaluate(split)["train_acc"]}
    return out


def train_parity(problems, device) -> dict:
    """Without dropout from the same (seeded) weights: pallas on the card
    vs the same Trainer on CPU tensors, pallas_sparse vs the tree route on
    the card, the aligned kernel form vs the aligned plain form on the card;
    losses of PARITY_EPOCHS epochs within rtol 1e-3."""
    from hypergef_tpu_torch.sparse.planner import AggregationPlan

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
        ref_name = ref_cfg.backend + (" plain form" if cfg.backend == "aligned" else "")
        out[name] = loss_parity(name, (cfg, plan, device), (ref_cfg, ref_plan, ref_device),
                                (hg, x, y, split), 1e-3, ref_name)
    return out


def loss_parity(name, run, ref, problem, rtol, ref_name, first_rtol=None) -> dict:
    """Losses of PARITY_EPOCHS no-dropout epochs of ``run`` and ``ref``, each
    (cfg, plan, device), from the same seeded weights: within ``rtol``, and
    the first (the forward before any update) within ``first_rtol`` if
    given."""
    from hypergef_tpu_torch.train.trainer import Trainer

    hg, x, y, split = problem
    got, want = (Trainer(cfg, hg, x, y, plan=plan, device=dev).fit(
        split["train"], epochs=PARITY_EPOCHS, warmup=0)["losses"] for cfg, plan, dev in (run, ref))
    rels = np.abs(got - want) / np.abs(want)
    rel = float(np.max(rels))
    check(bool(np.allclose(got, want, rtol=rtol, atol=0.0)),
          f"{name}: {run[0].backend} losses within rtol {rtol} of {ref_name} on {ref[2]} "
          f"(max rel {rel})")
    if first_rtol is not None:
        check(float(rels[0]) <= first_rtol,
              f"{name}: first loss within rtol {first_rtol} of {ref_name} ({float(rels[0])})")
    return {"model": run[0].model, "route": run[0].backend, "ref": f"{ref_name} on {ref[2]}",
            "rtol": rtol, "max_rel": rel, "first_rel": float(rels[0]), "losses": got.tolist(),
            "ref_losses": want.tolist()}


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


def gather_csr(table):
    """The level-0 table as a CSR matrix [C, N] of its mask (live slots
    only), for the library yardstick ``torch.sparse.mm``."""
    c = torch.arange(table.gidx.shape[0], device=table.mask.device)[:, None].expand_as(
        table.gidx_long)
    live = table.mask != 0
    coo = torch.sparse_coo_tensor(torch.stack([c[live], table.gidx_long[live]]),
                                  table.mask[live], (table.gidx.shape[0], table.num_inputs),
                                  check_invariants=True)
    return coo.coalesce().to_sparse_csr()


def time_gather(table, f: int, device) -> dict:
    """Kernel, plain loop and one ``torch.sparse.mm`` of the table's CSR (the
    library yardstick; the port never calls it), in turns."""
    from hypergef_tpu_torch.ops import ell_gather

    x = torch.as_tensor(np.random.default_rng(11).normal(size=(table.num_inputs, f))
                        .astype(np.float32), device=device)
    csr = gather_csr(table)
    fns = {"kernel": lambda: ell_gather.ell_gather_sum(x, table),
           "plain": lambda: ell_gather.ell_gather_sum_plain(x, table.gidx_long, table.mask),
           "library": lambda: torch.sparse.mm(csr, x)}
    out = time_turns(fns, ("plain", "kernel", "library", "library", "kernel", "plain"))
    live = int((table.mask != 0).sum())
    out.update(bound(rows_read_bytes(x, table.gidx) + nbytes(table.gidx, table.mask)
                     + table.gidx.shape[0] * f * 4, 2 * live * f))
    return out


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


def incidence_csr(hg, stage: str, device):
    """The count matrix a stage applies, as CSR: Hᵀ [E, N] for the edge
    stage, H [N, E] for the vertex stage (for ``torch.sparse.mm``)."""
    indptr, indices, shape = ((hg.ht_indptr, hg.ht_indices, (hg.num_edges, hg.num_nodes))
                              if stage == "edge" else
                              (hg.h_indptr, hg.h_indices, (hg.num_nodes, hg.num_edges)))
    return torch.sparse_csr_tensor(
        torch.as_tensor(indptr, device=device), torch.as_tensor(indices, device=device).long(),
        torch.ones(len(indices), device=device), shape, check_invariants=True)


def time_band(stage, f: int, device, csr) -> dict:
    """Kernel, plain twin and one ``torch.sparse.mm`` of the stage's CSR
    count matrix against bf16(x) (the library yardstick), in turns."""
    from hypergef_tpu_torch.ops import aligned_band
    from hypergef_tpu_torch.ops.fused_dense import bf16_round

    x = torch.as_tensor(np.random.default_rng(12).normal(size=(stage.num_inputs, f))
                        .astype(np.float32), device=device)
    xb = bf16_round(x)
    fns = {"kernel": lambda: aligned_band.aligned_band(x, stage),
           "plain": lambda: aligned_band.aligned_band_plain(x, stage),
           "library": lambda: torch.sparse.mm(csr, xb)}
    out = time_turns(fns, ("plain", "kernel", "library", "library", "kernel", "plain"))
    # the kernel multiplies whole tiles on the tensor cores; beside it, the
    # time of the same function's operations on the f32 pipes, a multiply-add
    # a feature for each non-zero count only
    out.update(bound(stage_table_bytes(stage) + nbytes(x) + stage.num_segments * f * 4,
                     2 * stage_dense(stage) * f, BF16_TC_OPS_PER_S))
    out["live_f32_ops_ms"] = 2 * stage_live(stage) * f / F32_OPS_PER_S * 1e3
    return out


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
    for seed, stage in enumerate(("edge", "vertex")):  # F past one 64-feature pass
        bands.append({"plan": "sbm60k", "stage": stage,
                      **check_band(sbm_stages[stage], 100, 60 + seed, device)})
    for name, p in extra.items():
        for stage, st in zip(("edge", "vertex"), p.device(device)):
            bands.append({"plan": name, "stage": stage, "layout": type(st).__name__,
                          **check_band(st, 32, 30 + len(bands), device)})
    for b in bands:
        print(f"phase 9 band kernel vs plain: {json.dumps(b)}", flush=True)

    # 10. serve SBM-60k through the kernel-form aligned plan
    served_al = serve(device, sbm, "aligned", {"band": (aligned_band, "launches", 4)},
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
    band_times = {f"{stage} F=32": time_band(sbm_stages[stage], 32, device,
                                             incidence_csr(sbm, stage, device))
                  for stage in ("edge", "vertex")}
    print(f"phase 12 times (ms, CUDA events, median of 20): card {card}; SBM-60k training "
          f"epoch (wall: 10 back-to-back steps, host included; device: behind a queued "
          f"sleep): {json.dumps(sbm_epochs)}; band kernel vs plain twin: "
          f"{json.dumps(band_times)}; HGNN request on SBM-60k, kernel form "
          f"{served_al['request_ms']}", flush=True)

    return {"bands": bands, "served": served_al, "trained": trained_al["sbm60k"],
            "band_times": band_times, "sbm": sbm, "plan": al_plan, "extra": extra}


def check_argmax(stage, f: int, seed: int, device, ties: bool = False) -> dict:
    """The masked argmax kernel against its plain twin on one device stage:
    values and ids bitwise equal, two runs bitwise equal, one launch."""
    from hypergef_tpu_torch.ops import aligned_max

    rng = np.random.default_rng(seed)
    a = (rng.integers(-2, 3, size=(stage.num_inputs, f)) if ties
         else rng.normal(size=(stage.num_inputs, f)))
    x = torch.as_tensor(a.astype(np.float32), device=device)
    before = aligned_max.argmax_launches
    val, arg = aligned_max.aligned_masked_argmax(x, stage)
    val2, arg2 = aligned_max.aligned_masked_argmax(x, stage)
    torch.cuda.synchronize()
    check(aligned_max.argmax_launches == before + 2, "one argmax launch per stage apply")
    want_val, want_arg = aligned_max.aligned_max_plain(x, stage)
    err = float((val - want_val).abs().max())
    wrong = int((arg != want_arg).sum())
    check(torch.equal(val, want_val) and torch.equal(arg, want_arg),
          f"argmax kernel bitwise equal to its twin (values off by {err}, {wrong} ids differ)")
    check(torch.equal(val, val2) and torch.equal(arg, arg2), "two argmax runs are bitwise equal")
    return {"groups": stage.band.num_groups, "n": stage.num_inputs, "s": stage.num_segments,
            "f": f, "ties": ties, "max_abs_err": err, "ids_differ": wrong,
            "empty_share": float((arg < 0).float().mean())}


def argsum_operands(e_stage, v_stage, f: int, seed: int, device):
    """g [E, F] and the arg table of the argmax kernel on ``e_stage``."""
    from hypergef_tpu_torch.ops import aligned_max

    rng = np.random.default_rng(seed)
    x = torch.as_tensor(rng.normal(size=(e_stage.num_inputs, f)).astype(np.float32),
                        device=device)
    _, arg = aligned_max.aligned_masked_argmax(x, e_stage)
    g = torch.as_tensor(rng.normal(size=(v_stage.num_inputs, f)).astype(np.float32),
                        device=device)
    return g, arg


def check_argsum(e_stage, v_stage, f: int, seed: int, device) -> dict:
    """The masked arg-sum kernel on the transpose stage against its twin:
    rtol 1e-6, atol 1e-6·max|plain| (sums of a few f32 terms in another
    order); two runs bitwise equal."""
    from hypergef_tpu_torch.ops import aligned_max

    g, arg = argsum_operands(e_stage, v_stage, f, seed, device)
    before = aligned_max.argsum_launches
    got = aligned_max.aligned_masked_argsum(g, arg, v_stage)
    again = aligned_max.aligned_masked_argsum(g, arg, v_stage)
    torch.cuda.synchronize()
    check(aligned_max.argsum_launches == before + 2, "one arg-sum launch per stage apply")
    want = aligned_max.aligned_argsum_plain(g, arg, v_stage)
    scale = float(want.abs().max())
    torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6 * scale)
    check(torch.equal(got, again), "two arg-sum runs are bitwise equal")
    return {"groups": v_stage.band.num_groups, "n": v_stage.num_inputs,
            "s": v_stage.num_segments, "f": f, "max_abs_err": float((got - want).abs().max()),
            "max_abs_plain": scale}


def time_turns(fns: dict, order, iters: int = 10) -> dict:
    """Device time of each function (CUDA events behind a queued sleep,
    median of 20 windows of ``iters`` calls), taken in ``order``; the
    median over each name's turns."""
    from hypergef_tpu_torch.utils.timing import cuda_time_ms

    runs = {name: [] for name in fns}
    for name in order:
        runs[name].append(cuda_time_ms(fns[name], repeats=20, iters=iters))
    return {name: float(np.median(v)) for name, v in runs.items()}


def max_phases(device, card: str, aligned: dict) -> dict:
    """Phases 13-16: max first aggregation on SBM-60k, on phase 9's graph
    and plans."""
    from hypergef_tpu_torch.ops import aligned_band, aligned_max, segment_sum
    from hypergef_tpu_torch.sparse.planner import AggregationPlan, plan_tree
    from hypergef_tpu_torch.train.trainer import Trainer

    sbm, al_plan, extra = aligned["sbm"], aligned["plan"], aligned["extra"]
    al_kernel = dataclasses.replace(al_plan, form="pallas_auto")
    stages = dict(zip(("edge", "vertex"), al_kernel.device(device)))
    uni_e, uni_v = extra["sbm60k uniform"].device(device)

    # 13. the kernels against their twins
    argmaxes = []
    for seed, (stage, f) in enumerate([(s, f) for s in ("edge", "vertex") for f in (32, 4, 3)]):
        argmaxes.append({"plan": "sbm60k", "stage": stage,
                         **check_argmax(stages[stage], f, 40 + seed, device)})
    for stage in ("edge", "vertex"):
        argmaxes.append({"plan": "sbm60k", "stage": stage,
                         **check_argmax(stages[stage], 32, 50, device, ties=True)})
    for name, p in extra.items():
        for stage, st in zip(("edge", "vertex"), p.device(device)):
            argmaxes.append({"plan": name, "stage": stage, "layout": type(st).__name__,
                             **check_argmax(st, 32, 60 + len(argmaxes), device)})
    for seed, f in enumerate((48, 100)):  # F past one pass of 32 features
        argmaxes.append({"plan": "sbm60k", "stage": "edge",
                         **check_argmax(stages["edge"], f, 80 + seed, device)})
    for a in argmaxes:
        print(f"phase 13 argmax kernel vs plain: {json.dumps(a)}", flush=True)
    layouts = {f"sbm60k {name}": layout_info(st) for name, st in stages.items()}
    layouts.update({"sbm60k uniform edge": layout_info(uni_e),
                    "sbm60k uniform vertex": layout_info(uni_v)})
    print(f"phase 13 live layouts (bytes, host build seconds): {json.dumps(layouts)}",
          flush=True)
    argsums = [{"plan": "sbm60k uniform", "stage": "vertex",
                **check_argsum(uni_e, uni_v, f, 70 + f, device)} for f in (32, 4)]
    argsum = argsums[0]
    for a in argsums:
        print(f"phase 13 arg-sum kernel vs plain: {json.dumps(a)}", flush=True)

    # 14. serve max requests through the kernel-form aligned plan
    served = serve(device, sbm, "aligned",
                   {"argmax": (aligned_max, "argmax_launches", 2),
                    "band": (aligned_band, "launches", 2),
                    "argsum": (aligned_max, "argsum_launches", 0),
                    "recsum": (segment_sum, "record_launches", 0)},
                   plan=AggregationPlan(aligned=al_kernel),
                   plain_plan=AggregationPlan(aligned=al_plan), plain_device=device,
                   first_aggr="max")
    print(f"phase 14 serve sbm60k max: {json.dumps(served)}", flush=True)

    # 15. train max, kernel form; then aligned_max_matvec's backward
    cfg, hg, x, y, split, plan = sbm_problem(sbm, al_plan)
    check(all(st.band.live is not None for st in plan.aligned.device(device)),
          "the max step's stages carry the kernels' live layouts")
    problems = {"sbm60k max": (dataclasses.replace(cfg, first_aggr="max"), hg, x, y, split,
                               plan)}
    trained = train(problems, device)["sbm60k max"]
    print(f"phase 15 train sbm60k max: {json.dumps(trained)}", flush=True)
    parity = train_parity(problems, device)["sbm60k max"]
    print(f"phase 15 no-dropout parity sbm60k max: {json.dumps(parity)}", flush=True)
    matvec = check_matvec(sbm, uni_e, uni_v, device)
    print(f"phase 15 aligned_max_matvec: {json.dumps(matvec)}", flush=True)

    # 16. times
    xs = {f: torch.as_tensor(np.random.default_rng(13).normal(size=(sbm.num_nodes, f))
                             .astype(np.float32), device=device) for f in (32, 4)}
    order = ("plain", "kernel", "kernel", "plain")
    argmax_times = {f"edge F={f}": time_turns({
        "kernel": lambda xf=xf: aligned_max.aligned_masked_argmax(xf, stages["edge"]),
        "plain": lambda xf=xf: aligned_max.aligned_max_plain(xf, stages["edge"])}, order)
        for f, xf in xs.items()}
    live = stage_live(stages["edge"])
    for f, xf in xs.items():  # layout, x, then val and arg written; a compare a feature
        argmax_times[f"edge F={f}"].update(max_bounds(
            stages["edge"], nbytes(xf) + sbm.num_edges * f * 8, live * f))
    argsum_times = {}
    for f in (32, 4):
        g, arg = argsum_operands(uni_e, uni_v, f, 71, device)
        fns = {"kernel": lambda g=g, arg=arg: aligned_max.aligned_masked_argsum(g, arg, uni_v),
               "plain": lambda g=g, arg=arg: aligned_max.aligned_argsum_plain(g, arg, uni_v)}
        library, why = scatter_yardstick(g, arg, uni_v.num_segments, fns["plain"]())
        if library is not None:
            fns["library"] = library
        t = time_turns(fns, order + (("library", "library") if library else ()))
        t["library"] = t.get("library")
        if why:
            t["library_note"] = why
        t.update(max_bounds(uni_v, nbytes(g, arg) + sbm.num_nodes * f * 4,
                            stage_live(uni_v) * f))
        argsum_times[f"vertex F={f}"] = t
    record_times = time_record(sbm.device_data(device), 32, device, torch.int32)
    mcfg = problems["sbm60k max"][0]
    trainers = {
        "aligned kernel": Trainer(mcfg, hg, x, y, plan=plan, device=device),
        "tree + aligned kernel": Trainer(
            mcfg, hg, x, y, plan=AggregationPlan(tree=plan_tree(hg), aligned=al_kernel),
            device=device),
        "aligned plain": Trainer(mcfg, hg, x, y, plan=AggregationPlan(aligned=al_plan),
                                 device=device),
    }
    epoch_order = ("aligned plain", "aligned kernel", "tree + aligned kernel",
                   "tree + aligned kernel", "aligned kernel", "aligned plain")
    epochs = time_steps(trainers, split["train"], epoch_order, device)
    print(f"phase 16 times (ms, CUDA events, median of 20): card {card}; SBM-60k max training "
          f"epoch (wall: 10 back-to-back steps, host included; device: behind a queued "
          f"sleep): {json.dumps(epochs)}; argmax kernel vs plain twin: "
          f"{json.dumps(argmax_times)}; arg-sum kernel vs plain twin vs scatter_add_, uniform "
          f"vertex stage: {json.dumps(argsum_times)}; record-routed sum vs plain twin, vertex-major "
          f"CSR, int32 ids, F=32: {json.dumps(record_times)}; HGNN max request on SBM-60k, "
          f"kernel form {served['request_ms']}", flush=True)
    return {"argmaxes": argmaxes, "argsum": argsum, "argsums": argsums, "layouts": layouts,
            "served": served, "trained": trained,
            "matvec": matvec, "argmax_times": argmax_times, "argsum_times": argsum_times,
            "record_times": record_times, "epochs": epochs, "stages": stages,
            "uniform": (uni_e, uni_v)}


def check_matvec(hg, e_stage, v_stage, device) -> dict:
    """One forward and backward of ``aligned_max_matvec`` on the uniform
    SBM-60k plan at F = 32: one argmax and one arg-sum launch, a forward
    bitwise equal to ``v2e_max_aligned``'s, and dx within rtol 1e-6, atol
    1e-6·max of the record-routed sum in plain torch over the vertex-major
    CSR (``segment_sum.record_routed_dx_plain``) on that forward's ids."""
    from hypergef_tpu_torch.ops import aligned_max, segment_sum

    hgd = hg.device_data(device)
    rng = np.random.default_rng(14)
    x = torch.as_tensor(rng.normal(size=(hg.num_nodes, 32)).astype(np.float32), device=device)
    cot = torch.as_tensor(rng.normal(size=(hg.num_edges, 32)).astype(np.float32),
                          device=device)
    xr = x.clone().requires_grad_(True)
    torch.cuda.synchronize()
    aligned_max.argmax_launches = aligned_max.argsum_launches = 0
    y = aligned_max.aligned_max_matvec(xr, e_stage, v_stage)
    (dx,) = torch.autograd.grad(y, xr, cot)
    torch.cuda.synchronize()
    launched = (aligned_max.argmax_launches, aligned_max.argsum_launches)
    check(launched == (1, 1), f"aligned_max_matvec launched (argmax, arg-sum) {launched}")
    yc, arg = aligned_max.aligned_max_with_arg(x, e_stage)
    check(torch.equal(y, yc), "the two ops' forwards are bitwise equal")
    want = segment_sum.record_routed_dx_plain(cot, arg, hgd.e2v)
    scale = float(want.abs().max())
    torch.testing.assert_close(dx, want, rtol=1e-6, atol=1e-6 * scale)
    return {"argmax_launches": launched[0], "argsum_launches": launched[1],
            "max_abs_err": float((dx - want).abs().max()), "max_abs": scale}


def build_stream100k():
    """stream100k from raw input, its bit packs and its tree plan, with the
    host seconds of each."""
    from hypergef_tpu_torch.data.synthetic import random_hypergraph
    from hypergef_tpu_torch.ops.bitstream import BitIncidence
    from hypergef_tpu_torch.sparse.planner import plan_tree

    secs = {}
    t0 = time.perf_counter()
    hg = random_hypergraph(STREAM100K["n"], STREAM100K["e"], avg_edge_size=STREAM100K["avg"],
                           seed=0, name="stream100k")
    secs["generate_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    bits = BitIncidence.from_hypergraph(hg)
    secs["pack_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    tree = plan_tree(hg)
    secs["plan_tree_s"] = time.perf_counter() - t0
    info = {"graph": "stream100k", "n": hg.num_nodes, "e": hg.num_edges, "nnz": hg.nnz,
            "ne_over_nnz": hg.num_nodes * hg.num_edges / hg.nnz,
            "table_bytes": bits.table_bytes(), **secs}
    return hg, bits, tree, info


def bit_packs(bits, device) -> dict:
    """The packs on the card by name: H [N, E] (E→V) and Hᵀ [E, N] (V→E)."""
    return dict(zip(("H", "Ht"), bits.device(device)))


def check_bitmm(pack, f: int, seed: int, device) -> dict:
    """The bit-packed product kernel against its plain twin on one pack."""
    from hypergef_tpu_torch.ops import bitstream

    x = torch.as_tensor(np.random.default_rng(seed).normal(size=(pack.k, f))
                        .astype(np.float32), device=device)
    before = bitstream.launches
    got = bitstream.bitmm(pack, x)
    again = bitstream.bitmm(pack, x)
    torch.cuda.synchronize()
    check(bitstream.launches == before + 2, "one bitmm launch per call")
    want = bitstream.bitmm_plain(pack.words, x, pack.m, pack.k)
    scale = float(want.abs().max())
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5 * scale)
    check(torch.equal(got, again), "two bitmm runs are bitwise equal")
    return {"m": pack.m, "k": pack.k, "f": f, "max_abs_err": float((got - want).abs().max()),
            "max_abs_plain": scale}


def bit_edge_packs(device) -> dict:
    """Packs of the kernel layout's edge cases, on the card: rows with no
    bit, a pack with none, a word with all 32 bits set, a row with every
    word nonzero (and one with a bit in most words), 35 K tiles a row, and
    rows of 0 to share + 1 bits, around the runs' cuts."""
    import scipy.sparse as sp

    from hypergef_tpu_torch.ops import bitstream

    rng = np.random.default_rng(17)
    share = max(bitstream.RUN_SHARES)
    empty_rows = (rng.random((300, 5000)) < 0.01).astype(np.uint8)
    empty_rows[::3] = 0
    full_word = np.zeros((9, 3 * 4096 + 50), np.uint8)
    full_word[2, 7::128] = 1
    every_word = np.zeros((5, 9000), np.uint8)
    every_word[1] = 1
    every_word[3, ::130] = 1
    around = np.zeros((110, 700), np.uint8)
    for r in range(110):
        around[r, rng.choice(700, size=r % (share + 2), replace=False)] = 1
    cases = {"empty_rows": empty_rows, "all_zero": np.zeros((40, 5000), np.uint8),
             "full_word": full_word, "every_word": every_word,
             "multi_tile": (rng.random((133, 140000)) < 0.0005).astype(np.uint8),
             "around_the_share": around}
    packs = {}
    for name, a in cases.items():
        csr = sp.csr_matrix(a)
        m, k = a.shape
        words = bitstream.pack_bits_csr(csr.indptr, csr.indices, m, k)
        packs[name] = bitstream.BitPack(np.pad(words, ((0, -m % 256), (0, 0))), m, k).to(device)
    return packs


def widened(pack, times: int):
    """A host pack of the same set bits, ``times`` as wide: zero words
    appended to each row (a column past the pack's is never set)."""
    from hypergef_tpu_torch.ops import bitstream

    w = np.asarray(pack.words)
    wide = np.concatenate([w, np.zeros((w.shape[0], (times - 1) * w.shape[1]), w.dtype)], axis=1)
    return bitstream.BitPack(wide, pack.m, times * pack.kp)


def check_zero_words_unread(host_pack, pack, device, times: int = 4) -> dict:
    """The kernel reads no zero word: the pack ``times`` as wide (zero words
    appended to each row, x padded with rows no bit names) gives the same
    output bitwise and times within 1.2× of the pack (CUDA events behind a
    queued sleep, in turns), where a kernel that streams the words would
    take about ``times`` as long."""
    from hypergef_tpu_torch.ops import bitstream

    wide = widened(host_pack, times).to(device)
    rng = np.random.default_rng(18)
    x = torch.as_tensor(rng.normal(size=(pack.k, 32)).astype(np.float32), device=device)
    pad = rng.normal(size=(wide.k - pack.k, 32)).astype(np.float32)
    x_wide = torch.cat([x, torch.as_tensor(pad, device=device)])
    check(torch.equal(bitstream.bitmm(pack, x), bitstream.bitmm(wide, x_wide)),
          "the widened pack gives the same output bitwise")
    t = time_turns({"pack": lambda: bitstream.bitmm(pack, x),
                    "wide": lambda: bitstream.bitmm(wide, x_wide)},
                   ("pack", "wide", "wide", "pack"))
    out = {"m": pack.m, "k": pack.k, "wide_k": wide.k, "pack_words": pack.words.numel(),
           "wide_words": wide.words.numel(), "layout_bytes": pack.layout.nbytes(),
           "wide_layout_bytes": wide.layout.nbytes(), "pack_ms": t["pack"],
           "wide_ms": t["wide"], "ratio": t["wide"] / t["pack"]}
    check(out["wide_layout_bytes"] == out["layout_bytes"], "the same layout bytes")
    check(out["ratio"] <= 1.2, f"a pack {times}x as wide times within 1.2x: {out}")
    return out


def check_bit_matvec(packs, f: int, seed: int, device) -> dict:
    """One forward and backward of ``bit_matvec`` over Hᵀ: one launch each,
    the forward and dx (the product with H on g) within the kernel's
    tolerance of the twin's."""
    from hypergef_tpu_torch.ops import bitstream

    h, ht = packs["H"], packs["Ht"]
    rng = np.random.default_rng(seed)
    x = torch.as_tensor(rng.normal(size=(ht.k, f)).astype(np.float32), device=device)
    g = torch.as_tensor(rng.normal(size=(ht.m, f)).astype(np.float32), device=device)
    xr = x.clone().requires_grad_(True)
    torch.cuda.synchronize()
    before = bitstream.launches
    y = bitstream.bit_matvec(xr, ht, h)
    (dx,) = torch.autograd.grad(y, xr, g)
    torch.cuda.synchronize()
    check(bitstream.launches == before + 2, "bit_matvec: one launch forward, one backward")
    errs = {}
    for name, got, want in (("y", y.detach(), bitstream.bitmm_plain(ht.words, x, ht.m, ht.k)),
                            ("dx", dx, bitstream.bitmm_plain(h.words, g, h.m, h.k))):
        scale = float(want.abs().max())
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5 * scale, msg=name)
        errs[name] = float((got - want).abs().max())
    return {"f": f, "max_abs_err": errs}


def time_bitmm(hg, pack, stage: str, f: int, device, iters: int) -> dict:
    """Kernel, plain twin and one ``torch.sparse.mm`` of the pack's CSR
    matrix on bf16(x) (the library yardstick), in turns. Two bounds, each
    with an add a feature for each set bit, x read once and the output
    written once: ``bound_ms`` reads the kernel's layout (its pairs, bit_ptr
    and runs); ``pack_bound_ms`` reads the m rows' words, as a kernel that
    streams the pack must."""
    from hypergef_tpu_torch.ops import bitstream
    from hypergef_tpu_torch.ops.fused_dense import bf16_round

    x = torch.as_tensor(np.random.default_rng(16).normal(size=(pack.k, f)).astype(np.float32),
                        device=device)
    xb = bf16_round(x)
    csr = incidence_csr(hg, stage, device)
    fns = {"kernel": lambda: bitstream.bitmm(pack, x),
           "plain": lambda: bitstream.bitmm_plain(pack.words, x, pack.m, pack.k),
           "library": lambda: torch.sparse.mm(csr, xb)}
    out = time_turns(fns, ("plain", "kernel", "library", "library", "kernel", "plain"),
                     iters=iters)
    rest, ops = nbytes(x) + pack.m * f * 4, hg.nnz * f
    whole = bound(pack.m * pack.words.shape[1] * 4 + rest, ops)
    out.update(bound(pack.layout.nbytes() + rest, ops))
    out.update({"pack_bound_ms": whole["bound_ms"], "pack_bytes": whole["bytes"]})
    return out


def bitstream_phases(device, card: str, graphs) -> dict:
    """Phases 17-20: the bitstream route, HGNN and the UniGNN models, on
    stream100k."""
    from hypergef_tpu_torch.data.synthetic import random_features
    from hypergef_tpu_torch.ops import bitstream
    from hypergef_tpu_torch.ops.bitstream import BitIncidence
    from hypergef_tpu_torch.sparse.planner import AggregationPlan, plan_pallas_sparse
    from hypergef_tpu_torch.train.splits import rand_train_test_idx
    from hypergef_tpu_torch.train.trainer import TrainConfig, Trainer

    # 17. stream100k from raw input; the kernel against its twin
    hg, bits, tree, info = build_stream100k()
    t0 = time.perf_counter()
    packs = bit_packs(bits, device)
    torch.cuda.synchronize()
    info["to_card_s"] = time.perf_counter() - t0  # the layouts' host builds included
    info["layouts"] = {name: {"build_s": p.layout.build_s, "bytes": p.layout.nbytes(),
                              "share": p.layout.share,
                              "pairs": int(p.layout.pairs.shape[0]),
                              "runs": int(p.layout.runs.shape[0]) - 1,
                              "pack_bytes": p.m * p.words.shape[1] * 4}
                       for name, p in packs.items()}
    for name, lay in info["layouts"].items():
        check(16 * lay["bytes"] <= lay["pack_bytes"],
              f"the {name} layout holds at most 1/16 of its pack's bytes: {lay}")
    print(f"phase 17 graph: {json.dumps(info)}", flush=True)
    pub = graphs["pubmed_real"]
    pub_bits = BitIncidence.from_hypergraph(pub)
    pub_packs = bit_packs(pub_bits, device)
    checks = []
    for seed, (name, f) in enumerate([(p, f) for p in ("Ht", "H") for f in (32, 4, 3)]):
        checks.append({"graph": "stream100k", "pack": name,
                       **check_bitmm(packs[name], f, 80 + seed, device)})
    for name in ("Ht", "H"):
        checks.append({"graph": "pubmed_real", "pack": name,
                       **check_bitmm(pub_packs[name], 32, 90 + len(checks), device)})
    for seed, (name, pack) in enumerate(bit_edge_packs(device).items()):
        for f in (32, 4, 3):
            checks.append({"graph": "edge case", "pack": name,
                           **check_bitmm(pack, f, 100 + 3 * seed + f, device)})
    for c in checks:
        print(f"phase 17 bitmm kernel vs plain: {json.dumps(c)}", flush=True)
    unread = check_zero_words_unread(pub_bits.ht_pack, pub_packs["Ht"], device)
    print(f"phase 17 zero words unread, pubmed_real Ht F=32 (ms, CUDA events, median of 20): "
          f"{json.dumps(unread)}", flush=True)
    matvec = check_bit_matvec(packs, 32, 95, device)
    print(f"phase 17 bit_matvec backward: {json.dumps(matvec)}", flush=True)

    # 18. serve HGNN and UniGCNII; the servers build their own packs. The
    # reference, the f32 tree route, does not round x to bf16 before each of
    # the four products, so it is held at the bf16 bar of
    # tests/test_fuzz_backends.py:54
    tree_plan = AggregationPlan(tree=tree)
    served = {model: serve(device, hg, "bitstream", {"bitmm": (bitstream, "launches", 4)},
                           plain_plan=tree_plan, plain_device=device, model=model,
                           ref_backend="tree", ref_atol=3e-2)
              for model in ("HGNN", "UniGCNII")}
    for model, s in served.items():
        print(f"phase 18 serve stream100k {model}: {json.dumps(s)}", flush=True)

    # 19. train with no plan=; then no-dropout parity
    x, y = random_features(hg.num_nodes, NFEAT, NCLASS, seed=1)
    split = rand_train_test_idx(y, seed=2)
    base = TrainConfig(model="HGNN", nhid=32, nlayer=2, first_aggr="sum", backend="bitstream")
    configs = {"HGNN sum": base, "HGNN max": dataclasses.replace(base, first_aggr="max"),
               "UniGIN": dataclasses.replace(base, model="UniGIN"),
               "UniGCNII": dataclasses.replace(base, model="UniGCNII")}
    trained = train({name: (cfg, hg, x, y, split, None) for name, cfg in configs.items()},
                    device)
    for name, t in trained.items():
        print(f"phase 19 train stream100k {name}: {json.dumps(t)}", flush=True)
    parity = {}
    for name, cfg in configs.items():
        cfg = dataclasses.replace(cfg, dropout=0.0, input_drop=0.0)
        plan = AggregationPlan(bitstream=bits, tree=tree if cfg.first_aggr == "max" else None)
        parity[name] = loss_parity(name, (cfg, plan, device),
                                   (dataclasses.replace(cfg, backend="tree"), tree_plan, device),
                                   (hg, x, y, split), 1e-2, "tree")
    pcfg, _, px, py, psplit, _ = train_problem("pubmed_real")
    pcfg = dataclasses.replace(pcfg, backend="bitstream", dropout=0.0, input_drop=0.0)
    parity["pubmed_real HGNN sum"] = loss_parity(
        "pubmed_real", (pcfg, None, device),
        (dataclasses.replace(pcfg, backend="dense"), None, device), (pub, px, py, psplit), 1e-3,
        "dense", first_rtol=1e-5)
    for name, t in parity.items():
        print(f"phase 19 no-dropout parity {name}: {json.dumps(t)}", flush=True)

    # 20. times
    bitmm_times = {}
    for gname, g, ps, iters in (("stream100k", hg, packs, 2), ("pubmed_real", pub, pub_packs, 10)):
        for f in (32, 4):
            for name, stage in (("Ht", "edge"), ("H", "vertex")):
                bitmm_times[f"{gname} {name} F={f}"] = time_bitmm(g, ps[name], stage, f, device,
                                                                  iters)
    trainers = {
        "HGNN bitstream": Trainer(base, hg, x, y, plan=AggregationPlan(bitstream=bits),
                                  device=device),
        "HGNN tree": Trainer(dataclasses.replace(base, backend="tree"), hg, x, y, plan=tree_plan,
                             device=device),
        "HGNN pallas_sparse": Trainer(dataclasses.replace(base, backend="pallas_sparse"), hg, x,
                                      y, plan=plan_pallas_sparse(hg), device=device),
        "HGNN max bitstream": Trainer(configs["HGNN max"], hg, x, y,
                                      plan=AggregationPlan(bitstream=bits, tree=tree),
                                      device=device),
        "UniGCNII bitstream": Trainer(configs["UniGCNII"], hg, x, y,
                                      plan=AggregationPlan(bitstream=bits), device=device),
    }
    names = list(trainers)
    epochs = time_steps(trainers, split["train"], names + names[::-1], device)
    requests = {model: s["request_ms"] for model, s in served.items()}
    record_times = time_record(hg.device_data(device), 32, device, torch.int64)
    print(f"phase 20 times (ms, CUDA events, median of 20): card {card}; stream100k training "
          f"epoch (wall: 10 back-to-back steps, host included; device: behind a queued "
          f"sleep): {json.dumps(epochs)}; bitmm kernel vs plain twin vs torch.sparse.mm, "
          f"bound over the layout and over the whole pack: {json.dumps(bitmm_times)}; "
          f"record-routed sum vs plain twin, vertex-major CSR, "
          f"int64 ids, F=32: {json.dumps(record_times)}; request on stream100k, bitstream: "
          f"{json.dumps(requests)}", flush=True)
    return {"checks": checks, "matvec": matvec, "served": served, "trained": trained,
            "parity": parity, "bitmm_times": bitmm_times, "record_times": record_times,
            "epochs": epochs, "hg": hg, "layouts": info["layouts"], "unread": unread}


def ladder_phase(device, graphs) -> dict:
    """Phase 21: ``plan_aggregation`` on the card for each graph, its pick
    against JAX's (``LADDER_PICKS``), and its host planning time."""
    from hypergef_tpu_torch.sparse.planner import plan_aggregation

    out = {}
    for name, hg in graphs.items():
        t0 = time.perf_counter()
        plan = plan_aggregation(hg, device)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        pick = plan.preferred_backend
        check(pick == LADDER_PICKS[name], f"{name}: the ladder picks {pick}, JAX "
              f"{LADDER_PICKS[name]}")
        check(plan.tree is not None and plan.tree.form == "xla", f"{name}: plain-form tree")
        if plan.aligned is not None:
            check(plan.aligned.form == "pallas_auto", f"{name}: aligned kernel form on the card")
        out[name] = {"n": hg.num_nodes, "e": hg.num_edges, "nnz": hg.nnz, "pick": pick,
                     "built": [f for f in ("dense", "precomp", "aligned", "bitstream")
                               if getattr(plan, f) is not None], "plan_s": secs}
    return out


def segment_operands(table, f: int, seed: int, device):
    return torch.as_tensor(np.random.default_rng(seed).normal(size=(table.num_inputs, f))
                           .astype(np.float32), device=device)


def check_segsum(table, f: int, seed: int, device) -> dict:
    """The segment-sum kernel against its plain version: rtol 1e-6, atol
    1e-6·max|plain| (the same f32 terms, summed by the kernel in CSR order
    and by segment_reduce in its own); two runs bitwise equal; one launch a
    call."""
    from hypergef_tpu_torch.ops import segment_sum

    x = segment_operands(table, f, seed, device)
    before = segment_sum.launches
    got = segment_sum.gather_segment_sum(x, table)
    again = segment_sum.gather_segment_sum(x, table)
    torch.cuda.synchronize()
    check(segment_sum.launches == before + 2, "one segment-sum launch per call")
    want = segment_sum.gather_segment_sum_plain(x, table)
    scale = float(want.abs().max())
    torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6 * scale)
    check(torch.equal(got, again), "two segment-sum runs are bitwise equal")
    return {"s": table.num_segments, "n": table.num_inputs, "nnz": table.nnz, "f": f,
            "identity": table.gather is None, "max_abs_err": float((got - want).abs().max()),
            "max_abs_plain": scale}


def check_incidence_backward(hgd, f: int, device) -> dict:
    """One forward and backward of ``incidence_gather_sum`` over V→E: one
    launch each, dx against the plain E→V sum of the cotangent."""
    from hypergef_tpu_torch.ops import segment_sum
    from hypergef_tpu_torch.ops.segments import incidence_gather_sum

    rng = np.random.default_rng(23)
    x = torch.as_tensor(rng.normal(size=(hgd.num_nodes, f)).astype(np.float32), device=device)
    g = torch.as_tensor(rng.normal(size=(hgd.num_edges, f)).astype(np.float32), device=device)
    xr = x.clone().requires_grad_(True)
    torch.cuda.synchronize()
    before = segment_sum.launches
    y = incidence_gather_sum(xr, hgd.v2e, hgd.e2v)
    (dx,) = torch.autograd.grad(y, xr, g)
    torch.cuda.synchronize()
    check(segment_sum.launches == before + 2, "incidence_gather_sum: one launch each way")
    errs = {}
    for name, got, want in (("y", y.detach(), segment_sum.gather_segment_sum_plain(x, hgd.v2e)),
                            ("dx", dx, segment_sum.gather_segment_sum_plain(g, hgd.e2v))):
        scale = float(want.abs().max())
        torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6 * scale, msg=name)
        errs[name] = float((got - want).abs().max())
    return {"f": f, "max_abs_err": errs}


def check_record(hgd, f: int, seed: int, device, dtype) -> dict:
    """The record-routed sum (the masked segment-sum kernel) against its
    plain twin over ``hgd.e2v``: rtol 1e-6, atol 1e-6·max|plain| (the same
    f32 terms, zeros where an id differs, in another order); two runs
    bitwise equal; one launch a call."""
    from hypergef_tpu_torch.ops import segment_sum
    from hypergef_tpu_torch.tools.segment_sum_ab import record_operands

    g, arg = record_operands(hgd, f, seed, device, dtype)
    table = hgd.e2v
    before = segment_sum.record_launches
    got = segment_sum.record_routed_dx(g, arg, table)
    again = segment_sum.record_routed_dx(g, arg, table)
    torch.cuda.synchronize()
    check(segment_sum.record_launches == before + 2, "one record-sum launch per call")
    want = segment_sum.record_routed_dx_plain(g, arg, table)
    scale = float(want.abs().max())
    torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6 * scale)
    check(torch.equal(got, again), "two record-sum runs are bitwise equal")
    return {"s": table.num_segments, "n": table.num_inputs, "nnz": table.nnz, "f": f,
            "ids": str(dtype).split(".")[-1], "max_abs_err": float((got - want).abs().max()),
            "max_abs_plain": scale, "nonzero_share": float((want != 0).float().mean())}


def scatter_yardstick(g, arg, rows: int, want):
    """One PyTorch call of a record-routed sum, ``dx[arg[e, f], f] +=
    g[e, f]``: ``torch.zeros(rows, F).scatter_add_(0, ids, g)``, the ids cast
    to int64 before the window (scatter_add_ takes no int32 index); checked
    once against ``want`` (rtol 1e-5: its atomics add in any order). None,
    with the reason, where an id is negative (an edge with no member, -1):
    scatter_add_ takes no such index."""
    if int(arg.min()) < 0:
        return None, "ids of -1 (edges with no member): scatter_add_ takes no negative index"
    ids = arg.long()

    def call():
        return torch.zeros((rows, g.shape[1]), device=g.device).scatter_add_(0, ids, g)

    torch.testing.assert_close(call(), want, rtol=1e-5, atol=1e-5 * float(want.abs().max()))
    return call, None


def time_record(hgd, f: int, device, dtype) -> dict:
    """The record-routed sum's kernel, plain twin and, where the ids allow,
    one ``scatter_add_`` (the library yardstick) in turns; the bound moves
    the rows of g and arg the CSR names, its int32 gather and row pointer,
    and the output once, with a compare and an add a feature for each
    entry."""
    from hypergef_tpu_torch.ops import segment_sum
    from hypergef_tpu_torch.tools.segment_sum_ab import record_operands

    g, arg = record_operands(hgd, f, 27, device, dtype)
    table = hgd.e2v
    fns = {"kernel": lambda: segment_sum.record_routed_dx(g, arg, table),
           "plain": lambda: segment_sum.record_routed_dx_plain(g, arg, table)}
    library, why = scatter_yardstick(g, arg, table.num_segments, fns["plain"]())
    order = ("plain", "kernel", "kernel", "plain")
    if library is not None:
        fns["library"] = library
        order = ("plain", "kernel", "library", "library", "kernel", "plain")
    out = time_turns(fns, order)
    out["library"] = out.get("library")
    if why:
        out["library_note"] = why
    read = rows_read_bytes(g, table.gather) + rows_read_bytes(arg, table.gather)
    out.update(bound(read + nbytes(table.gather, table.indptr) + table.num_segments * f * 4,
                     2 * table.nnz * f))
    return out


def segsum_phase(device, graphs) -> dict:
    """Phase 22: the segment-sum kernel on both directions of coauthor_dblp
    at F = 32, 4, 3 and 1425, on the identity gathers of the one-hot probes'
    shapes, on a CSR with empty segments and one with a long segment;
    incidence_gather_sum's backward; the record-routed sum on coauthor_dblp,
    SBM-60k and stream100k."""
    from hypergef_tpu_torch.ops.segment_sum import SegmentTable

    hgd = graphs["coauthor_dblp"].device_data(device)
    cases = []
    for seed, (stage, f) in enumerate([(s, f) for s in ("v2e", "e2v") for f in (32, 4, 3, 1425)]):
        cases.append({"graph": "coauthor_dblp", "stage": stage,
                      **check_segsum(getattr(hgd, stage), f, 110 + seed, device)})
    rng = np.random.default_rng(24)
    for ts, r in ((8, 64), (256, 4096)):  # pallas_probe3.py:97, pallas_probe.py:17,81
        seg = np.sort(rng.integers(0, ts, size=r))
        table = SegmentTable.build(np.searchsorted(seg, np.arange(ts + 1)), None, r, device)
        cases.append({"graph": f"one-hot TS={ts} R={r}",
                      **check_segsum(table, 32 if ts == 8 else 128, 120 + ts, device)})
    sizes = rng.poisson(3.0, size=5000)
    sizes[::3] = 0
    indptr = np.concatenate([[0], np.cumsum(sizes)])
    table = SegmentTable.build(indptr, rng.integers(0, 7000, size=int(indptr[-1])), 7000, device)
    cases.append({"graph": "empty segments", **check_segsum(table, 32, 125, device)})
    sizes[17] = 12_000  # a run of one long segment, summed by the whole warp
    indptr = np.concatenate([[0], np.cumsum(sizes)])
    table = SegmentTable.build(indptr, rng.integers(0, 7000, size=int(indptr[-1])), 7000, device)
    for f in (32, 1425):
        cases.append({"graph": "a long segment", **check_segsum(table, f, 126 + f, device)})
    records = [{"graph": name, **check_record(graphs[name].device_data(device), f, 130 + i,
                                              device, dtype)}
               for i, (name, f, dtype) in enumerate([
                   ("coauthor_dblp", 32, torch.int64), ("coauthor_dblp", 6, torch.int32),
                   ("coauthor_dblp", 3, torch.int32), ("sbm60k", 32, torch.int32),
                   ("stream100k", 32, torch.int64)])]
    return {"cases": cases, "records": records,
            "backward": check_incidence_backward(hgd, 32, device)}


def default_problem(hg, nfeat: int, nclass: int, **cfg):
    """(cfg, graph, x, y, split, plan) with ``TrainConfig()``'s defaults but
    ``cfg``: no ``backend=``, no ``plan=``."""
    from hypergef_tpu_torch.data.synthetic import random_features
    from hypergef_tpu_torch.train.splits import rand_train_test_idx
    from hypergef_tpu_torch.train.trainer import TrainConfig

    x, y = random_features(hg.num_nodes, nfeat, nclass, seed=1)
    return (dataclasses.replace(TrainConfig(), **cfg), hg, x, y, rand_train_test_idx(y, seed=2),
            None)


def default_phases(device, graphs) -> dict:
    """Phase 23: serve and train with no ``backend=`` and no ``plan=``."""
    counters = kernel_counters()
    zero = {k: (module, attr, 0) for k, (module, attr) in counters.items()}
    dblp, cora = graphs["coauthor_dblp"], graphs["cora"]
    served = {
        "coauthor_dblp": serve(device, dblp, None, {**zero, "segsum": (counters["segsum"][0],
                                                                     "launches", 4)},
                               plain_device=device, ref_backend="tree", ref_atol=1e-3,
                               nfeat=DBLP_NFEAT, nclass=DBLP_NCLASS),
        # the same route on CPU tensors within phase 3's bf16 bar, 1e-2 (the f32
        # projections sum in another order, so x can round to a neighbouring bf16
        # value); the f32 xla route within the bf16 bar of
        # tests/test_fuzz_backends.py:54, an absolute 3e-2
        "cora": serve(device, cora, None, zero, nfeat=CORA_NFEAT, nclass=CORA_NCLASS,
                      xla_atol=3e-2),
    }
    check(served["coauthor_dblp"]["route"] == "cumsum" and served["cora"]["route"] == "precomp",
          f"default serving routes {[s['route'] for s in served.values()]}")
    problems = {
        "coauthor_dblp HGNN sum": default_problem(dblp, DBLP_NFEAT, DBLP_NCLASS),
        "coauthor_dblp HGNN max": default_problem(dblp, DBLP_NFEAT, DBLP_NCLASS,
                                                  first_aggr="max"),
        "coauthor_dblp UniGCNII": default_problem(dblp, DBLP_NFEAT, DBLP_NCLASS,
                                                  model="UniGCNII"),
        "cora HGNN": default_problem(cora, CORA_NFEAT, CORA_NCLASS),
        "20news HGNN": default_problem(graphs["20news"], NFEAT, NCLASS),
    }
    trained = train(problems, device)
    routes = {k: t["route"] for k, t in trained.items()}
    check(routes == {"coauthor_dblp HGNN sum": "cumsum", "coauthor_dblp HGNN max": "cumsum",
                     "coauthor_dblp UniGCNII": "cumsum", "cora HGNN": "precomp",
                     "20news HGNN": "dense"}, f"default training routes {routes}")
    parity = {}
    for name, (cfg, hg, x, y, split, _) in problems.items():
        if name.startswith("20news"):
            continue
        cfg = dataclasses.replace(cfg, dropout=0.0, input_drop=0.0)
        # cumsum and tree: f32 direct sums; precomp rounds A and x to bf16
        rtol = 1e-2 if name.startswith("cora") else 1e-3
        parity[name] = loss_parity(name, (cfg, None, device),
                                   (dataclasses.replace(cfg, backend="tree"), None, device),
                                   (hg, x, y, split), rtol, "tree")
    return {"served": served, "trained": trained, "parity": parity, "problems": problems}


def time_segsum(hg, stage: str, f: int, device) -> dict:
    """Kernel, plain version and one ``torch.sparse.mm`` of the same CSR, in
    turns; the bound moves the rows of x the gather names, the int32 gather
    and row pointer, and the output once, with an add a feature for each
    entry."""
    from hypergef_tpu_torch.ops import segment_sum

    table = getattr(hg.device_data(device), stage)
    x = segment_operands(table, f, 26, device)
    csr = incidence_csr(hg, "edge" if stage == "v2e" else "vertex", device)
    fns = {"kernel": lambda: segment_sum.gather_segment_sum(x, table),
           "plain": lambda: segment_sum.gather_segment_sum_plain(x, table),
           "library": lambda: torch.sparse.mm(csr, x)}
    out = time_turns(fns, ("plain", "kernel", "library", "library", "kernel", "plain"))
    read = (table.nnz * f * 4 if table.gather is None
            else rows_read_bytes(x, table.gather) + nbytes(table.gather))
    out.update(bound(read + nbytes(table.indptr) + table.num_segments * f * 4, table.nnz * f))
    return out


def request_times(device, problems) -> dict:
    """A request (host included) on each route of each cell."""
    from hypergef_tpu_torch.serve import ServingModel
    from hypergef_tpu_torch.utils.timing import cuda_time_ms

    out = {}
    for name, (cfg, hg, x, nclass, routes, plans) in problems.items():
        xd = torch.as_tensor(x, device=device)
        for route in routes:
            server = ServingModel(dataclasses.replace(cfg, backend=route), hg, x.shape[1], nclass,
                                  device, plan=plans.get(route))
            out[f"{name} {route}"] = cuda_time_ms(lambda s=server: s.predict(xd), repeats=20,
                                                  queue_ahead=False)
    return out


def default_times(device, card: str, graphs, problems) -> dict:
    """Phase 24: the segment-sum kernel per direction at F = 32; the
    coauthor_dblp epoch on cumsum, tree and pallas_sparse; the cora epoch on
    precomp, dense and pallas; a request on each."""
    from hypergef_tpu_torch.sparse.planner import plan_pallas_sparse
    from hypergef_tpu_torch.train.trainer import Trainer

    dblp = graphs["coauthor_dblp"]
    segsum_times = {f"{stage} F=32": time_segsum(dblp, stage, 32, device)
                    for stage in ("v2e", "e2v")}
    record_times = time_record(dblp.device_data(device), 32, device, torch.int64)
    cells = {"coauthor_dblp": ("coauthor_dblp HGNN sum", ("cumsum", "tree", "pallas_sparse"),
                               DBLP_NCLASS),
             "cora": ("cora HGNN", ("precomp", "dense", "pallas"), CORA_NCLASS)}
    epochs, reqs = {}, {}
    for cell, (pname, routes, nclass) in cells.items():
        cfg, hg, x, y, split, _ = problems[pname]
        plans = {"pallas_sparse": plan_pallas_sparse(hg)} if "pallas_sparse" in routes else {}
        trainers = {r: Trainer(dataclasses.replace(cfg, backend=r), hg, x, y, plan=plans.get(r),
                               device=device) for r in routes}
        epochs[cell] = time_steps(trainers, split["train"], routes + routes[::-1], device)
        reqs[cell] = (cfg, hg, x, nclass, routes, plans)
    requests = request_times(device, reqs)
    print(f"phase 24 times (ms, CUDA events, median of 20): card {card}; segment-sum kernel vs "
          f"plain vs torch.sparse.mm, coauthor_dblp F=32: {json.dumps(segsum_times)}; "
          f"record-routed sum vs plain twin vs scatter_add_, coauthor_dblp vertex-major CSR, "
          f"int64 ids, F=32: {json.dumps(record_times)}; training "
          f"epoch (wall: 10 back-to-back steps, host included; device: behind a queued sleep): "
          f"{json.dumps(epochs)}; requests (host included): {json.dumps(requests)} (reference's "
          f"RTX 3090 fused kernel at F=32, not a claim: {json.dumps(REF_RTX3090_FUSED_MS)})",
          flush=True)
    return {"segsum_times": segsum_times, "record_times": record_times, "epochs": epochs,
            "requests": requests}


def time_probe_kernels(device) -> dict:
    """Each probe kernel against its plain version and a library call at a
    probe's shapes: the row gather at pallas_probe3's flat take (85,024 rows
    of [19,717, 32]), the chunk sum at its e_call ([10,628, 8, 32]), the
    scaled copy at probe_r2b_bisect's k0 ([1024, 128])."""
    from hypergef_tpu_torch import probes

    rng = np.random.default_rng(0)
    x = torch.as_tensor(rng.normal(size=(19717, 32)).astype(np.float32), device=device)
    idx = torch.as_tensor(rng.integers(0, 19717, size=85024).astype(np.int32), device=device)
    idx_long = idx.long()
    g = torch.as_tensor(rng.normal(size=(10628, 8, 32)).astype(np.float32), device=device)
    m = torch.as_tensor((rng.random((10628, 8)) > 0.2).astype(np.float32), device=device)
    x0 = torch.as_tensor(rng.normal(size=(1024, 128)).astype(np.float32), device=device)
    order = ("plain", "kernel", "library", "library", "kernel", "plain")
    out = {
        "row_gather": time_turns({"kernel": lambda: probes.row_gather(x, idx),
                                  "plain": lambda: probes.row_gather_plain(x, idx),
                                  "library": lambda: x.index_select(0, idx_long)}, order),
        "chunk_masked_sum": time_turns({
            "kernel": lambda: probes.chunk_masked_sum(g, m),
            "plain": lambda: probes.chunk_masked_sum_plain(g, m),
            "library": lambda: torch.einsum("cgf,cg->cf", g, m)}, order),
        "scaled_copy": time_turns({"kernel": lambda: probes.scaled_copy(x0, 2.0),
                                   "plain": lambda: x0 * 2.0,
                                   "library": lambda: torch.mul(x0, 2.0)}, order),
    }
    out["row_gather"].update(bound(rows_read_bytes(x, idx) + nbytes(idx) + idx.shape[0] * 32 * 4,
                                   0))
    out["chunk_masked_sum"].update(bound(nbytes(g, m) + 10628 * 32 * 4, 2 * g.numel()))
    out["scaled_copy"].update(bound(2 * nbytes(x0), x0.numel()))
    return out


def r2_chunk_sum_bounds() -> dict:
    """The bound of probe_r2_gather's chunk sums (its ELL stage, on the gather
    kernel or through the ring) at each of its scales, from the probe's own
    tables (``probes.probe_r2_gather``'s draw): the distinct x rows the gather
    names (masked slots too: a 0 times Inf is NaN), the index and mask tables
    and the output, each moved once; a multiply-add a slot and feature."""
    from hypergef_tpu_torch import probes

    out = {}
    for scale, (n, nnz, f) in probes.R2_SCALES.items():
        c = nnz // probes.NGS
        gidx = np.random.default_rng(0).integers(0, n, size=(c, probes.NGS)).astype(np.int32)
        rows = int(np.unique(gidx).size)
        out[scale] = bound(rows * f * 4 + 2 * gidx.size * 4 + c * f * 4, 2 * gidx.size * f)
    return out


def probe_phase(device, card: str) -> dict:
    """Phase 25: every probe of scripts/ at its script's shapes, each case
    against the script's oracle and timed against a library call; the
    launches of the checked calls (timing launches not counted)."""
    from hypergef_tpu_torch import probes

    rows = []
    for name, fn in probes.PROBES.items():
        for r in fn(device, timed=True):
            rows.append({"probe": name, **r})
    bad = [(r["probe"], r["case"], r["max_abs_err"]) for r in rows if not r["ok"]]
    check(not bad, f"probes off their oracles: {bad}")
    check(all(r["launches"] == 1 for r in rows), "one launch per checked probe call")
    launches = {}
    for r in rows:
        launches[r["kernel"]] = launches.get(r["kernel"], 0) + r["launches"]
    times = time_probe_kernels(device)
    times["r2 chunk sum bounds"] = r2_chunk_sum_bounds()
    print(f"phase 25 probes (ms, CUDA events behind a queued sleep, median of 20; card {card}): "
          + json.dumps([{k: r[k] for k in ("probe", "case", "kernel", "ok", "max_abs_err", "ms",
                                           "library_ms")} for r in rows]), flush=True)
    print(f"phase 25 probe kernels vs plain vs library: {json.dumps(times)}", flush=True)
    return {"rows": rows, "launches": launches, "times": times}


# ``--profile``'s variants of the band kernel: csrc/aligned_band.cu without
# its tensor-core products, or without rounding x to bf16 into the
# transposed tile (wrong results: each times the rest of the slab loop).
# Each substitution must apply exactly once; tests/test_torch_port_aligned.py
# checks that it does on the CPU
BAND_ABLATIONS = {
    "no products": [("      if (active) {\n", "      if (false) {\n")],
    "no rounding": [("      if (i + 1 < count)\n        to_bf16_tile(",
                     "      if (false)\n        to_bf16_tile(")],
}


def band_ablation_source(name: str, source: str) -> str:
    """The band kernel's ``source`` with ablation ``name`` applied."""
    for old, new in BAND_ABLATIONS[name]:
        if source.count(old) != 1:
            raise ValueError(f"{name}: {old!r} is not in the band kernel's source once")
        source = source.replace(old, new)
    return source


def build_band_ablations() -> dict:
    """Compile every ablation of the band kernel into a library of its own
    under build/ablations/, all at once: ``{name: CDLL}``."""
    from hypergef_tpu_torch.ops import _build

    out = _build.BUILD_DIR.parent / "ablations"
    out.mkdir(parents=True, exist_ok=True)
    source = (_build.CSRC / "aligned_band.cu").read_text()
    procs = {}
    for i, name in enumerate(BAND_ABLATIONS):
        cu = out / f"aligned_band_{i}.cu"
        cu.write_text(band_ablation_source(name, source))
        procs[name] = (cu.with_suffix(".so"), subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-shared", "-o", str(cu.with_suffix(".so")),
             str(cu)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (so, proc) in procs.items():
        log = proc.communicate()[0]
        check(proc.returncode == 0, f"the band kernel's ablation {name!r} builds:\n{log[-2000:]}")
        libs[name] = _build.typed(ctypes.CDLL(str(so)))
    return libs


def profile_band(device) -> None:
    """``--profile``: the band kernel on both SBM-60k stages at F = 32, in
    turns with its ablations (``BAND_ABLATIONS``), with itself over work
    items that cut no group, and with one ``torch.sparse.mm`` of the
    stage's CSR matrix (CUDA events behind a queued sleep, median of 20)."""
    from hypergef_tpu_torch.ops import aligned_band
    from hypergef_tpu_torch.ops.fused_dense import bf16_round

    libs = {"kernel": aligned_band._library(), **build_band_ablations()}
    sbm, plan, _ = build_sbm60k()
    stages = zip(("edge", "vertex"), dataclasses.replace(plan, form="pallas_auto").device(device))
    for name, st in stages:
        t = st.band
        d = t.groups.cpu().numpy()
        whole, _ = aligned_band.band_work(d[:, aligned_band._WIDTH], d[:, aligned_band._SW],
                                          t.block_rows, t.group_rows, ctas=0)
        whole = torch.as_tensor(whole, device=device)
        x = torch.as_tensor(np.random.default_rng(12).normal(size=(st.num_inputs, 32))
                            .astype(np.float32), device=device)
        xb, csr = bf16_round(x), incidence_csr(sbm, name, device)
        fns = {k: functools.partial(aligned_band.launch_band, lib, x, t, t.work, t.slots)
               for k, lib in libs.items()}
        fns["kernel, whole groups"] = functools.partial(
            aligned_band.launch_band, libs["kernel"], x, t, whole, 0)
        fns["library"] = lambda: torch.sparse.mm(csr, xb)
        times = time_turns(fns, list(fns) + list(fns)[::-1])
        print(f"profile band {name} F=32 ({t.num_groups} groups, {t.work.shape[0]} work items, "
              f"{t.slots} cut; ms, CUDA events behind a queued sleep, median of 20): "
              + json.dumps(times), flush=True)


def profile_steps(device, steps: int = 10) -> None:
    """``--profile``: the SBM-60k training step of each aligned-route form,
    the default path's step on coauthor_dblp (``cumsum``) and cora
    (``precomp``), and the 20news ``pallas`` step (phase 7's) under
    ``torch.profiler`` (``steps`` steps after 5 warm-up ones): the device's
    busy time a step, its kernel count, the kernels that take the most
    device time and the fused dense kernel's share. Not part of the smoke
    run."""
    from torch.profiler import ProfilerActivity, profile

    from hypergef_tpu_torch.sparse.planner import AggregationPlan, plan_tree
    from hypergef_tpu_torch.train.trainer import Trainer

    sbm, al_plan, _ = build_sbm60k()
    cfg, hg, x, y, split, plan = sbm_problem(sbm, al_plan)
    kernel = plan.aligned
    mcfg = dataclasses.replace(cfg, first_aggr="max")
    forms = {
        "sum aligned kernel": (cfg, plan),
        "max aligned kernel": (mcfg, plan),
        "max tree + aligned kernel": (mcfg, AggregationPlan(tree=plan_tree(hg), aligned=kernel)),
        "max aligned plain": (mcfg, AggregationPlan(aligned=al_plan)),
    }
    # the max backward at SBM-60k F = 32 (segment_sum.record_routed_dx: one
    # launch of the masked segment-sum kernel) beside the pieces of its plain
    # twin, each alone: row gathers by h_edge in three forms, and the direct
    # segment sum
    from hypergef_tpu_torch.ops.segment_sum import record_routed_dx
    from hypergef_tpu_torch.ops.segments import segment_sum_sorted
    from hypergef_tpu_torch.utils.timing import cuda_time_ms

    hgd = hg.device_data(device)
    rng = np.random.default_rng(15)
    g = torch.as_tensor(rng.normal(size=(hg.num_edges, 32)).astype(np.float32), device=device)
    arg = torch.as_tensor(rng.integers(0, hg.num_nodes, size=(hg.num_edges, 32))
                          .astype(np.int32), device=device)
    vals = g.index_select(0, hgd.h_edge)
    pieces = {
        "index_select f32": lambda: g.index_select(0, hgd.h_edge),
        "index_select int32": lambda: arg.index_select(0, hgd.h_edge),
        "advanced index f32": lambda: g[hgd.h_edge],
        "torch.gather f32": lambda: torch.gather(g, 0, hgd.h_edge[:, None].expand(-1, 32)),
        "segment_sum_sorted": lambda: segment_sum_sorted(vals, hgd.h_indptr),
        "record_routed_dx kernel": lambda: record_routed_dx(g, arg, hgd.e2v),
    }
    print("profile CSR backward pieces (ms, CUDA events behind a queued sleep, median of 20): "
          + json.dumps({k: cuda_time_ms(f, repeats=20, iters=10) for k, f in pieces.items()}),
          flush=True)
    trainers = {name: (Trainer(c, hg, x, y, plan=p, device=device), split["train"])
                for name, (c, p) in forms.items()}
    # the default path's cells, TrainConfig()'s defaults (phase 23)
    for name, nfeat, nclass in (("coauthor_dblp", DBLP_NFEAT, DBLP_NCLASS),
                                ("cora", CORA_NFEAT, CORA_NCLASS)):
        c, g, xd, yd, sp, _ = default_problem(make_graph(name), nfeat, nclass)
        trainers[f"{name} defaults"] = (Trainer(c, g, xd, yd, device=device), sp["train"])
    c, g, xd, yd, sp, p = train_problem("20news")
    trainers["20news pallas"] = (Trainer(c, g, xd, yd, plan=p, device=device), sp["train"])
    for name, (tr, train_idx) in trainers.items():
        idx = torch.as_tensor(train_idx, device=device)
        for _ in range(5):
            tr.step(idx)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(steps):
                tr.step(idx)
            torch.cuda.synchronize()
        # kernels on the device; the optimizer's range annotation is no kernel
        rows = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA
                and e.self_device_time_total > 0 and not e.key.startswith("Optimizer.")]
        busy = sum(e.self_device_time_total for e in rows) / steps / 1e3
        count = sum(e.count for e in rows) / steps
        top = sorted(rows, key=lambda e: -e.self_device_time_total)[:12]
        fused = sum(e.self_device_time_total for e in rows
                    if "fused_dense_kernel" in e.key) / steps / 1e3
        print(f"profile {name}: device busy {busy:.5f} ms a step, {count:.1f} kernels a step, "
              f"fused dense kernel {fused:.6f} ms a step ({fused / busy:.4f} of busy); "
              + json.dumps({e.key[:90]: round(e.self_device_time_total / steps / 1e3, 6)
                            for e in top}), flush=True)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if sys.argv[1:] == ["--profile"]:
        print(f"card: {card_line()}", flush=True)
        profile_band(torch.device("cuda", 0))
        profile_steps(torch.device("cuda", 0))
        return 0
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
    cora = make_graph("cora")
    cases = [check_kernel(graphs["20news"], 32, 1, device),
             check_kernel(graphs["20news"], 4, 2, device),
             check_kernel(graphs["20news"], 100, 11, device),
             check_kernel(graphs["pubmed_real"], 32, 3, device),
             check_kernel(cora, 32, 12, device),
             check_kernel(cora, 7, 13, device),
             check_kernel(duplicate_incidences(graphs["20news"], 0.05, 14), 32, 15, device)]
    check(cases[-1]["max_count"] == 2, "the duplicated table holds counts of 2")
    for c in cases:
        print(f"phase 2 kernel vs plain: {json.dumps(c)}", flush=True)
    from hypergef_tpu_torch.ops import fused_dense

    fd_ops = kernel_operands(graphs["20news"], 32, 1, device)
    fd_kernels = cuda_kernels_per_call(lambda: fused_dense.fused_dense_two_stage(*fd_ops))
    check(fd_kernels == 1, f"one CUDA kernel a fused dense call, got {fd_kernels}")
    print(f"phase 2 CUDA kernels a fused dense call (torch.profiler): {fd_kernels}", flush=True)

    # 3. serve
    served = serve(device, make_graph("20news"), "pallas",
                   {"fused_dense": (fused_dense, "launches", 2)})
    print(f"phase 3 serve: {json.dumps(served)}", flush=True)

    # 4. times
    times = {name: time_kernel(hg, 32, device) for name, hg in {**graphs, "cora": cora}.items()}
    print("phase 4 times (ms, CUDA events, median of 20): card "
          f"{card}; fused kernel vs plain vs two library products vs bound (table read "
          "once; twice) at F=32: "
          + "; ".join(f"{g} kernel {t['kernel']} plain {t['plain']} library {t['library']} "
                      f"bound {t['bound_ms']}; {t['bound_table_twice_ms']}"
                      for g, t in times.items())
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
    maxed = max_phases(device, card, aligned)
    t0 = time.perf_counter()
    streamed = bitstream_phases(device, card, graphs)
    print(f"phases 17-20: {time.perf_counter() - t0:.2f} s", flush=True)

    # 21. the routing ladder on the card
    t0 = time.perf_counter()
    ladder_graphs = {**graphs, **{name: make_graph(name) for name in LADDER_GRAPHS
                                  if name not in graphs},
                     "sbm60k": aligned["sbm"], "stream100k": streamed["hg"]}
    ladder = ladder_phase(device, ladder_graphs)
    print(f"phase 21 ladder (host seconds to plan): {json.dumps(ladder)}", flush=True)
    # 22. the segment-sum kernel against its plain version
    segsum = segsum_phase(device, ladder_graphs)
    for c in segsum["cases"]:
        print(f"phase 22 segment-sum kernel vs plain: {json.dumps(c)}", flush=True)
    for c in segsum["records"]:
        print(f"phase 22 record-routed sum vs plain: {json.dumps(c)}", flush=True)
    print(f"phase 22 incidence_gather_sum backward: {json.dumps(segsum['backward'])}", flush=True)
    # 23. serve and train with no backend= and no plan=
    defaults = default_phases(device, ladder_graphs)
    for name, sv in defaults["served"].items():
        print(f"phase 23 serve {name}, defaults: {json.dumps(sv)}", flush=True)
    for name, t in defaults["trained"].items():
        print(f"phase 23 train {name}, defaults: {json.dumps(t)}", flush=True)
    for name, t in defaults["parity"].items():
        print(f"phase 23 no-dropout parity {name}: {json.dumps(t)}", flush=True)
    # 24. times; 25. the probes
    dtimes = default_times(device, card, ladder_graphs, defaults["problems"])
    probed = probe_phase(device, card)
    print(f"phases 21-25: {time.perf_counter() - t0:.2f} s", flush=True)

    fd_bwd_err = max(max(c["max_abs_err"].values()) for c in bwd)
    timed = {"fused_dense_two_stage": times["20news"], "ell_gather_sum": gather_times["edge F=32"],
             "aligned_band": aligned["band_times"]["edge F=32"],
             "aligned_masked_argmax": maxed["argmax_times"]["edge F=32"],
             "aligned_masked_argsum": maxed["argsum_times"]["vertex F=32"],
             "bitstream_bitmm": streamed["bitmm_times"]["stream100k Ht F=32"],
             "gather_segment_sum": dtimes["segsum_times"]["v2e F=32"],
             "record_routed_dx": maxed["record_times"],
             **probed["times"]}
    dblp_segsum = [defaults["served"]["coauthor_dblp"]["launches"]["segsum"]] + [
        t["launches"]["segsum"] for name, t in defaults["trained"].items()
        if name.startswith("coauthor_dblp")]
    probe_err = {}
    for r in probed["rows"]:
        probe_err[r["kernel"]] = max(probe_err.get(r["kernel"], 0.0), r["max_abs_err"])
    kernels = [{
        "name": "fused_dense_two_stage",
        "route": "cuda",
        "source": "hypergef_tpu_torch/csrc/fused_dense.cu",
        # forward and backward launches of the serving and the pallas training paths
        "launches": served["launches"]["fused_dense"] + trained["20news"]["launches"]["fused"],
        "max_abs_err": max(max(c["max_abs_err"] for c in cases), fd_bwd_err),
        "cuda_kernels_per_call": fd_kernels,
        **{f"{g}_{k}": times[g][key] for g in ("cora", "pubmed_real")
           for k, key in (("ms", "kernel"), ("plain_ms", "plain"), ("library_ms", "library"),
                          ("bound_ms", "bound_ms"))},
        "pubmed_real_bound_table_twice_ms": times["pubmed_real"]["bound_table_twice_ms"],
        "bwd_ms": bwd_times["20news"]["kernel"],
        "bwd_plain_ms": bwd_times["20news"]["plain"],
    }, {
        "name": "ell_gather_sum",
        "route": "cuda",
        "source": "hypergef_tpu_torch/csrc/ell_gather.cu",
        "launches": trained["pubmed_real"]["launches"]["gather"],
        # the ELL level-0 probes with x resident (phase 25)
        "probe_launches": probed["launches"]["ell_gather_sum"],
        "max_abs_err": max([g["max_abs_err"] for g in gathers] + [probe_err["ell_gather_sum"]]),
    }, {
        "name": "aligned_band",
        "route": "cuda",
        "source": "hypergef_tpu_torch/csrc/aligned_band.cu",
        # forward and backward launches of the aligned serving and training paths,
        # sum and max
        "launches": (aligned["served"]["launches"]["band"] + aligned["trained"]["launches"]["band"]
                     + maxed["served"]["launches"]["band"] + maxed["trained"]["launches"]["band"]),
        "max_abs_err": max(b["max_abs_err"] for b in aligned["bands"]),
        "vertex_ms": aligned["band_times"]["vertex F=32"]["kernel"],
        "vertex_plain_ms": aligned["band_times"]["vertex F=32"]["plain"],
        "vertex_library_ms": aligned["band_times"]["vertex F=32"]["library"],
        "vertex_bound_ms": aligned["band_times"]["vertex F=32"]["bound_ms"],
    }, {
        "name": "aligned_masked_argmax",
        "route": "cuda",
        "source": "hypergef_tpu_torch/csrc/aligned_max.cu",
        # the max serving and training paths, and aligned_max_matvec's forward
        "launches": (maxed["served"]["launches"]["argmax"]
                     + maxed["trained"]["launches"]["argmax"] + maxed["matvec"]["argmax_launches"]),
        "max_abs_err": max(a["max_abs_err"] for a in maxed["argmaxes"]),
        # bound_ms reads the live layout, tables_bound_ms the flat tables
        "tables_bound_ms": maxed["argmax_times"]["edge F=32"]["tables_bound_ms"],
        **{f"f4_{k}": maxed["argmax_times"]["edge F=4"][key]
           for k, key in (("ms", "kernel"), ("plain_ms", "plain"), ("bound_ms", "bound_ms"),
                          ("tables_bound_ms", "tables_bound_ms"))},
        "layout_bytes": maxed["layouts"]["sbm60k edge"]["layout_bytes"],
        "layout_build_s": maxed["layouts"]["sbm60k edge"]["layout_build_s"],
    }, {
        "name": "aligned_masked_argsum",
        "route": "cuda",
        "source": "hypergef_tpu_torch/csrc/aligned_max.cu",
        # aligned_max_matvec's backward (the max training path routes its
        # backward through the CSR, as JAX's does)
        "launches": maxed["matvec"]["argsum_launches"],
        "max_abs_err": max(a["max_abs_err"] for a in maxed["argsums"]),
        "tables_bound_ms": maxed["argsum_times"]["vertex F=32"]["tables_bound_ms"],
        **{f"f4_{k}": maxed["argsum_times"]["vertex F=4"][key]
           for k, key in (("ms", "kernel"), ("plain_ms", "plain"), ("library_ms", "library"),
                          ("bound_ms", "bound_ms"), ("tables_bound_ms", "tables_bound_ms"))},
        "layout_bytes": maxed["layouts"]["sbm60k uniform vertex"]["layout_bytes"],
        "layout_build_s": maxed["layouts"]["sbm60k uniform vertex"]["layout_build_s"],
    }, {
        "name": "bitstream_bitmm",
        "route": "cuda",
        "source": "hypergef_tpu_torch/csrc/bitstream.cu",
        # forward and backward launches of the bitstream serving and training paths
        "launches": (sum(s["launches"]["bitmm"] for s in streamed["served"].values())
                     + sum(t["launches"]["bitmm"] for t in streamed["trained"].values())),
        "max_abs_err": max([c["max_abs_err"] for c in streamed["checks"]]
                           + list(streamed["matvec"]["max_abs_err"].values())),
        # the Ht (V→E) stage is the line's own; the H (E→V) stage and F = 4
        # beside it; bound_ms reads the layout, pack_bound_ms the whole pack
        "pack_bound_ms": streamed["bitmm_times"]["stream100k Ht F=32"]["pack_bound_ms"],
        **{f"{pre}{k}": streamed["bitmm_times"][f"stream100k {name}"][key]
           for pre, name in (("h_", "H F=32"), ("f4_", "Ht F=4"), ("h_f4_", "H F=4"))
           for k, key in (("ms", "kernel"), ("plain_ms", "plain"), ("library_ms", "library"),
                          ("bound_ms", "bound_ms"), ("pack_bound_ms", "pack_bound_ms"))},
        "layout_bytes": {n: lay["bytes"] for n, lay in streamed["layouts"].items()},
        "layout_build_s": {n: lay["build_s"] for n, lay in streamed["layouts"].items()},
        "wide_pack_ratio": streamed["unread"]["ratio"],
    }, {
        "name": "gather_segment_sum",
        "route": "cuda",
        "source": "hypergef_tpu_torch/csrc/segment_sum.cu",
        # the cumsum route's serving and training paths on coauthor_dblp (phase 23)
        "launches": sum(dblp_segsum),
        "max_abs_err": max([c["max_abs_err"] for c in segsum["cases"]]
                           + list(segsum["backward"]["max_abs_err"].values())),
        "e2v_ms": dtimes["segsum_times"]["e2v F=32"]["kernel"],
        "e2v_plain_ms": dtimes["segsum_times"]["e2v F=32"]["plain"],
        "e2v_library_ms": dtimes["segsum_times"]["e2v F=32"]["library"],
        "e2v_bound_ms": dtimes["segsum_times"]["e2v F=32"]["bound_ms"],
    }, {
        "name": "record_routed_dx",
        "route": "cuda",
        "source": "hypergef_tpu_torch/csrc/segment_sum.cu",
        # the max backward of the training paths: SBM-60k aligned (phase 15),
        # stream100k bitstream (phase 19), coauthor_dblp cumsum (phase 23)
        "launches": (maxed["trained"]["launches"]["recsum"]
                     + streamed["trained"]["HGNN max"]["launches"]["recsum"]
                     + defaults["trained"]["coauthor_dblp HGNN max"]["launches"]["recsum"]),
        "max_abs_err": max(c["max_abs_err"] for c in segsum["records"]),
        **{f"{g}_{k}": t[key]
           for g, t in (("stream100k", streamed["record_times"]),
                        ("coauthor_dblp", dtimes["record_times"]))
           for k, key in (("ms", "kernel"), ("plain_ms", "plain"), ("library_ms", "library"),
                          ("bound_ms", "bound_ms"))},
    }]
    # the probe kernels: their path is phase 25, the checked call of each case
    for name, source in (("row_gather", "probes.cu"), ("chunk_masked_sum", "probes.cu"),
                         ("scaled_copy", "probes.cu")):
        kernels.append({"name": name, "route": "cuda",
                        "source": f"hypergef_tpu_torch/csrc/{source}",
                        "launches": probed["launches"][name],
                        "max_abs_err": probe_err[name]})
    for k in kernels:
        t = timed[k["name"]]
        sites = KERNEL_SITES.get(k["name"], [RECORD_SUM_SITE])
        k.update({"replaces": sites[0], **({"also_replaces": sites[1:]} if sites[1:] else {}),
                  "ms": t["kernel"], "plain_ms": t["plain"], "bound_ms": t["bound_ms"],
                  "bound_by": t["bound_by"], "library_ms": t.get("library")})
        check(k["launches"] > 0, f"{k['name']} was launched on its path")
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
