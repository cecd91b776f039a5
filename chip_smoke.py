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
   ``plan_pallas_sparse`` plan, at F = 32 and 3 and on an x that starts 4
   bytes past a 16-byte boundary (the kernel's feature-a-lane form):
   bitwise equal, two runs bitwise equal, one launch per call.
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
   ``pallas_sparse`` vs ``tree``; the gather kernel vs its plain loop vs
   ``torch.sparse.mm`` on both level-0 stages at F = 32 and 3; the fused
   dense backward vs its plain formula.
9. Build the clustered SBM-60k graph from raw input as bench.py's clustered
   leg does (generator, shuffle, ``community_reorder(method="coarsen")``)
   and its ``plan_aligned`` plan. The coarsening order runs in the native
   host library (``sparse/native.py``, built by g++ at first use; its
   build seconds apart) and again in NumPy: the two orders must be equal,
   and both host times are printed. Hold the band kernel (``aligned_band``)
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
   ``v2e_max_aligned``'s CSR-routed dx (the record-routed sum).
16. Time, with CUDA events, median of 20 windows: the argmax kernel vs its
   twin (edge stage, F = 32 and 4), the arg-sum kernel vs its twin and one
   ``scatter_add_`` (uniform vertex stage, F = 32 and 4), each beside two
   bounds (over the live layout the kernels read, and over the flat tables
   the earlier design read), the record-routed sum (the max
   backward: the kernel's two passes over SBM-60k's vertex-major CSR and its
   layout, int32 ids, F = 32 and 4) vs its plain twin and its bound, and each arg-sum and
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
   stream100k's vertex-major CSR (int32 ids, as the tree gives them; F = 32
   and 4) vs its twin, ``scatter_add_`` and its bound; the stream100k
   training epoch on ``bitstream``,
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
   each way). Hold the record-routed sum (``record_routed_dx``: pass A
   writes each member's won words through the host layout, pass B sums
   the won values on the segment sum's walk) against its plain twin, at the
   same bar, and bitwise against the sequential CSR-order sum
   (``record_routed_dx_sequential``), on the vertex-major CSRs of
   coauthor_dblp (int32 ids at F = 32, 4, 6 and 33, int64 at F = 3),
   SBM-60k (int32, F = 32) and stream100k (int32 and int64, F = 32), each
   id a member of its edge: repeats bitwise equal, one launch a call (both
   passes); print each graph's layout bytes and host build seconds.
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
   at F = 32; the record-routed sum on coauthor_dblp (int32 ids, F = 32 and
   6) vs its twin, ``scatter_add_`` and its bound; the coauthor_dblp epoch on
   ``cumsum``, ``tree`` and
   ``pallas_sparse``, the cora epoch on ``precomp``, ``dense`` and
   ``pallas``; a request on each; beside the reference's RTX 3090 fused
   kernel times (not a claim).
25. The ports of the TPU probes of ``scripts/`` (``hypergef_tpu_torch.probes``)
   at their scripts' shapes, probe_r2_gather's 2M-row scale included: each
   case against its script's oracle (bitwise for gathers and copies, rtol
   1e-5 for sums) and timed against a library call; the row gather, chunk sum
   and scaled copy kernels against their plain versions; the row gather's
   ring depths at pallas_probe3's take and every form at the 2M-row scale
   against two bounds (distinct rows, every named row); the scaled copy at
   [1,048,576, 128] against its bound, and an empty launch.
26. The compiled step (``hypergef_tpu_torch.utils.graphs``): for each
   training cell of phases 8, 12, 16, 20, 23 and 24, a Trainer with
   ``compiled=False`` against one with ``compiled=True`` from the same
   seeded weights, default dropout: 5 losses bitwise equal; wall and device
   ms a step in turns (eager, captured, captured, eager); the host ms to
   issue one eager step and one replay; the host seconds the recording
   took and the MiB its graph's pool holds (what dropping the graph gives
   back to the card); the captured step's ``epoch_device_time_stats``
   (20 iterations, 5 windows, 3 repeats); the host µs of one route
   dispatch. The plain aligned max form must refuse to be captured
   (CaptureError) and is timed eagerly. For each request cell of phases 3,
   10, 14, 18 and 23: two requests bitwise equal to eager ones, the first
   answer unchanged by the second, wall and device ms in turns, the
   recording's seconds and its graph's MiB. A
   checkpoint round trip: a captured 20news Trainer saves in the
   background, another restores into the tensors its graph reads and goes
   on bitwise.
27. The training CLI (``hypergef_tpu_torch.train.cli``), called in this
   process (each kernel count set to 0 just before a call and read just
   after) and once as ``python -m hypergef_tpu_torch.train.cli``; every file
   it writes goes to a temporary directory. (a) A powerlaw graph at
   coauthor_dblp's dimensions and AllSet's widths (``CLI_DBLP``): the
   ladder's route (``CLI_PICKS``), segment-sum launches, finite losses, a
   CSV row of 9 fields in JAX's order; (b) the same with ``--tune``: a
   sweep, each candidate's time, then a run that reads the record and
   makes none; (c) with ``--plan-cache DIR``: a build, then a load, losses
   bitwise equal, the set-up seconds of each; (d) 5000×3000 with
   ``--backend pallas`` (fused dense launches) and ``--first-aggr max``
   (record-routed sum launches); (e) each of the 13 fixture datasets
   (``tests/fixtures/data``, copied) trained 20 epochs, finite losses; (f)
   each with ``--validate-parity``: exit 0, format and oracle (on the
   card) PASS, shape and accuracy SKIP under the FIXTURE marker; (g) (a)
   with ``--profile``: the device memory in use and at peak, in MiB.
28. The serving export (``serve.export_trainer``, ``ServingModel.load``)
   of six cells, one a forward kernel (``EXPORT_CELLS``), reusing the
   earlier phases' graphs: export, the header read back, a load (captured)
   and an eager load; five requests each, bitwise equal to the built
   server's on the card, captured and eager (a cell that is not is held to
   1e-5·max|ref| and printed with its difference); one eager exported
   request launches what one eager built request launches, each cell's
   kernels at least once, and the two recordings hold the same kernel
   nodes; the artifact's bytes, export, load and capture seconds, and p50,
   p90, p99 request walls (CUDA events, host included) over 50 requests in
   turns with the built server's. Once: a fresh ``python3 -c`` process
   loads the coauthor_dblp artifact and answers, with neither
   ``hypergef_tpu_torch.models`` nor ``.train`` imported; an artifact with
   ``platforms=["cuda", "cpu"]``: its CPU program on the CPU within 1e-3
   of its card program.
29. Minibatch training (``MinibatchTrainer``, the ``cumsum`` route), one
   epoch each of (a) ``experiments/minibatch_bench.py``'s ``dblp_shaped``
   workload at 512 edges a batch and (b) stream100k at 2048, recorded (a
   CUDA graph a pad shape, the counted main path) and eager from the same
   weights and seeds: losses bitwise equal, ``compile_count`` equal to the
   recordings and replays to the batches, 8 segment-sum launches a warm-up
   step and a recording (8 a step eager); pad shapes, each form's
   batches/s, sampler seconds a batch, a step's device and wall ms and its
   peak device memory above what the process held, the recordings' pool
   (and, for (a), a full-batch ``cumsum`` step's peak); each batch's
   ghost-segment length beside its recorded step's device ms; the mean
   loss of the last batches below that of the first; on the last batch,
   the segment sum over the pad shape's runs (padded to ``max_warp_runs``)
   bitwise equal to the launch over the batch's exact runs and to the
   plain version, both CSRs, F = 32 and the classes, each timed beside
   one ``torch.sparse.mm`` of the batch's CSR (the library yardstick);
   ``evaluate_full``'s accuracies; with dropout 0, three batches' losses on
   the card within rtol 1e-4 of the same batches on the CPU; for (a), a
   batch of every edge gives the full-graph forward's log-probs on its
   real rows within 1e-5·max|ref|.
30. Distributed training (``hypergef_tpu_torch.parallel``), four ranks of
   a gloo world sharing the card (their times are not a scaling figure):
   (a) the CLI's ``--shards 4 --dist-backend gloo`` on coauthor_dblp's
   dimensions for HGNN sum and max, UniGIN and UniGCNII (eager steps: each
   gloo rank says so), the losses within 1e-3 of a one-rank nccl world of
   the same ``DistTrainer``, whose recorded fit (10 + 20 epochs: the
   collectives, tree stages, fixed-order sums, the record-routed sum for
   max and Adam in one CUDA graph) is bitwise equal to its eager fit and
   whose initial loss is within 1e-3 of a plain forward's, and the max
   run's record-routed sum launched in every rank; (b) the halo world on SBM-60k
   with the aligned interior (asserted taken): sum and max aggregations
   and one HGNN step against the single-device aligned kernel route (JAX's
   halo bars: 5e-3·max forward, 1e-2·max gradients, rtol 0.05 on the
   weights' gradients), and in each rank the band (1e-5), argmax (bitwise)
   and arg-sum (1e-6) kernels against their twins on its own stages; (c)
   the dense shard on 20news against the ``dense`` route (1e-2·max); (d)
   ``DPMinibatchTrainer`` on dblp_shaped, two eager steps of four gloo
   ranks against the unsharded step on the same batches (1e-3), and two
   recorded steps of one nccl rank (in (a)'s world) bitwise equal to its
   eager ones. Each world prints its start-up and
   end (``launch.last_world``), a rank's step time, peak MiB and launches,
   and the bytes a halo layer sends; the ranks' launches join the kernels
   line as ``dist_launches``. A failed rank fails the phase.
31. The serialized halo pair and the feature mesh axis: (a) phase 30
   (b)'s plan and x run one shard at a time on the card
   (``serialized_halo_forward``), sum and max, bitwise equal to that
   world's outputs (else within 1e-6·max, the gap and the differing owner
   blocks printed); (b) ``serialized_halo_train_step`` on SBM-60k's tree
   and aligned plans against the plain step over ``ops/refops.py`` on the
   same weights, two runs bitwise equal, and three AdamW epochs against
   the same epochs unsharded (the ``SERIAL_*`` bars); (c)
   ``community_hypergraph`` at 2.5M incidences (its graph and plan built
   first, with nothing beside them), D = 8, aligned: a forward and a step,
   each shard's host build, staging and device times, the exchange bytes,
   the card's peak (forward and step) below ``serial_halo.peak_bound`` and
   below all shards' tables together, and both against the plain forward
   and step. In (a), (b) and (c), after the counted runs, each shard's
   kernels against their twins on its tables as a turn holds them, at the
   widths 32 and 8 of the step's two layers (``check_turn_kernels``): the
   band kernel over the V→E and E→V tables (1e-5), the argmax (bitwise)
   and the segment sum on every inverse table of the turn; (d) a 2 x 2 ``(e, f)`` grid of
   four gloo ranks: the CLI's ``--shards 2 --feature-shards 2`` (HGNN sum
   and max) against phase 30 (a)'s one-rank nccl world, and the
   feature-sharded dense shard on 20news against the ``dense`` route, with
   the record-routed sum against its twin in every rank at the column
   widths 16 and 3. Its launches join the kernels line as
   ``serial_launches``.
32. The experiment drivers on the card (``hypergef_tpu_torch/experiments``),
   each ``main`` in process at the drivers' widths and a reduced depth
   (``DRIVER_*``), its CSV opening with the card's row: (a)
   fig7_9_realistic on cora, pubmed, coauthor_dblp, ModelNet40,
   20newsW100 and Mushroom, each timed route held against the ``xla``
   route's output on the same x before its timing (1e-3·max|xla| for the
   f32 routes, 3e-2 for the routes that round to bf16), the auto column
   equal to JAX's pick after the same pipeline (``REALISTIC_PICKS``), and
   each FLOOR (the floor model at the card's rates) printed beside the
   band kernel's bound of the same stage (``band_bound``, PERF.md §6 row
   4); (b) auto_matrix on its five workloads, every applicable fixed route
   timed and held against ``xla`` at the same bars, the ladder's picks of
   the graphs of phase 21 equal to ``LADDER_PICKS``; (c) fig10 on 20news
   at ngs 4-128, the ``tree`` route held against ``xla`` at each ngs;
   (d) fig6 ``--quick`` on cora, coauthor_dblp and 20newsW100, HGNN nhid
   32: every row finite and captured, no ``FAILED``; (e) serve_bench on
   cora_shaped, parity under 1e-4; (f) minibatch_bench on dblp_shaped,
   ``--epochs 30``, at most 3 recordings. Its launches join the kernels
   line as ``driver_launches``; the run's seconds are printed before that
   line.
33. The scale drivers on the card, each ``main`` in process at a reduced
   depth (``SCALE_*``), its CSV opening with the card's row: (a)
   clustered_e2e on SBM-60k, ``aligned`` in the kernel form (the band
   kernel), ``tree`` and ``cumsum``, each route's test accuracy above
   chance; (b) scale_aligned on pubmed_clustered, the kernel form and the
   tree; (c) dense_shard_scale at its own size, the D = 2 and 8 slices'
   partials summed against ``xla``; (d) scale_projection on one shard of 1M
   incidences; (e) scale_serialized at 1M incidences, D = 4, with
   ``--epoch``: its output finite, its initial loss within
   ``SCALE_LOSS_SPREAD`` of ln(8); (f) minibatch_scale at about 1.5M
   incidences: its full-batch row, recorded steps, at most 3 recordings;
   (g) weak_scaling at D = 1, 2, 4 and (h) halo_overlap at D = 2, 4, 20,000
   incidences a shard, the taint walk's ``chain_ok`` on every row. Every
   route a driver times is held against the ``xla`` route's output within
   its bar; every link term is a model (MODELED in its row). Its launches
   join the kernels line as ``scale_launches``.
34. The ``ell``, ``bsr`` and ``multihot`` routes (``routes_phase``): (a)
   clustered_bench at its defaults (SBM-60k with sorted hyperedges and the
   random graph of its size, F = 32), ``ROUTES_ITERS`` calls a timed
   window: every route held against ``xla``
   (1e-3·max|xla| for the f32 routes, 3e-2 for the bf16 ones), the six
   multihot forms on each graph, the card's fastest route printed beside
   the ladder's pick; (b) HGNN on phase 9's SBM-60k at bench.py's
   clustered shape (100 features, 4 classes, nhid 32, 2 layers, sum) on
   ``bsr``, ``multihot``, ``multihot_precomp`` and ``ell``
   (``ROUTE_CELLS``): 20 captured steps counted (8 gathers and 8 segment
   sums a step on ``ell``, no kernel on the block and tile products),
   captured losses bitwise equal to eager with a step of each timed,
   no-dropout losses against ``xla`` (``ROUTE_LOSS_RTOL``), one request
   counted and held against the plain version on CPU tensors within 1e-2
   (``route_reference_plan``; ``ell`` also within 1e-3 of ``xla``), each
   plan's host seconds and device MiB; (c) HGNN max on ``multihot``: its output
   bitwise equal to the argmax tree's V→E followed by the multihot plan's
   own E→V stages, within 3e-2·max|xla|, 20 steps (2 record sums a step)
   and its losses against ``xla``; (d) the ELL gather and segment-sum
   launches of the ``ell`` route's paths. Its launches join the kernels
   line as ``routes_launches``.
35. The packed-int4 dense incidence (``packed_phase``): (a) the fused
   kernel's packed form on the nibble carrier
   (``DenseIncidence(packed=True)``) bitwise equal to the int8 form on the
   same operands at phase 2's shapes (pubmed_real F = 32, odd E; 20news F
   = 32, 4, 100; cora F = 32, 7) and on a 20news table whose counts reach
   7, within phase 2's bar of its plain twin, two runs bitwise equal, one
   count a call on ``packed_launches``; (b) one CUDA kernel a call and a
   packed V→E phase under ``torch.profiler`` (in this process, through
   ``utils/profiling.py::profiler``, which detaches CUPTI at each stop: a
   session kept attached late in a long process saw no device events),
   and a call's peak device memory growing by its output and
   scratch alone, less than the int8 table's bytes (no [N, E] table is
   made); (c) the backward
   (dx, d scale_e, d scale_v: the packed op twice, the packed V→E phase
   twice) bitwise the int8 form's; (d) 20 captured ``Trainer`` steps on
   20news/``pallas`` (4 packed launches a step) and pubmed_real/``dense``
   (no kernel: the library products on the unpacked table) on a packed
   plan, losses bitwise the int8 plan's; (e) 5 requests from a built
   ``ServingModel`` on the 20news packed plan and from its export,
   bitwise equal to each other and to the int8 plan's server; (f) the
   packed dense shard: ``local_two_stage`` on each slice of a D = 4 plan of
   pubmed_real, forward and backward, bitwise the unpacked plan's; (g) the
   packed kernel's times against the int8 kernel's, its plain twin (the
   unpack and the plain form), the two library products and its bound (the
   carrier read twice, x, the scales and the output) at F = 32 on 20news,
   cora and pubmed_real, and both tables' device MB. Its paths' launches
   are the kernels line's ``fused_dense_two_stage_packed`` row.
36. The op-level counts and the profiler (``profiling_phase``,
   ``hypergef_tpu_torch/utils/profiling.py``): (a) fig8 at cora and
   pubmed on the card and on the CPU, JAX's route set, each route's card
   count beside its CPU count (counts, not times); (b) ``cost_analysis`` of
   one eager training step each of 20news/``pallas``, coauthor_dblp/
   ``cumsum`` and SBM-60k/``aligned`` (kernel form): its kernel ops equal
   the launches the step made, counter by counter, and each kernel op's
   count equals the same step's count on the CPU; (c) five profiler
   sessions late in this process, each seeing the fused dense kernel and
   followed by a recorded 20news ``pallas`` fit bitwise equal to the eager
   one, the last session through ``trace``, whose trace file holds the
   kernel. Its launches are read for its own checks, not added to the
   kernels line.

Phases 1-25 drive the default step and request: on the card a CUDA-graph
replay (``Trainer``'s and ``ServingModel``'s ``compiled=None``); the plain
aligned max form and the references the phases compare against run
eagerly. A wrapper counts where it launches its kernel: each eager call,
and once when a graph records it; a replay calls no wrapper. So a path's
counts are set to 0 before its server is built or its steps begin (the
recording inside that span) and checked exactly, and a recorded graph,
written as a DOT file (``graphs.DUMP_DIR``, set for phases 1-25), must
hold the same launches a request or a step as kernel nodes: what each of
its replays launches (``replayed`` in a path's line).

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
import gc
import itertools
import json
import subprocess
import sys
import time

import numpy as np
import torch

# the kernel bounds: each function's bytes (each input read once, each
# output written once) over the H100 SXM's memory rate, or its operations
# over the f32 rate or, for the band kernel's tile products, the dense bf16
# tensor-core rate, whichever is longer (NVIDIA's data sheet, 700 W)
from hypergef_tpu_torch.utils.profiling import (
    band_bound, bound, max_bounds, nbytes, rows_read_bytes, stage_table_bytes,
)
from hypergef_tpu_torch.utils.rates import H100_F32_OPS_PER_S, H100_STREAM_BPS

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
# a kernel's form that replaces the same pl.pallas_call as another: the
# packed-int4 form of the fused kernel, the pallas_call that JAX's
# _unpack_bf16 feeds from the nibble carrier (pallas_kernels.py:40-56)
SITE_OF_FORM = {"fused_dense_two_stage_packed": "fused_dense_two_stage"}
# the record-routed sum replaces no pl.pallas_call: JAX computes the max
# backward with XLA ops (gathers, a compare, a segment sum)
RECORD_SUM_SITE = "hypergef_tpu/ops/maxops.py:106"
REQUESTS = 5
TRAIN_STEPS = 20
PARITY_EPOCHS = 10
COMPILED_EPOCHS = 5
# the reference's HGNN inference and training epochs on 20news, RTX 3090
# (BASELINE.md:41)
REF_RTX3090_INFER_MS = 0.395
REF_RTX3090_EPOCH_MS = 1.471
# phase 27, the training CLI: coauthor_dblp's dimensions and AllSet's widths
# on a powerlaw graph, and a small one; the ladder's pick for each
# (powerlaw_hypergraph at the CLI's seed 1; JAX's plan_aggregation,
# held against JAX by tests/test_torch_port_cli.py); the CSV row's fields
# (hgsys.py:207-211)
CLI_DBLP = ["--synthetic", "powerlaw", "--n", "41302", "--e", "22363", "--feat", "1425",
            "--classes", "6", "--nhid", "32", "--nlayer", "2", "--epochs", "20"]
CLI_5K = ["--synthetic", "powerlaw", "--n", "5000", "--e", "3000", "--epochs", "20"]
CLI_PICKS = {"coauthor_dblp": "cumsum", "5000x3000": "precomp"}
CLI_ROW = ("backend", "model", "dname", "nlayer", "nhid", "nhead", "first_aggr",
           "train_epoch_time_s", "inference_time_s")


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


def make_graph(name: str):
    from hypergef_tpu_torch.data.synthetic import random_hypergraph

    g = LADDER_GRAPHS[name]
    return random_hypergraph(g["n"], g["e"], avg_edge_size=g["avg"], seed=0, name=name)


def kernel_operands(hg, f: int, seed: int, device, h=None):
    """(h, x, scale_e, scale_v) as the pallas route passes them, with a
    random wdiag folded into scale_e; ``h`` built here unless given."""
    from hypergef_tpu_torch.sparse.planner import DenseIncidence

    rng = np.random.default_rng(seed)
    hgd = hg.device_data(device)
    if h is None:
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
    from hypergef_tpu_torch.utils.profiling import device_events, profiler

    fn()
    torch.cuda.synchronize()
    with profiler() as prof:
        fn()
        torch.cuda.synchronize()
    return len(device_events(prof))


# each hand-written kernel's name in a recorded graph, and the counters
# (``kernel_counters``' names) whose every launch runs it once
GRAPH_KERNELS = {
    "fused_dense_kernel": ("fused", "fused_packed"), "ell_gather_sum_kernel": ("gather",),
    "aligned_band_kernel": ("band",), "aligned_max_kernel": ("argmax", "argsum"),
    "bitmm_kernel": ("bitmm",), "segment_sum_kernel": ("segsum",),
    "record_sum_kernel": ("recsum",), "row_gather_": ("row_gather",),
    "chunk_sum_": ("chunk_sum",), "scaled_copy_kernel": ("scaled_copy",),
}


def graph_kernels(captured) -> dict:
    """For each kernel of ``GRAPH_KERNELS``, its nodes in ``captured``'s
    recording: what each replay launches. The recording's DOT file
    (``graphs.DUMP_DIR``) has a line for each kernel node, naming it."""
    with open(captured.dot) as f:
        lines = f.read().splitlines()
    return {kernel: sum(kernel in line for line in lines) for kernel in GRAPH_KERNELS}


def check_replays(where: str, nodes: dict, counters, per: dict, replays: int) -> dict:
    """Each kernel of ``counters`` (names of ``kernel_counters``) has
    ``per[name]`` nodes in a recording (``nodes``, from
    :func:`graph_kernels`); returns the launches ``replays`` replays made."""
    for kernel, n in nodes.items():
        if any(c in GRAPH_KERNELS[kernel] for c in counters):
            want = sum(per.get(c, 0) for c in GRAPH_KERNELS[kernel])
            check(n == want, f"{where}: the recording holds {n} {kernel} nodes, want {want}")
    return {kernel: replays * n for kernel, n in nodes.items() if n}


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
          nclass=NCLASS, xla_atol=None, requests=REQUESTS) -> dict:
    """``requests`` requests through ``backend`` (None: ``TrainConfig``'s default,
    no ``backend=``). ``counters`` maps a kernel's name to (module, counter
    attribute, launches a request); every count is set to 0 just before the
    server is built (a captured server records its forward there) and read
    just after the requests. A captured server's recording must hold each
    kernel's launches a request as nodes, which every replay launches.
    Each answer is checked against the same model on the kernels' plain
    versions (``plain_plan`` on ``plain_device``), or on ``ref_backend`` if
    given, within ``ref_atol``, and on the f32 segment-reduce route: argmax
    agreement, and with ``xla_atol`` the log-probs within ``xla_atol`` of
    it."""
    from hypergef_tpu_torch.data.synthetic import random_features
    from hypergef_tpu_torch.serve import ServingModel
    from hypergef_tpu_torch.train.trainer import TrainConfig
    from hypergef_tpu_torch.utils.timing import cuda_time_ms

    cfg = TrainConfig(model=model, nhid=32, nlayer=2, first_aggr=first_aggr)
    if backend is not None:
        cfg = dataclasses.replace(cfg, backend=backend)
    feats = [random_features(hg.num_nodes, nfeat, nclass, seed=100 + i)[0]
             for i in range(requests)]
    xs = [torch.as_tensor(a, device=device) for a in feats]
    torch.cuda.synchronize()

    for module, attr, _ in counters.values():
        setattr(module, attr, 0)
    server = ServingModel(cfg, hg, nfeat, nclass, device, plan=plan)
    answers = [server.predict(x) for x in xs]
    torch.cuda.synchronize()
    launches = {name: getattr(module, attr) for name, (module, attr, _) in counters.items()}
    # the wrappers ran for each eager request, or for the captured server's
    # warm-up forward and its recording, whose every replay launches the
    # recording's kernel nodes again
    calls = 2 if server.compiled else requests
    for name, (_, _, per_request) in counters.items():
        check(launches[name] == calls * per_request,
              f"{calls} forwards launched {name} {calls * per_request} times, "
              f"got {launches[name]}")
    replayed = {}
    if server.compiled:
        replayed = check_replays(
            "the request graph", graph_kernels(server._graph), counters,
            {name: per for name, (_, _, per) in counters.items()}, requests)

    params = {k: v.detach().cpu() for k, v in server.model.state_dict().items()}
    ref_cfg = dataclasses.replace(cfg, backend=ref_backend or cfg.backend)
    # the references answer eagerly (the plain aligned max form cannot be captured)
    plain = ServingModel(ref_cfg, hg, nfeat, nclass, plain_device, params=params, plan=plain_plan,
                         compiled=False)
    xla = ServingModel(dataclasses.replace(cfg, backend="xla"), hg, nfeat, nclass, device,
                       params=params, compiled=False)

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
            "replayed": replayed, "compiled": server.compiled, "worst": worst,
            "request_ms": request_ms}


def fused_route(backend, plan, hg) -> str:
    """The route a call with ``backend`` and ``plan`` takes on ``hg``."""
    from hypergef_tpu_torch.ops import fused

    return fused.resolve_backend(backend, plan, hg.nnz)


def check_gather(table, f: int, seed: int, device, aligned: bool = True) -> dict:
    """The gather kernel against its sequential plain loop: bitwise. x is
    16-byte aligned, or a view 4 bytes past an aligned start."""
    from hypergef_tpu_torch.ops import ell_gather

    rng = np.random.default_rng(seed)
    xn = torch.as_tensor(rng.normal(size=(table.num_inputs, f)).astype(np.float32))
    x = torch.empty(xn.numel() + (0 if aligned else 1), device=device)[
        0 if aligned else 1:].view(xn.shape)
    x.copy_(xn)
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
            "n": table.num_inputs, "f": f, "aligned": aligned,
            "schedule": ell_gather.gather_schedule(f, int(table.gidx.shape[1]),
                                                   x.data_ptr() % 16 == 0)._asdict(),
            "max_abs_err": err}


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

    return {"fused": (fused_dense, "launches"),
            "fused_packed": (fused_dense, "packed_launches"),
            "gather": (ell_gather, "launches"),
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
                ("HGNN", "precomp", "sum"): {}, ("HGNN", "dense", "sum"): {},
                # phase 34: the block and tile products are library calls;
                # the ell route's stages are a gather and a segment sum each
                ("HGNN", "bsr", "sum"): {}, ("HGNN", "multihot", "sum"): {},
                ("HGNN", "multihot", "max"): {"recsum": 2},
                ("HGNN", "ell", "sum"): {"gather": 8, "segsum": 8}}
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
        per = per_step[cfg.model, route, cfg.first_aggr]
        # the wrappers ran for each eager step, or for the captured step's
        # eager warm-up steps and its recording, whose every replay
        # launches the recording's kernel nodes again
        calls = res["capture_warmup"] + 1 if res["step"] == "captured" else TRAIN_STEPS
        want = {k: calls * per.get(k, 0) for k in counters}
        check(launched == want, f"{name}: {calls} step calls launched {launched}, want {want}")
        replayed = {}
        if res["step"] == "captured":
            (step,) = tr._steps.values()
            replayed = check_replays(f"{name}'s step graph", graph_kernels(step), counters,
                                     per, TRAIN_STEPS)
        check(bool(np.isfinite(res["losses"]).all()), f"{name}: finite losses")
        out[name] = {"model": cfg.model, "backend": cfg.backend, "route": route,
                     "first_aggr": cfg.first_aggr, "step": res["step"],
                     "capture_s": res["capture_s"],
                     "launches": launched, "replayed": replayed,
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
    """Losses of PARITY_EPOCHS no-dropout epochs of ``run`` (the default step:
    captured on the card) and ``ref`` (eager), each (cfg, plan, device), from
    the same seeded weights: within ``rtol``, and the first (the forward
    before any update) within ``first_rtol`` if given."""
    from hypergef_tpu_torch.train.trainer import Trainer

    hg, x, y, split = problem
    got, want = (Trainer(cfg, hg, x, y, plan=plan, device=dev, compiled=compiled).fit(
        split["train"], epochs=PARITY_EPOCHS, warmup=0)["losses"]
        for (cfg, plan, dev), compiled in ((run, None), (ref, False)))
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
    the seconds of the reorder and of the plan. The coarsening order runs in
    the native host library (the default), once more in NumPy, and the two
    orders must be equal; the library's build seconds are apart."""
    from hypergef_tpu_torch.data.synthetic import community_hypergraph
    from hypergef_tpu_torch.sparse import native
    from hypergef_tpu_torch.sparse.planner import plan_aligned
    from hypergef_tpu_torch.sparse.reorder import apply_vertex_order, community_order

    hg = community_hypergraph(**SBM60K)
    perm = np.random.default_rng(7).permutation(hg.num_nodes)
    hg, _ = apply_vertex_order(hg, perm, sort_edges=False)  # raw order
    t0 = time.perf_counter()
    native.load_library()
    native_build_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    order = community_order(hg, method="coarsen")
    reorder_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    order_numpy = community_order(hg, method="coarsen", use_native=False)
    reorder_numpy_s = time.perf_counter() - t0
    check(np.array_equal(order, order_numpy), "SBM-60k: the native coarsening order equals "
          "the NumPy one")
    hg, _ = apply_vertex_order(hg, order)  # community_reorder's graph
    t0 = time.perf_counter()
    plan = plan_aligned(hg)
    plan_s = time.perf_counter() - t0
    info = {"graph": "sbm60k", "n": hg.num_nodes, "e": hg.num_edges, "nnz": hg.nnz,
            "reorder_s": reorder_s, "reorder_numpy_s": reorder_numpy_s,
            "orders_equal": True, "native_build_s": native_build_s, "plan_s": plan_s}
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
    out.update(band_bound(stage, f))
    # beside it, the time of the same function's operations on the f32
    # pipes, a multiply-add a feature for each non-zero count only
    out["live_f32_ops_ms"] = 2 * stage_live(stage) * f / H100_F32_OPS_PER_S * 1e3
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
    record_times = time_record(sbm.device_data(device), (32, NCLASS), device, torch.int32)
    mcfg = problems["sbm60k max"][0]
    trainers = {
        "aligned kernel": Trainer(mcfg, hg, x, y, plan=plan, device=device),
        "tree + aligned kernel": Trainer(
            mcfg, hg, x, y, plan=AggregationPlan(tree=plan_tree(hg), aligned=al_kernel),
            device=device),
        # the plain aligned max form reads the device from the host: eager only
        "aligned plain": Trainer(mcfg, hg, x, y, plan=AggregationPlan(aligned=al_plan),
                                 device=device, compiled=False),
    }
    epoch_order = ("aligned plain", "aligned kernel", "tree + aligned kernel",
                   "tree + aligned kernel", "aligned kernel", "aligned plain")
    epochs = time_steps(trainers, split["train"], epoch_order, device)
    print(f"phase 16 times (ms, CUDA events, median of 20): card {card}; SBM-60k max training "
          f"epoch (wall: 10 back-to-back steps, host included; device: behind a queued "
          f"sleep): {json.dumps(epochs)}; argmax kernel vs plain twin: "
          f"{json.dumps(argmax_times)}; arg-sum kernel vs plain twin vs scatter_add_, uniform "
          f"vertex stage: {json.dumps(argsum_times)}; record-routed sum vs plain twin, vertex-major "
          f"CSR, int32 ids: {json.dumps(record_times)}; HGNN max request on SBM-60k, "
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
    want = segment_sum.record_routed_dx_plain(cot, arg, hgd.record)
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
    record_times = time_record(hg.device_data(device), (32, NCLASS), device, torch.int32)
    print(f"phase 20 times (ms, CUDA events, median of 20): card {card}; stream100k training "
          f"epoch (wall: 10 back-to-back steps, host included; device: behind a queued "
          f"sleep): {json.dumps(epochs)}; bitmm kernel vs plain twin vs torch.sparse.mm, "
          f"bound over the layout and over the whole pack: {json.dumps(bitmm_times)}; "
          f"record-routed sum vs plain twin vs scatter_add_, vertex-major CSR, "
          f"int32 ids: {json.dumps(record_times)}; request on stream100k, bitstream: "
          f"{json.dumps(requests)}", flush=True)
    return {"checks": checks, "matvec": matvec, "served": served, "trained": trained,
            "parity": parity, "bitmm_times": bitmm_times, "record_times": record_times,
            "epochs": epochs, "hg": hg, "layouts": info["layouts"], "unread": unread,
            "bits": bits, "tree": tree, "configs": configs, "problem": (x, y, split)}


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
                     "built": [f for f in ("dense", "precomp", "aligned", "bitstream", "multihot")
                               if getattr(plan, f) is not None], "plan_s": secs}
    return out


def segment_operands(table, f: int, seed: int, device):
    return torch.as_tensor(np.random.default_rng(seed).normal(size=(table.num_inputs, f))
                           .astype(np.float32), device=device)


def check_segsum(table, f: int, seed: int, device, x=None) -> dict:
    """The segment-sum kernel against its plain version: rtol 1e-6, atol
    1e-6·max|plain| (the same f32 terms, summed by the kernel in CSR order
    and by segment_reduce in its own); two runs bitwise equal; one launch a
    call. ``x`` (the operand rows, [num_inputs, f]) is drawn from ``seed``
    when None."""
    from hypergef_tpu_torch.ops import segment_sum

    if x is None:
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
    """The record-routed sum against its plain twin over ``hgd.record``: rtol
    1e-6, atol 1e-6·max|plain| (the same f32 terms, zeros where an id
    differs, in another order), and bitwise against the sequential CSR-order
    sum; two runs bitwise equal; one launch a call (its two passes)."""
    from hypergef_tpu_torch.tools.segment_sum_ab import record_operands

    g, arg = record_operands(hgd, f, seed, device, dtype)
    return {**check_record_sum(g, arg, hgd.record), "ids": str(dtype).split(".")[-1]}


def check_record_sum(g, arg, record) -> dict:
    """check_record's checks of ``record_routed_dx(g, arg, record)``."""
    from hypergef_tpu_torch.ops import segment_sum

    table = record.e2v
    f = g.shape[1]
    before = segment_sum.record_launches
    got = segment_sum.record_routed_dx(g, arg, record)
    again = segment_sum.record_routed_dx(g, arg, record)
    torch.cuda.synchronize()
    check(segment_sum.record_launches == before + 2, "one record-sum launch per call")
    want = segment_sum.record_routed_dx_plain(g, arg, record)
    scale = float(want.abs().max())
    torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6 * scale)
    check(torch.equal(got, again), "two record-sum runs are bitwise equal")
    seq = segment_sum.record_routed_dx_sequential(g, arg, record)
    check(torch.equal(got.view(torch.int32), seq.view(torch.int32)),
          "the record sum is bitwise the sequential CSR-order sum")
    return {"s": table.num_segments, "n": table.num_inputs, "nnz": table.nnz, "f": f,
            "max_abs_err": float((got - want).abs().max()), "max_abs_plain": scale,
            "nonzero_share": float((want != 0).float().mean()), "bitwise_sequential": True, "layout_bytes": record.layout.nbytes,
            "layout_build_s": record.layout.build_s}


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


def time_record(hgd, widths, device, dtype) -> dict:
    """The record-routed sum's kernel, plain twin and, where the ids allow,
    one ``scatter_add_`` (the library yardstick) in turns, at each width
    F of ``widths``; the bound moves the rows of g and arg the CSR names,
    its int32 gather and row pointer, and the output once, with a compare
    and an add a feature for each entry (the function's, unchanged since
    the masked form of the sum: the layout's own bytes are given beside
    it)."""
    from hypergef_tpu_torch.ops import segment_sum
    from hypergef_tpu_torch.tools.segment_sum_ab import record_operands

    record = hgd.record
    table = record.e2v
    out = {}
    for f in widths:
        g, arg = record_operands(hgd, f, 27, device, dtype)
        fns = {"kernel": lambda: segment_sum.record_routed_dx(g, arg, record),
               "plain": lambda: segment_sum.record_routed_dx_plain(g, arg, record)}
        library, why = scatter_yardstick(g, arg, table.num_segments, fns["plain"]())
        order = ("plain", "kernel", "kernel", "plain")
        if library is not None:
            fns["library"] = library
            order = ("plain", "kernel", "library", "library", "kernel", "plain")
        t = time_turns(fns, order)
        t["library"] = t.get("library")
        if why:
            t["library_note"] = why
        read = rows_read_bytes(g, table.gather) + rows_read_bytes(arg, table.gather)
        t.update(bound(read + nbytes(table.gather, table.indptr) + table.num_segments * f * 4,
                       2 * table.nnz * f))
        t["layout_bytes"] = record.layout.nbytes
        out[f"F={f}"] = t
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
                   ("coauthor_dblp", 32, torch.int32), ("coauthor_dblp", 4, torch.int32),
                   ("coauthor_dblp", 6, torch.int32), ("coauthor_dblp", 3, torch.int64),
                   ("coauthor_dblp", 33, torch.int32), ("sbm60k", 32, torch.int32),
                   ("stream100k", 32, torch.int32), ("stream100k", 32, torch.int64)])]
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
    record_times = time_record(dblp.device_data(device), (32, DBLP_NCLASS), device, torch.int32)
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
          f"int32 ids: {json.dumps(record_times)}; training "
          f"epoch (wall: 10 back-to-back steps, host included; device: behind a queued sleep): "
          f"{json.dumps(epochs)}; requests (host included): {json.dumps(requests)} (reference's "
          f"RTX 3090 fused kernel at F=32, not a claim: {json.dumps(REF_RTX3090_FUSED_MS)})",
          flush=True)
    return {"segsum_times": segsum_times, "record_times": record_times, "epochs": epochs,
            "requests": requests}


def time_probe_kernels(device) -> dict:
    """Each probe kernel against its plain version and a library call at a
    probe's shapes: the row gather at pallas_probe3's flat take (85,024 rows
    of [19,717, 32]; direct, and each ring depth beside it), the chunk sum
    at its e_call ([10,628, 8, 32]), the scaled copy at probe_r2b_bisect's
    k0 ([1024, 128]) and at [1,048,576, 128] (512 MiB each way, where bytes
    rule), and an empty launch (``torch.cuda._sleep(0)``): the floor of any
    launch, which k0's copy cannot beat."""
    from hypergef_tpu_torch import probes
    from hypergef_tpu_torch.utils.timing import cuda_time_ms

    rng = np.random.default_rng(0)
    x = torch.as_tensor(rng.normal(size=(19717, 32)).astype(np.float32), device=device)
    idx = torch.as_tensor(rng.integers(0, 19717, size=85024).astype(np.int32), device=device)
    idx_long = idx.long()
    g = torch.as_tensor(rng.normal(size=(10628, 8, 32)).astype(np.float32), device=device)
    m = torch.as_tensor((rng.random((10628, 8)) > 0.2).astype(np.float32), device=device)
    x0 = torch.as_tensor(rng.normal(size=(1024, 128)).astype(np.float32), device=device)
    big = torch.as_tensor(rng.normal(size=(1_048_576, 128)).astype(np.float32), device=device)
    order = ("plain", "kernel", "library", "library", "kernel", "plain")
    rings = {f"ring_n_buf{nb}": lambda nb=nb: probes.row_gather(x, idx, nb)
             for nb in probes.RING_DEPTHS}
    out = {
        "row_gather": time_turns({"kernel": lambda: probes.row_gather(x, idx),
                                  "plain": lambda: probes.row_gather_plain(x, idx),
                                  "library": lambda: x.index_select(0, idx_long), **rings},
                                 order[:3] + tuple(rings) + tuple(rings)[::-1] + order[3:]),
        "chunk_masked_sum": time_turns({
            "kernel": lambda: probes.chunk_masked_sum(g, m),
            "plain": lambda: probes.chunk_masked_sum_plain(g, m),
            "library": lambda: torch.einsum("cgf,cg->cf", g, m)}, order),
        "scaled_copy": time_turns({"kernel": lambda: probes.scaled_copy(x0, 2.0),
                                   "plain": lambda: x0 * 2.0,
                                   "library": lambda: torch.mul(x0, 2.0)}, order),
    }
    large = time_turns({"kernel": lambda: probes.scaled_copy(big, 2.0),
                        "plain": lambda: big * 2.0,
                        "library": lambda: torch.mul(big, 2.0)}, order, iters=2)
    out["row_gather"].update(bound(rows_read_bytes(x, idx) + nbytes(idx) + idx.shape[0] * 32 * 4,
                                   0))
    out["chunk_masked_sum"].update(bound(nbytes(g, m) + 10628 * 32 * 4, 2 * g.numel()))
    out["scaled_copy"].update(bound(2 * nbytes(x0), x0.numel()))
    out["scaled_copy"].update({f"large_{k}": v for k, v in
                               {**large, **bound(2 * nbytes(big), big.numel())}.items()})
    out["scaled_copy"]["empty_launch_ms"] = cuda_time_ms(lambda: torch.cuda._sleep(0),
                                                         repeats=20, iters=10)
    return out


def r2_gather_bound() -> dict:
    """The bound of probe_r2_gather's flat row gather at its 2M-row scale
    (the probe's own table, flattened: 9,998,336 rows of a [2,000,000, 32]
    x): the distinct rows named, each read once, with the index read and
    the output written once; beside it ``bound_named_ms``, every named row
    read once, which a gather of an x larger than the L2 can reach."""
    from hypergef_tpu_torch import probes

    n, nnz, f = probes.R2_SCALES["big"]
    gidx = np.random.default_rng(0).integers(0, n, size=(nnz // probes.NGS, probes.NGS))
    rest = nnz * 4 + nnz * f * 4
    out = bound(int(np.unique(gidx).size) * f * 4 + rest, 0)
    out["bound_named_ms"] = (nnz * f * 4 + rest) / H100_STREAM_BPS * 1e3
    return out


def r2_chunk_sum_bounds() -> dict:
    """The bound of probe_r2_gather's chunk sums (its ELL stage, on the gather
    kernel or through the ring) at each of its scales, from the probe's own
    tables (``probes.probe_r2_gather``'s draw): the distinct x rows the gather
    names (masked slots too: a 0 times Inf is NaN), the index and mask tables
    and the output, each moved once; a multiply-add a slot and feature. Beside
    it ``bound_named_ms``: every named row read once, which a gather reaches
    where x exceeds the L2 (the 2M-row scale's 256 MB against 50 MB)."""
    from hypergef_tpu_torch import probes

    out = {}
    for scale, (n, nnz, f) in probes.R2_SCALES.items():
        c = nnz // probes.NGS
        gidx = np.random.default_rng(0).integers(0, n, size=(c, probes.NGS)).astype(np.int32)
        rows = int(np.unique(gidx).size)
        rest = 2 * gidx.size * 4 + c * f * 4
        out[scale] = bound(rows * f * 4 + rest, 2 * gidx.size * f)
        out[scale]["bound_named_ms"] = (gidx.size * f * 4 + rest) / H100_STREAM_BPS * 1e3
    return out


def r2_big(probed, case: str) -> dict:
    """A probe_r2_gather case at the 2M-row scale (phase 25): its time,
    ``torch.sparse.mm``'s, and the two bounds (distinct rows, named rows)."""
    (row,) = [r for r in probed["rows"]
              if r["probe"] == "probe_r2_gather" and r["case"] == case]
    b = probed["times"]["r2 chunk sum bounds"]["big"]
    return {"big_ms": row["ms"], "big_library_ms": row["library_ms"],
            "big_bound_ms": b["bound_ms"], "big_bound_named_ms": b["bound_named_ms"]}


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
    times["r2 gather bound"] = r2_gather_bound()
    # each probe_r2b_bisect site at its own shape: kernel, bound (the bytes
    # its case moves, once), and the library call of its case
    bisect = [{"case": r["case"], "kernel": r["kernel"], "ms": r["ms"],
               "library_ms": r["library_ms"], **bound(r["moved_bytes"], 0)}
              for r in rows if r["probe"] == "probe_r2b_bisect"]
    print(f"phase 25 probes (ms, CUDA events behind a queued sleep, median of 20; card {card}): "
          + json.dumps([{k: r[k] for k in ("probe", "case", "kernel", "ok", "max_abs_err", "ms",
                                           "library_ms")} for r in rows]), flush=True)
    print(f"phase 25 probe kernels vs plain vs library: {json.dumps(times)}", flush=True)
    print(f"phase 25 probe_r2b_bisect sites (ms, CUDA events behind a queued sleep, median of "
          f"20; bound: the case's bytes once over 3.35 TB/s; library: index_select for a row "
          f"gather, torch.sparse.mm for a chunk sum or an ELL stage, torch.mul for the copy; "
          f"card {card}): {json.dumps(bisect)}", flush=True)
    return {"rows": rows, "launches": launches, "times": times, "bisect": bisect}


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


def host_enqueue_ms(fn, calls: int = 10) -> float:
    """Host milliseconds to issue one call of ``fn``: the median over
    ``calls`` back-to-back calls, each timed alone on the host clock, the
    card running behind (few enough calls that its queue never fills)."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(calls):
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
    torch.cuda.synchronize()
    return float(np.median(times))


def dispatch_us(cfg, plan, hg, calls: int = 1000) -> float:
    """Host microseconds of one route dispatch (``fused.resolve_backend``,
    what each aggregation call runs before its route's work)."""
    from hypergef_tpu_torch.ops import fused

    t0 = time.perf_counter()
    for _ in range(calls):
        fused.resolve_backend(cfg.backend, plan, hg.nnz)
    return (time.perf_counter() - t0) / calls * 1e6


def reserved_mb(device) -> float:
    """MiB the caching allocator holds once garbage is collected and its
    free cached blocks are returned: live tensors and the private pools of
    live CUDA graphs."""
    gc.collect()
    torch.cuda.synchronize(device)
    torch.cuda.empty_cache()
    return torch.cuda.memory_reserved(device) / 2**20


def graph_mb(device, drop) -> float:
    """MiB that ``drop()`` (which lets go of a recorded graph) returns to the
    card: the graph's private pool, which holds every tensor its recording
    allocated, its output among them."""
    held = reserved_mb(device)
    drop()
    mb = held - reserved_mb(device)
    check(mb >= 0, f"dropping a graph returned {mb} MiB")
    return mb


def compiled_train_cell(problem, device, capturable: bool = True) -> dict:
    """Eager against captured on one training cell, from the same seeded
    weights with dropout on: COMPILED_EPOCHS losses bitwise equal; wall
    and device ms a step in turns (eager, captured, captured, eager); the
    host ms to issue one step of each; the captured step's
    ``epoch_device_time_stats``; the host seconds and the memory its
    recording holds (its pool, measured when the graph is dropped at the
    end). Where the route cannot be captured (``capturable``
    False), the captured Trainer must raise CaptureError, and the eager
    step alone is timed."""
    from hypergef_tpu_torch.train.trainer import Trainer
    from hypergef_tpu_torch.utils.graphs import CaptureError

    cfg, hg, x, y, split, plan = problem
    eager = Trainer(cfg, hg, x, y, plan=plan, device=device, compiled=False)
    want = eager.fit(split["train"], epochs=COMPILED_EPOCHS, warmup=0)["losses"]
    out = {"model": cfg.model, "first_aggr": cfg.first_aggr,
           "route": fused_route(cfg.backend, eager.plan, hg),
           "dispatch_us": dispatch_us(cfg, eager.plan, hg)}
    idx = torch.as_tensor(split["train"], device=device)
    captured = Trainer(cfg, hg, x, y, plan=plan, device=device, compiled=True)
    if not capturable:
        try:
            captured.fit(split["train"], epochs=1, warmup=0)
            raised = None
        except CaptureError as e:
            raised = str(e)
        check(raised is not None, f"{out['route']} {cfg.first_aggr}: capture refused")
        out["capture_error"] = raised
        out["eager"] = time_steps({"eager": eager}, split["train"], ("eager", "eager"),
                                  device)["eager"]
        out["eager"]["enqueue_ms"] = host_enqueue_ms(functools.partial(eager.step, idx))
        return out
    got = captured.fit(split["train"], epochs=COMPILED_EPOCHS, warmup=0)
    check(got["step"] == "captured", "the captured Trainer replays its step")
    out["capture_s"] = got["capture_s"]
    rel = float(np.max(np.abs(got["losses"] - want) / np.abs(want)))
    out["losses_equal"] = bool(np.array_equal(got["losses"], want))
    out["max_rel"] = rel
    check(out["losses_equal"], f"{out['route']} {cfg.model} {cfg.first_aggr}: captured losses "
                               f"bitwise equal to eager ({rel})")
    turns = time_steps({"eager": eager, "captured": captured}, split["train"],
                       ("eager", "captured", "captured", "eager"), device)
    for name, tr in (("eager", eager), ("captured", captured)):
        turns[name]["enqueue_ms"] = host_enqueue_ms(functools.partial(tr.step, idx))
    out.update(turns)
    # one repeat of the differenced windows (3 until phase 34 needed the time)
    out["stats"] = captured.epoch_device_time_stats(split["train"], iters=20, windows=5,
                                                    repeats=1)
    out["capture_mb"] = graph_mb(device, captured._steps.clear)
    return out


def compiled_request_cell(cfg, hg, nfeat: int, nclass: int, plan, device) -> dict:
    """Eager against captured on one request cell, the same weights: two
    requests bitwise equal, the first answer unchanged by the second; wall
    ms (host included) and device ms a request in turns; host ms to issue
    one; the seconds the recording took and the memory its graph holds."""
    from hypergef_tpu_torch.data.synthetic import random_features
    from hypergef_tpu_torch.serve import ServingModel
    from hypergef_tpu_torch.utils.timing import cuda_time_ms

    eager = ServingModel(cfg, hg, nfeat, nclass, device, plan=plan, compiled=False)
    params = {k: v.detach().cpu() for k, v in eager.model.state_dict().items()}
    captured = ServingModel(cfg, hg, nfeat, nclass, device, params=params, plan=plan,
                            compiled=True)
    out = {"route": fused_route(cfg.backend, eager.plan, hg), "model": cfg.model,
           "first_aggr": cfg.first_aggr, "capture_s": captured.capture_s}
    xs = [torch.as_tensor(random_features(hg.num_nodes, nfeat, nclass, seed=200 + i)[0],
                          device=device) for i in range(2)]
    got = [captured.predict(x) for x in xs]
    want = [eager.predict(x) for x in xs]
    out["equal"] = all(torch.equal(g, w) for g, w in zip(got, want))
    check(out["equal"], f"{out['route']}: captured requests bitwise equal to eager")
    check(not torch.equal(got[0], got[1]), "two requests, two answers")
    fns = {"eager": eager, "captured": captured}
    walls = {k: [] for k in fns}
    devs = {k: [] for k in fns}
    for name in ("eager", "captured", "captured", "eager"):
        call = functools.partial(fns[name].predict, xs[0])
        walls[name].append(cuda_time_ms(call, repeats=20, queue_ahead=False))
        devs[name].append(cuda_time_ms(call, repeats=20, queue_ahead=True))
    for name, server in fns.items():
        out[name] = {"wall_ms": float(np.median(walls[name])),
                     "device_ms": float(np.median(devs[name])),
                     "enqueue_ms": host_enqueue_ms(functools.partial(server.predict, xs[0]))}
    out["capture_mb"] = graph_mb(device, lambda: setattr(captured, "_graph", None))
    return out


def checkpoint_cell(problem, device) -> dict:
    """A checkpoint round trip on the card: a captured Trainer saves (in the
    background) and trains on; another, its step already recorded, restores
    into the tensors its graph reads and gives the same losses bitwise."""
    import shutil
    from pathlib import Path

    from hypergef_tpu_torch.train.trainer import Trainer

    cfg, hg, x, y, split, plan = problem
    directory = Path(__file__).resolve().parent / "build" / "chip_smoke_checkpoints"
    shutil.rmtree(directory, ignore_errors=True)
    a, b = (Trainer(cfg, hg, x, y, plan=plan, device=device) for _ in range(2))
    try:
        a.fit(split["train"], epochs=3, warmup=0)
        t0 = time.perf_counter()
        a.save(str(directory), step=3, wait=False)
        save_s = time.perf_counter() - t0
        want = a.fit(split["train"], epochs=3, warmup=0)["losses"]
        b.fit(split["train"], epochs=2, warmup=0)
        ptrs = [t.data_ptr() for t in b._state()]
        t0 = time.perf_counter()
        step = b.restore(str(directory))
        restore_s = time.perf_counter() - t0
        check(step == 3, f"restored step {step}")
        check([t.data_ptr() for t in b._state()] == ptrs, "restore keeps every tensor in place")
        got = b.fit(split["train"], epochs=3, warmup=0)["losses"]
    finally:
        shutil.rmtree(directory, ignore_errors=True)
    check(np.array_equal(got, want), "a restored captured Trainer goes on bitwise")
    return {"route": fused_route(cfg.backend, a.plan, hg), "step": "captured",
            "save_s": save_s, "restore_s": restore_s, "losses": got.tolist()}


def compiled_cells(problems, aligned, streamed, default_problems, graphs):
    """Phase 26's cells: (training cells, request cells, training cells
    whose route cannot be captured), from the earlier phases' problems."""
    from hypergef_tpu_torch.sparse.planner import (
        AggregationPlan, plan_pallas_sparse, plan_tree,
    )
    from hypergef_tpu_torch.train.trainer import TrainConfig

    def on(problem, backend=None, plan=None, **cfg):
        c, hg, x, y, split, _ = problem
        if backend is not None:
            cfg["backend"] = backend
        return dataclasses.replace(c, **cfg), hg, x, y, split, plan

    news, pub = problems["20news"], problems["pubmed_real"]
    sbm, al_plan = aligned["sbm"], aligned["plan"]
    sbm_sum = sbm_problem(sbm, al_plan)
    al_kernel = sbm_sum[5].aligned
    sbm_max = on(sbm_sum, plan=sbm_sum[5], first_aggr="max")
    s100k, bits, tree = streamed["hg"], streamed["bits"], streamed["tree"]
    sx, sy, ssplit = streamed["problem"]
    scfg = streamed["configs"]
    stream = {name: (scfg[name], s100k, sx, sy, ssplit, None) for name in scfg}
    dblp, cora = default_problems["coauthor_dblp HGNN sum"], default_problems["cora HGNN"]
    train_cells = {
        "20news pallas": news, "20news dense": on(news, "dense"),
        "pubmed_real pallas_sparse": pub, "pubmed_real tree": on(pub, "tree"),
        "SBM-60k sum aligned kernel": sbm_sum,
        "SBM-60k sum aligned plain": on(sbm_sum, plan=AggregationPlan(aligned=al_plan)),
        "SBM-60k sum pallas_sparse": on(sbm_sum, "pallas_sparse", plan_pallas_sparse(sbm)),
        "SBM-60k max aligned kernel": sbm_max,
        "SBM-60k max tree + aligned kernel": on(
            sbm_max, plan=AggregationPlan(tree=plan_tree(sbm), aligned=al_kernel)),
        "stream100k HGNN bitstream": on(stream["HGNN sum"],
                                        plan=AggregationPlan(bitstream=bits)),
        "stream100k HGNN tree": on(stream["HGNN sum"], "tree", AggregationPlan(tree=tree)),
        "stream100k HGNN pallas_sparse": on(stream["HGNN sum"], "pallas_sparse",
                                            plan_pallas_sparse(s100k)),
        "stream100k HGNN max bitstream": on(stream["HGNN max"],
                                            plan=AggregationPlan(bitstream=bits, tree=tree)),
        "stream100k UniGCNII bitstream": on(stream["UniGCNII"],
                                            plan=AggregationPlan(bitstream=bits)),
        "coauthor_dblp HGNN sum cumsum (auto)": dblp,
        "coauthor_dblp HGNN max cumsum (auto)": default_problems["coauthor_dblp HGNN max"],
        "coauthor_dblp UniGCNII cumsum (auto)": default_problems["coauthor_dblp UniGCNII"],
        "coauthor_dblp HGNN sum tree": on(dblp, "tree"),
        "coauthor_dblp HGNN sum pallas_sparse": on(dblp, "pallas_sparse",
                                                   plan_pallas_sparse(dblp[1])),
        "cora HGNN precomp (auto)": cora, "cora HGNN dense": on(cora, "dense"),
        "cora HGNN pallas": on(cora, "pallas"),
        "20news HGNN dense (auto)": default_problems["20news HGNN"],
    }
    refused = {"SBM-60k max aligned plain": on(sbm_max, plan=AggregationPlan(aligned=al_plan))}
    base = TrainConfig(model="HGNN", nhid=32, nlayer=2)
    request_cells = {
        "20news pallas": (dataclasses.replace(base, backend="pallas"), graphs["20news"], NFEAT,
                          NCLASS, None),
        "SBM-60k sum aligned kernel": (dataclasses.replace(base, backend="aligned"), sbm, NFEAT,
                                       NCLASS, AggregationPlan(aligned=al_kernel)),
        "SBM-60k max aligned kernel": (dataclasses.replace(base, backend="aligned",
                                                           first_aggr="max"), sbm, NFEAT,
                                       NCLASS, AggregationPlan(aligned=al_kernel)),
        "stream100k HGNN bitstream": (dataclasses.replace(base, backend="bitstream"), s100k,
                                      NFEAT, NCLASS, AggregationPlan(bitstream=bits)),
        "stream100k UniGCNII bitstream": (dataclasses.replace(base, model="UniGCNII",
                                                              backend="bitstream"), s100k,
                                          NFEAT, NCLASS, AggregationPlan(bitstream=bits)),
        "coauthor_dblp HGNN cumsum (auto)": (base, dblp[1], DBLP_NFEAT, DBLP_NCLASS, None),
        "cora HGNN precomp (auto)": (base, cora[1], CORA_NFEAT, CORA_NCLASS, None),
    }
    return train_cells, request_cells, refused


def compiled_phase(device, card: str, train_cells: dict, request_cells: dict,
                   refused: dict) -> dict:
    """Phase 26: the compiled step and request, eager against captured."""
    out = {"train": {}, "requests": {}, "refused": {}}
    for name, problem in train_cells.items():
        out["train"][name] = compiled_train_cell(problem, device)
        print(f"phase 26 train {name} (card {card}): {json.dumps(out['train'][name])}",
              flush=True)
    for name, problem in refused.items():
        out["refused"][name] = compiled_train_cell(problem, device, capturable=False)
        print(f"phase 26 train {name}, not capturable (card {card}): "
              f"{json.dumps(out['refused'][name])}", flush=True)
    for name, cell in request_cells.items():
        out["requests"][name] = compiled_request_cell(*cell, device)
        print(f"phase 26 request {name} (card {card}): {json.dumps(out['requests'][name])}",
              flush=True)
    out["checkpoint"] = checkpoint_cell(train_cells["20news pallas"], device)
    print(f"phase 26 checkpoint round trip: {json.dumps(out['checkpoint'])}", flush=True)
    cols = ("wall_ms", "device_ms", "enqueue_ms")
    summary = {f"{kind} {name}": {f"{form} {c}": round(cell[form][c], 6)
                                  for form in ("eager", "captured") for c in cols}
               for kind, cells in (("step", out["train"]), ("request", out["requests"]))
               for name, cell in cells.items()}
    print(f"phase 26 summary (ms; wall: host included; device: behind a queued sleep; "
          f"enqueue: host time to issue one; card {card}): {json.dumps(summary)}", flush=True)
    sbm = out["train"]["SBM-60k sum aligned kernel"]
    print(f"phase 26 SBM-60k sum step, aligned kernel form: eager wall {sbm['eager']['wall_ms']} "
          f"ms, host time to issue it {sbm['eager']['enqueue_ms']} ms, its device time "
          f"{sbm['eager']['device_ms']} ms; captured wall {sbm['captured']['wall_ms']} ms",
          flush=True)
    return out


def cli_counts_run(argv, counters, out=None):
    """``cli.main(argv)`` in this process with every kernel count set to 0
    just before, and the counts it launched read just after (the recording
    of its captured step and forward, and its eager warm-up steps: replays
    call no wrapper). ``out`` collects its standard output."""
    import contextlib
    import io

    from hypergef_tpu_torch.train import cli

    torch.cuda.synchronize()
    for module, attr in counters.values():
        setattr(module, attr, 0)
    buf = io.StringIO()
    code = 0
    with contextlib.redirect_stdout(buf):
        try:
            res = cli.main(argv)
        except SystemExit as e:  # --validate-parity exits with its verdict
            res, code = None, e.code
    torch.cuda.synchronize()
    launched = {k: getattr(module, attr) for k, (module, attr) in counters.items()}
    if out is not None:
        out.append(buf.getvalue())
    return res, code, {k: v for k, v in launched.items() if v}


def cli_run_line(res, launched, launches: list) -> dict:
    """What a training run of the CLI reports: its route, times and setup;
    its launches are added to ``launches``."""
    check(bool(np.isfinite(res["losses"]).all()), "the CLI's losses are finite")
    launches.append(launched)
    return {"route": res["route"], "step": res["step"], "timer": res["timer"],
            "setup_s": res["setup_s"], "capture_s": res["capture_s"],
            "train_epoch_time_s": res["train_epoch_time_s"],
            "inference_time_s": res.get("inference_time_s"), "final_loss": res["final_loss"],
            "test_acc": res.get("test_acc"), "launches": launched}


def cli_phase(device, card: str) -> dict:
    """Phase 27: the training CLI (``hypergef_tpu_torch.train.cli``) on the
    card, in this process and once as ``python -m``; every file it writes
    (data copies, tune and plan caches, CSV rows) goes to a temporary
    directory."""
    import os
    import shutil
    import tempfile
    from pathlib import Path

    from hypergef_tpu_torch.data.datasets import EXISTING_DATASETS
    from hypergef_tpu_torch.sparse import autotune

    counters = kernel_counters()
    out, launches = {}, []
    saved_env = {k: os.environ.get(k) for k in ("HYPERGEF_TORCH_TUNE_DIR",
                                                "HYPERGEF_TORCH_PLAN_CACHE")}
    real_sweep = autotune.sweep
    sweeps = []

    def counted_sweep(*a, **k):
        sweeps.append(1)
        return real_sweep(*a, **k)

    with tempfile.TemporaryDirectory(prefix="chip_smoke_cli_") as tmp:
        tmp = Path(tmp)
        os.environ["HYPERGEF_TORCH_TUNE_DIR"] = str(tmp / "tune")
        os.environ["HYPERGEF_TORCH_PLAN_CACHE"] = str(tmp / "plans_default")
        autotune.sweep = counted_sweep
        try:
            # a. coauthor_dblp's dimensions on the ladder's route, with the CSV row
            csv = tmp / "rows.csv"
            res, _, launched = cli_counts_run(CLI_DBLP + ["--output", str(csv)], counters)
            a = cli_run_line(res, launched, launches)
            check(a["route"] == CLI_PICKS["coauthor_dblp"] and a["step"] == "captured",
                  f"the CLI's dblp run: route {a['route']}, step {a['step']}")
            check(launched.get("segsum", 0) > 0, f"the CLI's dblp run launched {launched}")
            (row,) = csv.read_text().splitlines()
            fields = row.split(",")
            check(len(fields) == len(CLI_ROW) and fields[0] == "auto"
                  and fields[1] == "HGNN" and fields[3] == "nlayer=2"
                  and fields[4] == " nhid=32" and fields[6] == "first_aggr=sum"
                  and float(fields[7]) == res["train_epoch_time_s"]
                  and float(fields[8]) == res["inference_time_s"], f"the CSV row {row!r}")
            a["csv_row"] = row
            out["a"] = a
            # the segment-sum kernel on this graph's two tables at F = 32: a
            # segment is one warp's walk, so the longest one sets the time
            from hypergef_tpu_torch.data.synthetic import powerlaw_hypergraph
            from hypergef_tpu_torch.train import cli

            args = cli.parse(CLI_DBLP)
            hg = powerlaw_hypergraph(args.n, args.e, seed=args.seed)
            out["segsum"] = {
                stage: {"longest_segment": int(longest.max()), "nnz": hg.nnz,
                        **time_segsum(hg, stage, 32, device)}
                for stage, longest in (("v2e", hg.edge_sizes()), ("e2v", hg.vertex_degrees()))}
            del hg
            # b. --tune: the sweep, then a second run reads its record
            res, _, launched = cli_counts_run(CLI_DBLP + ["--tune"], counters)
            check(len(sweeps) == 1, "the first --tune run sweeps")
            (rec_file,) = (tmp / "tune").iterdir()
            rec = json.loads(rec_file.read_text())
            res2, _, launched2 = cli_counts_run(CLI_DBLP + ["--tune"], counters)
            check(len(sweeps) == 1, "the second --tune run reads the record, no sweep")
            check(res2["route"] == rec["backend"] == res["route"], "the tuned route")
            out["b"] = {"sweep_us": {f"{r['backend']} {json.dumps(r['params'])}":
                                     r["per_iter_s"] * 1e6 for r in rec["all"]},
                        "pick": rec["backend"], "pick_params": rec["params"],
                        "ladder_pick": CLI_PICKS["coauthor_dblp"], "device": rec["device"],
                        "first": cli_run_line(res, launched, launches),
                        "second": cli_run_line(res2, launched2, launches)}
            # c. --plan-cache DIR: a build, then a load in a fresh Trainer
            runs = [cli_counts_run(CLI_DBLP + ["--plan-cache", str(tmp / "plans")], counters)
                    for _ in range(2)]
            check(len(list((tmp / "plans").iterdir())) == 1, "one cached plan")
            check(np.array_equal(runs[0][0]["losses"], runs[1][0]["losses"]),
                  "a loaded plan trains to the built plan's losses, bitwise")
            out["c"] = {"build_setup_s": runs[0][0]["setup_s"],
                        "load_setup_s": runs[1][0]["setup_s"],
                        "losses_bitwise_equal": True,
                        "build": cli_run_line(runs[0][0], runs[0][2], launches),
                        "load": cli_run_line(runs[1][0], runs[1][2], launches)}
            # d. the fused dense kernel (--backend pallas) and the max backward
            res, _, launched = cli_counts_run(CLI_5K + ["--backend", "pallas"], counters)
            check(res["route"] == "pallas" and launched.get("fused", 0) > 0,
                  f"the CLI's pallas run launched {launched}")
            out["d pallas"] = cli_run_line(res, launched, launches)
            res, _, launched = cli_counts_run(CLI_5K + ["--first-aggr", "max"], counters)
            check(res["route"] == CLI_PICKS["5000x3000"] and launched.get("recsum", 0) > 0,
                  f"the CLI's max run: route {res['route']}, launched {launched}")
            out["d max"] = cli_run_line(res, launched, launches)
            # e, f. the 13 fixtures: trained, then validated
            root = tmp / "data"
            fixtures = Path(__file__).resolve().parent / "tests" / "fixtures" / "data"
            for name in EXISTING_DATASETS:
                shutil.copytree(fixtures / name, root / name)
            out["e"], out["f"] = {}, {}
            for name in EXISTING_DATASETS:
                res, _, launched = cli_counts_run(
                    ["--dname", name, "--data-path", str(root), "--epochs", "20"], counters)
                out["e"][name] = cli_run_line(res, launched, launches)
                printed = []
                _, code, _ = cli_counts_run(["--dname", name, "--data-path", str(root),
                                             "--validate-parity"], counters, printed)
                # CheckResult.line(): "[STATUS] check: detail"
                statuses = {ln[7:].split(":")[0]: ln[1:5].strip()
                            for ln in printed[0].splitlines() if ln.startswith("[")}
                check(code == 0 and statuses == {"format": "PASS", "shape": "SKIP",
                                                 "oracle": "PASS", "accuracy": "SKIP"},
                      f"{name}: --validate-parity exit {code}, {printed[0]!r}")
                oracle = [ln for ln in printed[0].splitlines() if "] oracle:" in ln]
                check("on cuda" in oracle[0], f"{name}: the oracle ran on the card")
                out["f"][name] = oracle[0]
            # g. --profile: the device's memory, the earlier runs' tensors freed
            gc.collect()
            torch.cuda.empty_cache()
            before = torch.cuda.memory_allocated(device)
            printed = []
            res, _, launched = cli_counts_run(CLI_DBLP + ["--profile", "1"], counters, printed)
            check(0 < res["device_memory_bytes"] <= res["device_memory_peak_bytes"],
                  "device memory in use and peak")
            out["g"] = {"in_use_mib": res["device_memory_bytes"] / 2**20,
                        "peak_mib": res["device_memory_peak_bytes"] / 2**20,
                        "before_mib": before / 2**20,
                        "printed": [ln for ln in printed[0].splitlines()
                                    if ln.startswith(("epoch time", "device memory"))],
                        "launches": launched}
            launches.append(launched)
            # the entry point as a user runs it
            t0 = time.perf_counter()
            proc = subprocess.run(
                [sys.executable, "-m", "hypergef_tpu_torch.train.cli", *CLI_5K,
                 "--output", str(tmp / "sub.csv")],
                capture_output=True, text=True, timeout=300, check=False,
                cwd=str(Path(__file__).resolve().parent),
                env={**os.environ, "PYTHONPATH": str(Path(__file__).resolve().parent)})
            check(proc.returncode == 0, f"python -m hypergef_tpu_torch.train.cli: "
                  f"{proc.returncode}\n{proc.stdout[-2000:]}\n{proc.stderr[-2000:]}")
            (row,) = (tmp / "sub.csv").read_text().splitlines()
            check(len(row.split(",")) == len(CLI_ROW), f"the subprocess's CSV row {row!r}")
            out["subprocess"] = {"seconds": time.perf_counter() - t0, "csv_row": row,
                                 "stdout_tail": proc.stdout.strip().splitlines()[-5:]}
        finally:
            autotune.sweep = real_sweep
            for k, v in saved_env.items():
                if v is None:
                    os.environ.pop(k, None)
                else:
                    os.environ[k] = v
    out["launches"] = {k: sum(run.get(k, 0) for run in launches)
                       for k in ("segsum", "fused", "recsum")}
    return out

# phase 28, the serving export: a cell a forward kernel, and the counters
# (``kernel_counters``' names) each cell's request must launch
EXPORT_KERNELS = {
    "20news pallas": ("fused",), "pubmed_real pallas_sparse": ("gather",),
    "SBM-60k aligned kernel": ("band",), "SBM-60k max aligned kernel": ("argmax", "band"),
    "stream100k bitstream": ("bitmm",), "coauthor_dblp cumsum (auto)": ("segsum",),
}
EXPORT_TIMED = 50
# phase 29: experiments/minibatch_bench.py's dblp_shaped workload (:39-44,
# :85-89): homophilic_hypergraph(n, e, classes, avg, seed=11), 64 random
# features (seed 12), the split of seed 13, HGNN nhid 32, --batch-edges 512
MB_DBLP = dict(n=41302, e=22363, classes=6, avg=4.5, feat=64)
MB_BATCH_EDGES = {"dblp_shaped": 512, "stream100k": 2048}


def export_cells(problems, aligned, streamed, default_problems) -> dict:
    """Phase 28's cells, name -> (cfg, graph, x, y, split, plan), from the
    problems of the earlier phases."""
    from hypergef_tpu_torch.sparse.planner import AggregationPlan

    sbm_sum = sbm_problem(aligned["sbm"], aligned["plan"])
    cfg, hg, x, y, split, plan = sbm_sum
    sx, sy, ssplit = streamed["problem"]
    return {
        "20news pallas": problems["20news"],
        "pubmed_real pallas_sparse": problems["pubmed_real"],
        "SBM-60k aligned kernel": sbm_sum,
        "SBM-60k max aligned kernel": (dataclasses.replace(cfg, first_aggr="max"), hg, x, y,
                                       split, plan),
        "stream100k bitstream": (streamed["configs"]["HGNN sum"], streamed["hg"], sx, sy,
                                 ssplit, AggregationPlan(bitstream=streamed["bits"])),
        "coauthor_dblp cumsum (auto)": default_problems["coauthor_dblp HGNN sum"],
    }


def request_walls(servers: dict, x, n: int) -> dict:
    """p50/p90/p99 ms of ``n`` requests a server, in turns, each between two
    CUDA events with the card idle before it (host time included)."""
    walls = {name: [] for name in servers}
    for server in servers.values():
        server.predict(x)
    for _ in range(n):
        for name, server in servers.items():
            torch.cuda.synchronize()
            start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            start.record()
            server.predict(x)
            end.record()
            end.synchronize()
            walls[name].append(start.elapsed_time(end))
    return {name: {f"p{q}": float(np.percentile(w, q)) for q in (50, 90, 99)}
            for name, w in walls.items()}


def eager_launches(server, x, counters) -> dict:
    """The kernels one eager request of ``server`` launches."""
    torch.cuda.synchronize()
    for module, attr in counters.values():
        setattr(module, attr, 0)
    server.predict(x)
    torch.cuda.synchronize()
    return {k: getattr(module, attr) for k, (module, attr) in counters.items()}


def export_cell(name: str, problem, device, root: str) -> dict:
    """Export one cell's Trainer, load the artifact and hold it against the
    built server (phase 28's checks)."""
    import os

    from hypergef_tpu_torch import serve
    from hypergef_tpu_torch.data.synthetic import random_features
    from hypergef_tpu_torch.train.trainer import Trainer

    cfg, hg, x, y, split, plan = problem
    counters = kernel_counters()
    tr = Trainer(cfg, hg, x, y, plan=plan, device=device)
    nfeat, nclass = int(tr.x.shape[1]), tr.nclass
    params = tr.model.state_dict()
    path = os.path.join(root, name.replace(" ", "_") + ".hgefsrv")
    t0 = time.perf_counter()
    meta = serve.export_trainer(tr, path)
    out = {"route": fused_route(cfg.backend, tr.plan, hg), "export_s": time.perf_counter() - t0,
           "artifact_bytes": os.path.getsize(path), "payload_bytes": meta["payload_bytes"]}
    header, _ = serve.read_artifact(path)
    check(header == {**meta, "format_version": 1} and header["platforms"] == ["cuda"],
          f"{name}: the header reads back")
    xs = [torch.as_tensor(random_features(hg.num_nodes, nfeat, nclass, seed=300 + i)[0],
                          device=device) for i in range(REQUESTS)]
    eager_loaded = serve.ServingModel.load(path, compiled=False)
    eager_built = serve.ServingModel(cfg, hg, nfeat, nclass, device, params=params, plan=tr.plan,
                                     compiled=False)
    # check 2: one eager request each launches the same kernels, the cell's at least once
    per = eager_launches(eager_loaded, xs[0], counters)
    check(per == eager_launches(eager_built, xs[0], counters),
          f"{name}: an exported request launches what a built one does ({per})")
    check(all(per[k] > 0 for k in EXPORT_KERNELS[name]), f"{name}: kernels launched {per}")
    out["request_launches"] = per
    # the exported path alone: a captured load (warm-up and recording) and
    # the eager and captured requests, counts set to 0 just before
    torch.cuda.synchronize()
    for module, attr in counters.values():
        setattr(module, attr, 0)
    t0 = time.perf_counter()
    loaded = serve.ServingModel.load(path)
    load_s = time.perf_counter() - t0
    got = [(loaded.predict(xq), eager_loaded.predict(xq)) for xq in xs]
    torch.cuda.synchronize()
    launched = {k: getattr(module, attr) for k, (module, attr) in counters.items()}
    check(launched == {k: v * (2 + REQUESTS) for k, v in per.items()},
          f"{name}: the exported path launched {launched}")
    out.update(load_s=load_s - loaded.capture_s, capture_s=loaded.capture_s)
    built = serve.ServingModel(cfg, hg, nfeat, nclass, device, params=params, plan=tr.plan)
    out["built_capture_s"] = built.capture_s
    # check 1: bitwise equal to the built server's, captured and eager
    diff, scale = 0.0, 0.0
    for xq, (cap, eag) in zip(xs, got):
        for a, b in ((cap, built.predict(xq)), (eag, eager_built.predict(xq))):
            scale = max(scale, float(b.abs().max()))
            if not torch.equal(a, b):
                diff = max(diff, float((a - b).abs().max()))
    out["bitwise"] = diff == 0.0
    if diff:
        ops = sorted({str(n.target) for n in loaded.program.graph.nodes
                      if n.op == "call_function"})
        out.update(max_abs_diff=diff, max_abs_ref=scale, program_ops=ops)
        check(diff <= 1e-5 * scale, f"{name}: exported answers within 1e-5·max|ref| ({diff})")
    nodes = graph_kernels(loaded._graph)
    check(nodes == graph_kernels(built._graph),
          f"{name}: the two recordings hold the same kernel nodes ({nodes})")
    check(all(nodes[kernel] > 0 for kernel, names in GRAPH_KERNELS.items()
              if any(k in names for k in EXPORT_KERNELS[name])), f"{name}: graph nodes {nodes}")
    out["walls_ms"] = request_walls({"exported": loaded, "built": built}, xs[0], EXPORT_TIMED)
    out["launches"] = {k: v + per[k] for k, v in launched.items()}
    out["replayed"] = {k: n * (REQUESTS + EXPORT_TIMED + 1) for k, n in nodes.items() if n}
    return out


def export_phase(device, card: str, cells: dict) -> dict:
    """Phase 28: the serving export of each cell, a fresh process's load,
    and a two-platform artifact."""
    import os
    import tempfile
    from pathlib import Path

    from hypergef_tpu_torch import serve
    from hypergef_tpu_torch.train.trainer import Trainer

    out = {}
    repo = Path(__file__).resolve().parent
    with tempfile.TemporaryDirectory() as root:
        for name, problem in cells.items():
            out[name] = export_cell(name, problem, device, root)
            print(f"phase 28 export {name} (card {card}): {json.dumps(out[name])}", flush=True)
        # a process that imports no model code loads an artifact and answers
        path = os.path.join(root, "coauthor_dblp_cumsum_(auto).hgefsrv")
        code = (
            "import json, sys, torch\n"
            "from hypergef_tpu_torch.serve import ServingModel\n"
            f"m = ServingModel.load({path!r})\n"
            "y = m.predict(torch.ones(m.meta['input_shape'], device='cuda'))\n"
            "torch.cuda.synchronize()\n"
            "print(json.dumps({'shape': list(y.shape), 'finite': bool(torch.isfinite(y).all()),"
            " 'imported': sorted(k for k in sys.modules if k.startswith(("
            "'hypergef_tpu_torch.models', 'hypergef_tpu_torch.train', 'jax', "
            "'hypergef_tpu.')))}))\n")
        t0 = time.perf_counter()
        proc = subprocess.run([sys.executable, "-c", code], cwd=repo, capture_output=True,
                              text=True, timeout=300,
                              env={**os.environ, "PYTHONPATH": str(repo)})
        check(proc.returncode == 0, f"the fresh process failed: {proc.stderr[-2000:]}")
        fresh = json.loads(proc.stdout.strip().splitlines()[-1])
        fresh["seconds"] = time.perf_counter() - t0
        check(fresh["imported"] == [] and fresh["finite"], f"the fresh process: {fresh}")
        out["fresh process"] = fresh
        # one artifact for the card and the CPU: each program on its device
        cfg, hg, x, y, split, plan = cells["coauthor_dblp cumsum (auto)"]
        tr = Trainer(cfg, hg, x, y, plan=plan, device=device)
        both = os.path.join(root, "both.hgefsrv")
        meta = serve.export_trainer(tr, both, platforms=["cuda", "cpu"])
        card_answer = serve.ServingModel.load(both).predict(x).cpu()
        host_answer = serve.ServingModel.load(both, device="cpu").predict(x)
        err = float((host_answer - card_answer).abs().max())
        check(bool(torch.allclose(host_answer, card_answer, rtol=1e-3, atol=1e-3)),
              f"the CPU program within 1e-3 of the card's ({err})")
        out["two platforms"] = {"platforms": meta["platforms"], "bytes": os.path.getsize(both),
                                "max_abs_err": err}
    print(f"phase 28 fresh process: {json.dumps(out['fresh process'])}; cuda+cpu artifact: "
          f"{json.dumps(out['two platforms'])}", flush=True)
    return out


def minibatch_problem(name: str, streamed):
    """(graph, x, y, split) of a phase-29 cell."""
    from hypergef_tpu_torch.data.synthetic import homophilic_hypergraph, random_features
    from hypergef_tpu_torch.train.splits import rand_train_test_idx

    if name == "stream100k":
        return (streamed["hg"], *streamed["problem"])
    d = MB_DBLP
    hg, y = homophilic_hypergraph(d["n"], d["e"], d["classes"], avg_edge_size=d["avg"], seed=11)
    x, _ = random_features(hg.num_nodes, d["feat"], d["classes"], seed=12)
    return hg, x, y, rand_train_test_idx(y, seed=13)


def step_peak_mib(step, device) -> float:
    """MiB one call of ``step`` holds at its peak above what the process
    held before it."""
    torch.cuda.synchronize(device)
    base = torch.cuda.memory_allocated(device)
    torch.cuda.reset_peak_memory_stats(device)
    step()
    torch.cuda.synchronize(device)
    return (torch.cuda.max_memory_allocated(device) - base) / 2**20


def minibatch_epoch(tr, device):
    """One epoch of ``tr``'s steps, sampling timed apart: (batches, losses
    on the host, wall seconds, sampler seconds a batch)."""
    tr.generator.manual_seed(tr.cfg.seed + 1)
    batches, losses, sampler_s = [], [], []
    it = tr.epoch_batches()
    torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    while True:
        ts = time.perf_counter()
        batch = next(it, None)
        if batch is None:
            break
        sampler_s.append(time.perf_counter() - ts)
        batches.append(batch)
        losses.append(tr.step(batch))
    losses = torch.stack(losses).cpu().numpy()
    return batches, losses, time.perf_counter() - t0, float(np.mean(sampler_s))


def batch_csr(table):
    """A batch's exact segment table as a CSR count matrix [S, N] (for the
    library yardstick ``torch.sparse.mm``; the port never calls it)."""
    s = int(table.indptr_long.shape[0]) - 1
    cols = (table.gather_long if table.gather_long is not None
            else torch.arange(table.nnz, device=table.indptr_long.device))
    return torch.sparse_csr_tensor(table.indptr_long, cols,
                                   torch.ones(table.nnz, device=cols.device),
                                   (s, table.num_inputs))


def padded_runs_check(tr, batch, widths, device) -> dict:
    """The segment-sum kernel over the pad shape's tables (runs padded to
    ``max_warp_runs``) against the kernel over ``batch``'s exact runs and
    the plain version, both CSRs: bitwise equal; the two launches' device
    ms, the plain's, one ``torch.sparse.mm`` of the batch's CSR (the
    library yardstick), and the bound of the exact work (not counted on
    the path)."""
    from hypergef_tpu_torch.ops import segment_sum
    from hypergef_tpu_torch.utils.timing import cuda_time_ms

    tables = tr.tables[batch.pad_shape]
    batch.write(tables)
    out = {}
    for side in ("v2e", "e2v"):
        padded, exact = getattr(tables.data, side), getattr(batch.data, side)
        for f in widths:
            x = segment_operands(exact, f, 70 + f, device)
            got = segment_sum.gather_segment_sum(x, padded)
            want = segment_sum.gather_segment_sum(x, exact)
            plain = segment_sum.gather_segment_sum_plain(x, exact)
            check(torch.equal(got, want) and torch.equal(got, plain),
                  f"the padded-run segment sum ({side}, F={f}) bitwise equal to the exact "
                  f"runs' and the plain version's")
            key = f"{side} F={f}"
            out[key] = {
                "runs_padded": int(padded.runs.shape[0]) - 1,
                "runs_exact": int(exact.runs.shape[0]) - 1, "bitwise": True,
                "padded_ms": cuda_time_ms(functools.partial(segment_sum.gather_segment_sum,
                                                            x, padded)),
                "exact_ms": cuda_time_ms(functools.partial(segment_sum.gather_segment_sum,
                                                           x, exact)),
                "plain_ms": cuda_time_ms(functools.partial(segment_sum.gather_segment_sum_plain,
                                                           x, exact)),
                "library_ms": cuda_time_ms(functools.partial(torch.sparse.mm, batch_csr(exact),
                                                             x)),
                # the rows the gather names, the int32 tables and the output
                # once, an add a feature an entry (as time_segsum's)
                **bound(rows_read_bytes(x, exact.gather) + nbytes(exact.gather, exact.indptr)
                        + exact.num_segments * f * 4, exact.nnz * f)}
    return out


def minibatch_cell(name: str, problem, device) -> dict:
    """One recorded epoch (the main path, counted) and one eager epoch
    from the same weights and seeds, and phase 29's checks."""
    from hypergef_tpu_torch.train.minibatch import MinibatchTrainer
    from hypergef_tpu_torch.train.trainer import CAPTURE_WARMUP, TrainConfig, Trainer
    from hypergef_tpu_torch.utils.timing import cuda_time_ms

    hg, x, y, split = problem
    cfg = TrainConfig(model="HGNN", nhid=32, seed=3)
    counters = kernel_counters()
    t0 = time.perf_counter()
    tr = MinibatchTrainer(cfg, hg, x, y, split["train"], batch_edges=MB_BATCH_EDGES[name],
                          device=device)
    out = {"setup_s": time.perf_counter() - t0, "nnz": int(hg.nnz)}
    eager = MinibatchTrainer(cfg, hg, x, y, split["train"], batch_edges=MB_BATCH_EDGES[name],
                             device=device, compiled=False)
    eager.model.load_state_dict(tr.model.state_dict())
    check(tr.compiled and not eager.compiled, f"{name}: recorded by default on the card")
    # the main path: the recorded epoch, counts set to 0 just before
    torch.cuda.synchronize()
    for module, attr in counters.values():
        setattr(module, attr, 0)
    batches, losses, wall, sampler_s = minibatch_epoch(tr, device)
    launched = {k: getattr(module, attr) for k, (module, attr) in counters.items()}
    n = len(batches)
    recordings = len(tr._steps)
    replays = sum(g.replays for g in tr._steps.values())
    check(tr.compile_count == recordings >= 1 and replays == n,
          f"{name}: compile_count {tr.compile_count}, {recordings} recordings, {replays} "
          f"replays for {n} batches")
    per_recording = 8 * (CAPTURE_WARMUP + 1)
    check(launched == {k: per_recording * recordings if k == "segsum" else 0
                       for k in counters},
          f"{name}: {recordings} recordings launched {launched}, want 8 segment sums a "
          f"warm-up step and 8 a recording")
    out["launches"] = launched
    for module, attr in counters.values():
        setattr(module, attr, 0)
    e_batches, e_losses, e_wall, e_sampler_s = minibatch_epoch(eager, device)
    e_launched = {k: getattr(module, attr) for k, (module, attr) in counters.items()}
    check(e_launched == {k: 8 * n if k == "segsum" else 0 for k in counters},
          f"{name}: {n} eager steps launched {e_launched}, want 8 segment sums a step")
    check(len(e_batches) == n and bool(np.array_equal(losses, e_losses)),
          f"{name}: the recorded epoch's losses bitwise equal to the eager epoch's")
    check(bool(np.isfinite(losses).all()), f"{name}: finite losses")
    k = min(10, n // 2)
    first, last = float(losses[:k].mean()), float(losses[-k:].mean())
    check(last < first, f"{name}: the last {k} batches' mean loss {last} below the first's {first}")
    capture_s = sum(g.build_s for g in tr._steps.values())
    out.update(pad_shapes=list(tr.pad_shapes), compile_count=tr.compile_count,
               recordings=recordings, replays=replays, batches=n, losses_bitwise=True,
               capture_s=capture_s, first_mean_loss=first, last_mean_loss=last,
               batches_compared=k, eager_launches=e_launched,
               max_warp_runs={str(list(shape)): t.runs for shape, t in tr.tables.items()},
               recorded={"batches_per_s": n / wall,
                         "batches_per_s_past_recording": n / (wall - capture_s),
                         "sampler_s_a_batch": sampler_s},
               eager={"batches_per_s": n / e_wall, "sampler_s_a_batch": e_sampler_s})
    # each batch's ghost segment beside its recorded step's device time
    # (behind a queued sleep); then each form's device ms, wall ms and peak
    out["ghost_and_device_ms"] = [
        [b.ghost_entries, cuda_time_ms(functools.partial(tr.step, b), repeats=3)]
        for b in batches]
    for form, t in (("recorded", tr), ("eager", eager)):
        step = functools.partial(t.step, batches[-1])
        out[form].update(step_device_ms=cuda_time_ms(step, repeats=5),
                         step_wall_ms=cuda_time_ms(step, repeats=5, queue_ahead=False),
                         step_peak_mib=step_peak_mib(step, device))
    out["padded_runs"] = padded_runs_check(tr, batches[-1], (32, tr.nclass), device)
    out["accuracy"] = tr.evaluate_full(split)
    # check 2: dropout 0, the same three batches on the card and on the CPU
    cfg0 = dataclasses.replace(cfg, dropout=0.0, input_drop=0.0)
    params = {key: v.detach().cpu() for key, v in tr.model.state_dict().items()}
    twins = [MinibatchTrainer(cfg0, hg, x, y, split["train"], batch_edges=MB_BATCH_EDGES[name],
                              sampler_seed=7, device=d, params=params) for d in (device, "cpu")]
    pair = [[t.step(b) for b in itertools.islice(t.epoch_batches(), 3)] for t in twins]
    card_l, host_l = (np.asarray([float(v) for v in ls]) for ls in pair)
    check(bool(np.allclose(card_l, host_l, rtol=1e-4, atol=0)),
          f"{name}: card losses {card_l} within rtol 1e-4 of the CPU's {host_l}")
    out["card_vs_cpu_losses"] = [card_l.tolist(), host_l.tolist()]
    if name == "dblp_shaped":
        # check 3: a batch of every edge is the full graph (its HT factor 1)
        card = twins[0]
        b = card.sampler.induce(np.arange(hg.num_edges))
        rows = torch.as_tensor(b.vertex_ids[: b.num_real_vertices].astype(np.int64), device=device)
        card.model.eval()
        with torch.no_grad():
            zb = card.model(card.x.index_select(0, b.rows), b.data, None)[: b.num_real_vertices]
            zf = card.model(card.x, hg.device_data(device), None).index_select(0, rows)
        err, ref = float((zb - zf).abs().max()), float(zf.abs().max())
        check(err <= 1e-5 * ref, f"{name}: the whole-graph batch within 1e-5·max|ref| ({err})")
        out["whole_batch"] = {"max_abs_err": err, "max_abs_ref": ref,
                              "real_rows": b.num_real_vertices, "ghost_entries": b.ghost_entries}
        full = Trainer(dataclasses.replace(cfg, backend="cumsum"), hg, x, y, device=device,
                       compiled=False)
        idx = torch.as_tensor(split["train"], device=device)
        out["full_batch_step_peak_mib"] = step_peak_mib(functools.partial(full.step, idx),
                                                        device)
    # the recordings' shared pool (the gradients live in it), returned when
    # they are dropped
    out["recorded"]["pool_mib"] = graph_mb(
        device, lambda: (tr._steps.clear(), tr.optimizer.zero_grad(set_to_none=True)))
    return out


def minibatch_phase(device, card: str, streamed) -> dict:
    """Phase 29: minibatch training on its two cells."""
    out = {}
    for name in MB_BATCH_EDGES:
        out[name] = minibatch_cell(name, minibatch_problem(name, streamed), device)
        print(f"phase 29 minibatch {name} (card {card}): {json.dumps(out[name])}", flush=True)
    return out



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
    (``precomp``), the 20news ``pallas`` step (phase 7's) and the
    stream100k HGNN max step (phase 19's) under ``torch.profiler`` (``steps``
    steps after 5 warm-up ones): the device's busy time a step, its kernel
    count, the kernels that take the most device time and the shares of the
    fused dense kernel and of the record-routed sum. Not part of the smoke
    run."""
    from hypergef_tpu_torch.data.synthetic import random_features
    from hypergef_tpu_torch.sparse.planner import AggregationPlan, plan_tree
    from hypergef_tpu_torch.train.splits import rand_train_test_idx
    from hypergef_tpu_torch.train.trainer import TrainConfig, Trainer
    from hypergef_tpu_torch.utils.profiling import profiler

    # the eager step's kernels, one by one (a replay would show as one graph)
    Trainer = functools.partial(Trainer, compiled=False)  # noqa: N806
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
    # call of the kernel's two passes) beside the pieces of its plain twin,
    # each alone: row gathers by h_edge in three forms, and the direct
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
        "record_routed_dx kernel": lambda: record_routed_dx(g, arg, hgd.record),
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
    # the stream100k HGNN max step (phase 19's): the tree's forward against
    # the record-routed sum
    s100k, bits, tree, _ = build_stream100k()
    xd, yd = random_features(s100k.num_nodes, NFEAT, NCLASS, seed=1)
    c = TrainConfig(model="HGNN", nhid=32, nlayer=2, first_aggr="max", backend="bitstream")
    trainers["stream100k HGNN max bitstream"] = (
        Trainer(c, s100k, xd, yd, plan=AggregationPlan(bitstream=bits, tree=tree),
                device=device), rand_train_test_idx(yd, seed=2)["train"])
    for name, (tr, train_idx) in trainers.items():
        idx = torch.as_tensor(train_idx, device=device)
        for _ in range(5):
            tr.step(idx)
        torch.cuda.synchronize()
        with profiler() as prof:
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
        # the record-routed sum's two passes
        record = sum(e.self_device_time_total for e in rows
                     if "record_won_kernel" in e.key or "record_sum_kernel" in e.key) / steps / 1e3
        print(f"profile {name}: device busy {busy:.5f} ms a step, {count:.1f} kernels a step, "
              f"fused dense kernel {fused:.6f} ms a step ({fused / busy:.4f} of busy), "
              f"record-routed sum {record:.6f} ms a step ({record / busy:.4f} of busy); "
              + json.dumps({e.key[:90]: round(e.self_device_time_total / steps / 1e3, 6)
                            for e in top}), flush=True)



# phase 30, distributed training: four ranks of a gloo world time-share the
# card (the only way to run D > 1 on one card; their times are not a scaling
# figure). (a) the CLI's --shards on coauthor_dblp's dimensions and AllSet's
# widths (the CLI's --synthetic random, whose generator draws 6 members an
# edge on average), (b) the halo exchange with the aligned interior on
# SBM-60k, (c) the int8 dense shard on 20news, (d) data-parallel minibatch on
# phase 29's dblp_shaped graph
DIST_RANKS = 4
DIST_CLI = ["--synthetic", "random", "--n", "41302", "--e", "22363", "--feat", "1425",
            "--classes", "6", "--nhid", "32", "--epochs", "20"]
DIST_CLI_RUNS = {"HGNN sum": ["--model", "HGNN"],
                 "HGNN max": ["--model", "HGNN", "--first-aggr", "max"],
                 "UniGIN": ["--model", "UniGIN"], "UniGCNII": ["--model", "UniGCNII"]}
DIST_F = 32
DIST_STEP_TIMES = 5
DIST_DP_STEPS = 2
# the bars of phase 30's comparisons, each about 10-60 times the largest gap
# seen on an H100 (PERF.md §6): the relative loss gap (seen: 7.5e-6 after
# (a)'s 20 epochs, 2.9e-6 in (b)); the largest gradient or weight difference
# over the largest magnitude of the reference (seen: 1.6e-7 for (a)'s
# initial and (d)'s gradients, 4.9e-7 for (d)'s weights, 1.0e-4 for the
# halo step's gradients, whose bf16 bands sum other edge sets)
DIST_LOSS_RTOL = 1e-4
DIST_GRAD_REL = 1e-5
DIST_HALO_GRAD_REL = 1e-3
DIST_PARAM_REL = 1e-5


def rel_to_max(got, want) -> float:
    """max|got - want| / max|want|."""
    got, want = np.asarray(got), np.asarray(want)
    return float(np.abs(got - want).max() / max(float(np.abs(want).max()), 1e-30))


def _rank_peak_mib(device) -> float:
    return torch.cuda.max_memory_allocated(device) / 2**20


def _step_ms(fn, device, n: int = DIST_STEP_TIMES) -> float:
    """Median ms of ``fn`` between CUDA events (host time included), over
    ``n`` calls: a rank's time while the other ranks share the card."""
    out = []
    for _ in range(n):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        out.append(a.elapsed_time(b))
    return float(np.median(out))


def dist_reference_rank(argvs: dict, dp: tuple) -> dict:
    """Phase 30 (a)'s reference, a one-rank nccl world: the same DistTrainer
    as each CLI run (the CLI's problem, seed and warm-up), its loss and
    gradients at the initial weights and its fit's losses, recorded (the
    default on an nccl rank), beside an eager fit from the same seed; then,
    in this rank, the record-routed sum against its twin over every shard
    of the CLI's 4-way plan; and (d)'s data-parallel steps of one nccl
    rank, recorded and eager (``dp``: cfg, graph, x, y, train_idx, params,
    steps)."""
    from hypergef_tpu_torch.parallel.partition import plan_sharded_aggregation
    from hypergef_tpu_torch.parallel.trainer import DistTrainer
    from hypergef_tpu_torch.train import cli
    from hypergef_tpu_torch.train.dp_minibatch import DPMinibatchTrainer

    args = cli.parse(DIST_CLI)
    hg, x, y = cli.load_problem(args)
    split = cli._split(args, y)
    epochs = args.epochs
    plan = plan_sharded_aggregation(hg, 1)
    out = {}
    for name, (model, aggr) in argvs.items():
        tr = DistTrainer(hg, x, y, nhid=32, model=model, first_aggr=aggr, plan=plan, seed=1)
        mask = tr.train_mask(split["train"])
        init = tr.loss(mask)
        init.backward()
        grads = {k: p.grad.cpu().numpy() for k, p in tr.params.items()}
        init_loss = float(init.detach())
        # the recording must not meet this backward's graph: kept alive, its
        # gradient accumulators stay on the default stream, which a capture
        # on its side stream cannot wait for
        del init
        fit = tr.fit(split["train"], epochs=epochs)
        eager = DistTrainer(hg, x, y, nhid=32, model=model, first_aggr=aggr, plan=plan, seed=1,
                            compiled=False).fit(split["train"], epochs=epochs)
        out[name] = {"init_loss": init_loss, "init_grads": grads,
                     "losses": fit["losses"], "step": fit["step"],
                     "capture_s": fit["capture_s"], "epoch_ms": fit["train_epoch_time_s"] * 1e3,
                     "eager_losses": eager["losses"], "eager_step": eager["step"],
                     "eager_epoch_ms": eager["train_epoch_time_s"] * 1e3}
    # the record-routed sum against its plain twin over each shard's local
    # CSR of the CLI's plan, at the widths of the max runs' two layers
    dev = tr.device
    plan_d = plan_sharded_aggregation(hg, DIST_RANKS)
    out["record_checks"] = []
    for d in range(DIST_RANKS):
        loc = plan_d.local(d, dev)
        for f in (32, args.classes):
            g, arg = stage_record_operands(loc.e_stage, f, 60 + d, dev)
            out["record_checks"].append({"shard": d, **check_record_sum(g, arg, loc.record)})
    # (d) on one nccl rank: recorded data-parallel steps against eager ones
    cfg, dhg, dx, dy, train_idx, params, steps = dp
    dps = [DPMinibatchTrainer(cfg, dhg, dx, dy, train_idx,
                              batch_edges=MB_BATCH_EDGES["dblp_shaped"], params=params,
                              compiled=c) for c in (None, False)]
    out["dp"] = {}
    for form, t in zip(("recorded", "eager"), dps):
        losses = [float(t.step_once()) for _ in range(steps)]
        out["dp"][form] = {"compiled": t.compiled, "losses": losses,
                           "params": {k: p.detach().cpu().numpy()
                                      for k, p in t.model.named_parameters()},
                           "step_ms": _step_ms(t.step_once, dev)}
    return out


def stage_record_operands(stage, f: int, seed: int, device):
    """(g, arg) of a max stage's backward: arg the stage's own first winners
    over a normal x, g normal."""
    from hypergef_tpu_torch.ops.maxops import tree_max_with_arg

    gen = torch.Generator(device=device).manual_seed(seed)
    x = torch.randn((stage.num_inputs, f), generator=gen, device=device)
    _, arg = tree_max_with_arg(x, stage)
    return torch.randn(tuple(arg.shape), generator=gen, device=device), arg.contiguous()


def dist_plain_init_loss(hg, x, y, split, model: str, aggr: str, device):
    """The loss at the CLI's initial weights of a plain single-device
    forward over the whole graph (the nnz oracles of ops/refops.py), and
    the weights' gradients."""
    from hypergef_tpu_torch.ops.refops import hgnn_aggregate_ref, unignn_aggregate_ref
    from hypergef_tpu_torch.parallel.dist_model import (
        init_dist_params, make_forward, masked_nll_terms)

    hgd = hg.device_data(device)
    nclass = int(np.asarray(y).max()) + 1
    fwd = make_forward(model, lambda h, a, _dv: hgnn_aggregate_ref(hgd, h, None, a),
                       lambda h, use_deg, _dv: unignn_aggregate_ref(hgd, h, use_deg), hgd.degV,
                       aggr, nclass=nclass)
    params = {k: v.to(device).requires_grad_(True) for k, v in init_dist_params(
        model, 1, x.shape[1], 32, nclass).items()}
    mask = torch.zeros(hg.num_nodes, device=device)
    mask[torch.as_tensor(split["train"], device=device)] = 1.0
    nll, cnt = masked_nll_terms(fwd(params, torch.as_tensor(x, device=device)),
                                torch.as_tensor(np.asarray(y, np.int64), device=device), mask)
    loss = nll / cnt.clamp_min(1.0)
    loss.backward()
    return float(loss.detach()), {k: p.grad.cpu().numpy() for k, p in params.items()}


def dist_cli_cells(device, card: str, dp: tuple) -> dict:
    """Phase 30 (a): the CLI's --shards 4 --dist-backend gloo, each model
    (eager steps: gloo cannot be recorded), against the one-rank nccl
    world's recorded fit, itself bitwise equal to its eager fit; the nccl
    world also runs (d)'s recorded and eager data-parallel steps (``dp``)."""
    from hypergef_tpu_torch.parallel import launch
    from hypergef_tpu_torch.parallel.launch import spawn
    from hypergef_tpu_torch.train import cli

    args = cli.parse(DIST_CLI)
    hg, x, y = cli.load_problem(args)
    split = cli._split(args, y)
    runs = {name: (argv[argv.index("--model") + 1],
                   argv[argv.index("--first-aggr") + 1] if "--first-aggr" in argv else "sum")
            for name, argv in DIST_CLI_RUNS.items()}
    out = {}
    for name, argv in DIST_CLI_RUNS.items():
        res = cli.main(DIST_CLI + argv + ["--shards", str(DIST_RANKS), "--dist-backend", "gloo"])
        check(res["step"] == "eager" and all(r["step"] == "eager" for r in res["ranks"]),
              f"30a {name}: every gloo rank says its steps ran eagerly")
        out[name] = {"world_s": res["world_s"], "setup_s": res["setup_s"],
                     "timeline": launch.last_world, "step": res["step"],
                     "losses": np.asarray(res["losses"]), "final_loss": res["final_loss"],
                     "test_acc": res.get("test_acc"), "ranks": res["ranks"]}
    t0 = time.perf_counter()
    ref = spawn(dist_reference_rank, 1, backend="nccl", platform="cuda", args=(runs, dp),
                timeout_s=600)[0]
    out["dp_nccl"] = ref["dp"]
    ref_s = time.perf_counter() - t0
    out["nccl1_timeline"] = launch.last_world
    out["record_checks"] = ref["record_checks"]
    for name, (model, aggr) in runs.items():
        cell = out[name]
        plain, plain_grads = dist_plain_init_loss(hg, x, y, split, model, aggr, device)
        r = ref[name]
        check(abs(r["init_loss"] - plain) <= DIST_LOSS_RTOL * abs(plain),
              f"30a {name}: the one-rank world's initial loss {r['init_loss']} within "
              f"{DIST_LOSS_RTOL} of the plain forward's {plain}")
        grad_errs = {k: rel_to_max(r["init_grads"][k], want) for k, want in plain_grads.items()}
        check(max(grad_errs.values()) <= DIST_GRAD_REL,
              f"30a {name}: the one-rank world's initial gradients within {DIST_GRAD_REL}·max "
              f"of the plain backward's ({grad_errs})")
        cell["init_grad_rel_err"] = grad_errs
        check(bool(np.allclose(cell["losses"], r["losses"], rtol=DIST_LOSS_RTOL, atol=0.0)),
              f"30a {name}: the 4-rank losses {cell['losses'][-3:]} within {DIST_LOSS_RTOL} "
              f"of the one-rank nccl world's {r['losses'][-3:]}")
        if aggr == "max":
            check(all(rk["launches"]["recsum"] > 0 for rk in cell["ranks"]),
                  f"30a {name}: every rank launched the record-routed sum")
        check((r["step"], r["eager_step"]) == ("captured", "eager")
              and bool(np.array_equal(r["losses"], r["eager_losses"])),
              f"30a {name}: the one-rank nccl world's recorded fit ({r['step']}) bitwise "
              f"equal to its eager fit")
        cell.update(nccl1_step=r["step"], nccl1_capture_s=r["capture_s"],
                    nccl1_epoch_ms=r["epoch_ms"], nccl1_eager_epoch_ms=r["eager_epoch_ms"],
                    nccl1_recorded_bitwise_eager=True)
        cell.update(plain_init_loss=plain, nccl1_init_loss=r["init_loss"],
                    max_loss_diff_vs_nccl1=float(np.abs(cell["losses"] - r["losses"]).max()),
                    losses=cell["losses"].tolist(), nccl1_losses=np.asarray(r["losses"]).tolist())
    out["nccl1_world_s"] = ref_s
    return out


def dist_halo_rank(plan, x, cot, xf, y, mask, params, nclass: int) -> dict:
    """Phase 30 (b), in each rank: the halo sum and max aggregations and one
    HGNN step on the rank's owned block (the counted main path), then the
    band, argmax and arg-sum kernels against their plain twins on the
    rank's own interior stages, the segment-sum kernel on every inverse
    table of its takes and stages, and the record-routed sum on its
    boundary's local CSR."""
    from hypergef_tpu_torch.ops import aligned_band, aligned_max
    from hypergef_tpu_torch.parallel import comm
    from hypergef_tpu_torch.parallel.comm import all_reduce_grads
    from hypergef_tpu_torch.parallel.halo_aggr import (
        HaloStep, gather_blocks, halo_hgnn_aggregate, own_block, shard_vertex_features)
    from hypergef_tpu_torch.parallel.launch import kernel_launches, reset_kernel_launches
    from hypergef_tpu_torch.parallel.mesh import make_mesh

    mesh = make_mesh()
    dev, rank = mesh.device, mesh.rank
    t0 = time.perf_counter()
    loc = plan.local(rank, dev)
    torch.cuda.synchronize(dev)
    out = {"local_build_s": time.perf_counter() - t0}

    def blk(a, dtype=None):
        t = torch.as_tensor(own_block(plan, shard_vertex_features(plan, a), rank), device=dev)
        return t if dtype is None else t.to(dtype)

    torch.cuda.reset_peak_memory_stats(dev)
    reset_kernel_launches()
    comm.sent_bytes = 0
    for aggr in ("sum", "max"):
        xb = blk(x).requires_grad_(True)
        o = halo_hgnn_aggregate(plan, xb, None, aggr)
        if aggr == "sum":
            out["sent_bytes_a_layer"] = comm.sent_bytes
        (o * blk(cot)).sum().backward()
        n = plan.num_nodes
        out[aggr] = (gather_blocks(o.detach()).cpu().numpy()[:n],
                     gather_blocks(xb.grad).cpu().numpy()[:n])
    step = HaloStep("HGNN", plan, params, nclass=nclass)
    xfb, yb, mb = blk(xf), blk(y[:, None])[:, 0].long(), blk(mask[:, None])[:, 0]
    share, loss = step.loss_terms(xfb, yb, mb)
    share.backward()
    all_reduce_grads(step.params.values(), mesh.group)
    out["step"] = {"loss": float(loss),
                   "grads": {k: p.grad.cpu().numpy() for k, p in step.params.items()}}
    step.optimizer.step()
    torch.cuda.synchronize(dev)
    out["launches"] = kernel_launches()
    out["peak_mib"] = _rank_peak_mib(dev)
    out["step_ms"] = _step_ms(lambda: step(xfb, yb, mb), dev)
    # the kernels against their plain twins on this rank's stages (not counted)
    g = torch.Generator(device=dev).manual_seed(50 + rank)
    xs = torch.randn((plan.n_own, DIST_F), device=dev, generator=g)
    gs = torch.randn((plan.e_int_pad, DIST_F), device=dev, generator=g)
    errs = {}
    for name, st, v in (("band fwd", loc.int_fwd, xs), ("band bwd", loc.int_bwd, gs)):
        k, p = aligned_band.aligned_band(v, st), aligned_band.aligned_band_plain(v, st)
        errs[name] = float((k - p).abs().max())
        check(errs[name] <= 1e-5 * float(p.abs().max()) + 1e-5,
              f"rank {rank}: {name} kernel within 1e-5 of its twin ({errs[name]})")
    val, arg = aligned_max.aligned_masked_argmax(xs, loc.int_fwd)
    pval, parg = aligned_max.aligned_max_plain(xs, loc.int_fwd)
    check(torch.equal(val, pval) and torch.equal(arg, parg),
          f"rank {rank}: the argmax kernel bitwise equal to its twin")
    errs["argmax"] = float((val - pval).abs().max())
    k = aligned_max.aligned_masked_argsum(gs, arg, loc.int_bwd)
    p = aligned_max.aligned_argsum_plain(gs, arg, loc.int_bwd)
    errs["argsum"] = float((k - p).abs().max())
    check(errs["argsum"] <= 1e-6 * float(p.abs().max()) + 1e-6,
          f"rank {rank}: the arg-sum kernel within 1e-6 of its twin ({errs['argsum']})")
    # the segment-sum kernel over every inverse table of the rank's takes and
    # tree stages (the halo's backward), and the record-routed sum over the
    # boundary's local CSR (the max backward), at the path's width
    tables = {name: getattr(loc, name).inverse
              for name in ("halo_send", "halo_take", "asm", "send")}
    for name in ("bnd", "v", "own"):
        st = getattr(loc, name)
        tables.update({f"{name} level {i}": t for i, t in enumerate(st.inverse_levels)})
        tables[f"{name} final"] = st.inverse_final
    seg = {name: check_segsum(t, DIST_F, 70 + i, dev)["max_abs_err"]
           for i, (name, t) in enumerate(tables.items()) if t.nnz}
    errs["segsum"] = max(seg.values())
    out["segsum_tables"] = len(seg)
    g, arg = stage_record_operands(loc.bnd.stage, DIST_F, 80 + rank, dev)
    errs["recsum"] = check_record_sum(g, arg, loc.bnd_record)["max_abs_err"]
    out["kernel_errs"] = errs
    return out


def dist_halo_cell(aligned: dict, device) -> dict:
    """Phase 30 (b): the halo world on SBM-60k, aligned interior."""
    from hypergef_tpu_torch.data.synthetic import random_features
    from hypergef_tpu_torch.ops import fused
    from hypergef_tpu_torch.parallel.dist_model import (
        init_dist_params, make_forward, masked_nll_terms)
    from hypergef_tpu_torch.parallel import launch
    from hypergef_tpu_torch.parallel.halo import plan_halo
    from hypergef_tpu_torch.parallel.launch import spawn
    from hypergef_tpu_torch.sparse.planner import AggregationPlan

    hg = aligned["sbm"]
    t0 = time.perf_counter()
    plan = plan_halo(hg, DIST_RANKS, local_form="aligned")
    plan_s = time.perf_counter() - t0
    check(plan.local_form == "aligned", "30b: the halo plan took the aligned interior")
    rng = np.random.default_rng(30)
    x = rng.normal(size=(hg.num_nodes, DIST_F)).astype(np.float32)
    cot = rng.normal(size=(hg.num_nodes, DIST_F)).astype(np.float32)
    xf, y = random_features(hg.num_nodes, NFEAT, NCLASS, seed=1)
    mask = (np.arange(hg.num_nodes) % 2 == 0).astype(np.float32)
    params = init_dist_params("HGNN", 3, NFEAT, 32, NCLASS)
    t0 = time.perf_counter()
    ranks = spawn(dist_halo_rank, DIST_RANKS, backend="gloo", platform="cuda",
                  args=(plan, x, cot, xf, np.asarray(y, np.int64), mask, params, NCLASS),
                  timeout_s=600)
    world_s = time.perf_counter() - t0
    timeline = launch.last_world
    # the single-device aligned kernel route on the same inputs
    kplan = AggregationPlan(aligned=dataclasses.replace(aligned["plan"], form="pallas_auto"))
    hgd = hg.device_data(device)
    out = {"plan_s": plan_s, "world_s": world_s, "timeline": timeline,
           "interior_fraction": plan.interior_fraction(),
           "comm_fraction": plan.comm_fraction(),
           "halo_comm_fraction": plan.halo_comm_fraction(),
           "exchange_bytes_a_layer_f32": plan.exchange_bytes(DIST_F),
           "sent_bytes_a_layer": [r["sent_bytes_a_layer"] for r in ranks],
           "ranks": [{k: r[k] for k in ("local_build_s", "peak_mib", "step_ms", "launches",
                                        "kernel_errs", "segsum_tables")} for r in ranks]}
    for aggr in ("sum", "max"):
        xt = torch.tensor(x, device=device, requires_grad=True)
        o = fused.hgnn_aggregate(hgd, xt, None, aggr, backend="aligned", plan=kplan)
        (o * torch.as_tensor(cot, device=device)).sum().backward()
        want, want_dx = o.detach().cpu().numpy(), xt.grad.cpu().numpy()
        got, got_dx = ranks[0][aggr]
        rel = float(np.abs(got - want).max() / np.abs(want).max())
        rel_dx = float(np.abs(got_dx - want_dx).max() / np.abs(want_dx).max())
        # the bf16 bar of JAX's own halo check (tests/test_halo.py:255)
        check(rel <= 5e-3, f"30b {aggr}: halo output within 5e-3·max of the kernel route ({rel})")
        check(rel_dx <= 1e-2, f"30b {aggr}: halo gradient within 1e-2·max ({rel_dx})")
        out[aggr] = {"max_rel_err": rel, "grad_max_rel_err": rel_dx}
    fwd = make_forward("HGNN", lambda h, a, _dv: fused.hgnn_aggregate(
        hgd, h, None, a, backend="aligned", plan=kplan), None, None, "sum", nclass=NCLASS)
    ps = {k: v.to(device).requires_grad_(True) for k, v in params.items()}
    nll, cnt = masked_nll_terms(fwd(ps, torch.as_tensor(xf, device=device)),
                                torch.as_tensor(np.asarray(y, np.int64), device=device),
                                torch.as_tensor(mask, device=device))
    loss = nll / cnt
    loss.backward()
    got = ranks[0]["step"]
    loss = float(loss.detach())
    check(abs(got["loss"] - loss) <= DIST_LOSS_RTOL * abs(loss),
          f"30b step: halo loss {got['loss']} within {DIST_LOSS_RTOL} of the kernel route's "
          f"{loss}")
    grad_errs = {k: rel_to_max(got["grads"][k], p.grad.cpu().numpy()) for k, p in ps.items()}
    check(max(grad_errs.values()) <= DIST_HALO_GRAD_REL,
          f"30b step: the halo gradients within {DIST_HALO_GRAD_REL}·max of the kernel "
          f"route's ({grad_errs})")
    out["step"] = {"loss": got["loss"], "kernel_route_loss": loss, "grad_rel_err": grad_errs}
    for r in ranks:
        for kname in ("band", "argmax", "argsum", "segsum", "recsum"):
            check(r["launches"][kname] > 0, f"30b: every rank launched {kname}")
    # phase 31 (a) runs this world's plan and x serialized on one device
    aligned["halo_world"] = {"plan": plan, "x": x,
                             "outputs": {aggr: ranks[0][aggr][0] for aggr in ("sum", "max")}}
    return out


def dist_dense_rank(plan, x, cot, degv) -> dict:
    """Phase 30 (c), in each rank: the dense shard's aggregation and its
    gradient, and the rank's time for one (forward and backward)."""
    from hypergef_tpu_torch.parallel.dense_shard import sharded_dense_hgnn_aggregate
    from hypergef_tpu_torch.parallel.launch import kernel_launches, reset_kernel_launches
    from hypergef_tpu_torch.parallel.mesh import make_mesh

    mesh = make_mesh()
    dev = mesh.device
    torch.cuda.reset_peak_memory_stats(dev)
    reset_kernel_launches()
    ct = torch.as_tensor(cot, device=dev)
    dv = torch.as_tensor(degv, device=dev)

    def once():
        xt = torch.tensor(x, device=dev, requires_grad=True)
        o = sharded_dense_hgnn_aggregate(plan, xt, None, "sum", degV=dv)
        (o * ct).sum().backward()
        return o, xt

    o, xt = once()
    torch.cuda.synchronize(dev)
    return {"out": o.detach().cpu().numpy(), "dx": xt.grad.cpu().numpy(),
            "launches": kernel_launches(), "peak_mib": _rank_peak_mib(dev),
            "step_ms": _step_ms(once, dev)}


def dist_dense_cell(device) -> dict:
    """Phase 30 (c): the int8 dense shard on 20news, four ranks, against
    the single-device dense route."""
    from hypergef_tpu_torch.ops import fused
    from hypergef_tpu_torch.parallel import launch
    from hypergef_tpu_torch.parallel.dense_shard import plan_sharded_dense
    from hypergef_tpu_torch.parallel.launch import spawn
    from hypergef_tpu_torch.sparse.planner import AggregationPlan

    hg = make_graph("20news")
    t0 = time.perf_counter()
    plan = plan_sharded_dense(hg, DIST_RANKS)
    plan_s = time.perf_counter() - t0
    rng = np.random.default_rng(31)
    x = rng.normal(size=(hg.num_nodes, DIST_F)).astype(np.float32)
    cot = rng.normal(size=(hg.num_nodes, DIST_F)).astype(np.float32)
    t0 = time.perf_counter()
    ranks = spawn(dist_dense_rank, DIST_RANKS, backend="gloo", platform="cuda",
                  args=(plan, x, cot, hg.degV), timeout_s=600)
    world_s = time.perf_counter() - t0
    xt = torch.tensor(x, device=device, requires_grad=True)
    o = fused.hgnn_aggregate(hg.device_data(device), xt, None, "sum", backend="dense",
                             plan=AggregationPlan.dense_plan(hg, device))
    (o * torch.as_tensor(cot, device=device)).sum().backward()
    out = {"plan_s": plan_s, "world_s": world_s, "timeline": launch.last_world,
           "table_bytes_per_rank": plan.table_bytes_per_device(),
           "exchange_bytes_a_layer_f32": 2 * hg.num_nodes * DIST_F * 4,
           "ranks": [{k: r[k] for k in ("peak_mib", "step_ms", "launches")} for r in ranks]}
    for key, want in (("out", o.detach().cpu().numpy()), ("dx", xt.grad.cpu().numpy())):
        got = ranks[0][key]
        err = float(np.abs(got - want).max())
        # the bar of phase 2's dense kernel (two bf16 roundings)
        check(bool(np.allclose(got, want, rtol=1e-2, atol=1e-2 * np.abs(want).max())),
              f"30c {key}: the dense shard within 1e-2 of the dense route ({err})")
        out[f"{key}_max_abs_err"] = err
    return out


def dist_dp_rank(cfg, hg, x, y, train_idx, params, steps: int) -> dict:
    """Phase 30 (d), in each rank: ``steps`` data-parallel steps (the
    counted main path), then the rank's time for more."""
    from hypergef_tpu_torch.parallel.launch import kernel_launches, reset_kernel_launches
    from hypergef_tpu_torch.train.dp_minibatch import DPMinibatchTrainer

    tr = DPMinibatchTrainer(cfg, hg, x, y, train_idx, batch_edges=MB_BATCH_EDGES["dblp_shaped"],
                            params=params)
    dev = tr.device
    torch.cuda.reset_peak_memory_stats(dev)
    reset_kernel_launches()
    losses, grads = [], []
    for _ in range(steps):
        losses.append(float(tr.step_once()))
        grads.append({k: p.grad.cpu().numpy() for k, p in tr.model.named_parameters()})
    launches = kernel_launches()
    params = {k: p.detach().cpu().numpy() for k, p in tr.model.named_parameters()}
    return {"losses": losses, "grads": grads, "params": params, "launches": launches,
            "peak_mib": _rank_peak_mib(dev), "step_ms": _step_ms(tr.step_once, dev),
            "step": "captured" if tr.compiled else "eager"}


def dist_dp_problem(device):
    """Phase 30 (d)'s problem: dblp_shaped, dropout 0, and the seeded
    weights (cfg, graph, x, y, split, params)."""
    from hypergef_tpu_torch.models.zoo import build_model
    from hypergef_tpu_torch.train.trainer import TrainConfig

    hg, x, y, split = minibatch_problem("dblp_shaped", None)
    cfg = TrainConfig(model="HGNN", nhid=32, seed=3, dropout=0.0, input_drop=0.0)
    nclass = int(np.asarray(y).max()) + 1
    model = build_model("HGNN", nfeat=x.shape[1], nhid=32, nclass=nclass,
                        num_edges=hg.num_edges, dropout=0.0, input_drop=0.0, backend="cumsum",
                        seed=cfg.seed, device=device)
    params = {k: v.detach().cpu() for k, v in model.state_dict().items()}
    return cfg, hg, x, y, split, params


def dist_dp_cell(device, problem, nccl: dict) -> dict:
    """Phase 30 (d): DPMinibatchTrainer on dblp_shaped, 512 edges a batch,
    four gloo ranks (eager), against the unsharded step on the same
    batches; and (``nccl``, from (a)'s one-rank nccl world) recorded
    steps bitwise equal to eager ones."""
    from hypergef_tpu_torch.data.sampling import HyperedgeSampler
    from hypergef_tpu_torch.models.zoo import build_model
    from hypergef_tpu_torch.parallel import launch
    from hypergef_tpu_torch.parallel.launch import spawn
    from hypergef_tpu_torch.train.trainer import init_adam_state, make_optimizer

    rec, eag = nccl["recorded"], nccl["eager"]
    check(rec["compiled"] and not eag["compiled"] and rec["losses"] == eag["losses"]
          and all(np.array_equal(rec["params"][k], v) for k, v in eag["params"].items()),
          f"30d: one nccl rank's recorded steps bitwise equal to its eager ones "
          f"({rec['losses']} against {eag['losses']})")
    cfg, hg, x, y, split, params = problem
    nclass = int(np.asarray(y).max()) + 1
    model = build_model("HGNN", nfeat=x.shape[1], nhid=32, nclass=nclass,
                        num_edges=hg.num_edges, dropout=0.0, input_drop=0.0, backend="cumsum",
                        seed=cfg.seed, device=device)
    model.load_state_dict({k: v.to(device) for k, v in params.items()})
    steps = DIST_DP_STEPS
    t0 = time.perf_counter()
    ranks = spawn(dist_dp_rank, DIST_RANKS, backend="gloo", platform="cuda",
                  args=(cfg, hg, x, y, split["train"], params, steps), timeout_s=600)
    world_s = time.perf_counter() - t0
    timeline = launch.last_world
    # the unsharded step: the same draws, every batch's NLL over the count of all
    sampler = HyperedgeSampler(hg, MB_BATCH_EDGES["dblp_shaped"], seed=0, device=device)
    pad = sampler.probe_pad_shapes()
    sampler.sample_batch(pad_to=pad)
    opt = make_optimizer(model.parameters(), cfg.lr, cfg.wd, capturable=True)
    init_adam_state(opt)
    xd = torch.as_tensor(x, device=device)
    yd = torch.as_tensor(np.asarray(y, np.int64), device=device)
    tm = torch.zeros(hg.num_nodes, device=device)
    tm[torch.as_tensor(split["train"], device=device)] = 1.0
    want, want_grads = [], []
    model.train()
    for _ in range(steps):
        batches = [sampler.sample_batch(pad_to=pad) for _ in range(DIST_RANKS)]
        opt.zero_grad(set_to_none=True)
        nll, cnt = 0.0, 0.0
        for b in batches:
            z = model(xd.index_select(0, b.rows), b.data, None)
            m = b.row_mask * tm.index_select(0, b.rows)
            nll = nll - (z.gather(1, yd.index_select(0, b.rows)[:, None])[:, 0] * m).sum()
            cnt = cnt + m.sum()
        loss = nll / cnt.clamp_min(1.0)
        loss.backward()
        want_grads.append({k: p.grad.cpu().numpy() for k, p in model.named_parameters()})
        opt.step()
        want.append(float(loss))
    got = ranks[0]["losses"]
    check(bool(np.allclose(got, want, rtol=DIST_LOSS_RTOL, atol=0.0)),
          f"30d: the data-parallel losses {got} within {DIST_LOSS_RTOL} of the unsharded "
          f"step's {want}")
    # every rank's summed gradients of every step, and its weights after the
    # steps, against the unsharded step's
    want_params = {k: p.detach().cpu().numpy() for k, p in model.named_parameters()}
    grad_err = max(rel_to_max(r["grads"][i][k], w[k]) for r in ranks
                   for i, w in enumerate(want_grads) for k in w)
    param_err = max(rel_to_max(r["params"][k], w) for r in ranks for k, w in want_params.items())
    check(grad_err <= DIST_GRAD_REL,
          f"30d: every rank's gradients within {DIST_GRAD_REL}·max of the unsharded step's "
          f"({grad_err})")
    check(param_err <= DIST_PARAM_REL,
          f"30d: every rank's weights after {steps} steps within {DIST_PARAM_REL}·max of the "
          f"unsharded step's ({param_err})")
    check(all(r["step"] == "eager" for r in ranks), "30d: the gloo ranks step eagerly")
    return {"world_s": world_s, "timeline": timeline, "losses": got, "unsharded_losses": want,
            "grad_rel_err": grad_err, "param_rel_err": param_err,
            "nccl_recorded_bitwise_eager": True, "nccl_losses": rec["losses"],
            "nccl_step_ms": {"recorded": rec["step_ms"], "eager": eag["step_ms"]},
            "ranks": [{k: r[k] for k in ("peak_mib", "step_ms", "launches", "step")}
                      for r in ranks]}


def dist_phase(device, card: str, aligned: dict) -> dict:
    """Phase 30: the four distributed cells; every rank's launches summed."""
    torch.cuda.empty_cache()
    out = {}
    dp = dist_dp_problem(device)
    cfg, hg, x, y, split, params = dp
    nccl_dp = {}  # (d)'s nccl steps, run in (a)'s one-rank nccl world

    def cli_cells():
        res = dist_cli_cells(device, card, (cfg, hg, x, y, split["train"], params,
                                            DIST_DP_STEPS))
        nccl_dp.update(res.pop("dp_nccl"))
        return res

    for key, fn in (("a", cli_cells),
                    ("b", lambda: dist_halo_cell(aligned, device)),
                    ("c", lambda: dist_dense_cell(device)),
                    ("d", lambda: dist_dp_cell(device, dp, nccl_dp))):
        t0 = time.perf_counter()
        out[key] = fn()
        out[key]["phase_s"] = time.perf_counter() - t0
        print(f"phase 30 {key} (card {card}; {DIST_RANKS} gloo ranks time-sharing one card: "
              f"their times are not a scaling figure): {json.dumps(out[key])}", flush=True)
    launches = {}
    cells = [out["a"][k] for k in DIST_CLI_RUNS] + [out[k] for k in "bcd"]
    for cell in cells:
        for r in cell["ranks"]:
            for k, v in r["launches"].items():
                launches[k] = launches.get(k, 0) + v
    out["launches"] = launches
    print(f"phase 30 launches, every rank of every world: {json.dumps(launches)}; gloo took "
          f"CUDA tensors for all_reduce, all_to_all_single and all_gather (no host staging)",
          flush=True)
    return out


# phase 31, the serialized halo pair and the feature mesh axis. (a) phase
# 30 (b)'s SBM-60k plan and x run serialized on the card, one shard at a
# time, against that world's outputs; (b) the serialized two-layer HGNN step
# (F = 32, nhid 32) on SBM-60k's tree and aligned plans against the plain
# step, and three AdamW epochs; (c) a graph a fortieth the size of
# experiments/scale_serialized.py's (community_hypergraph, 2.5M incidences,
# D = 8; 10M until phase 33 and 5M until phase 34 needed its time) forward
# and step, with the
# card's peak memory; (d) a 2 x 2 (e, f)
# grid of gloo ranks: the CLI's --shards 2 --feature-shards 2 on phase 30
# (a)'s problem, and the feature-sharded dense shard on 20news
SERIAL_D = 4
SERIAL_F = 32
SERIAL_CPAD = max(NCLASS, 8)  # the second layer's width, JAX's padded classes
SERIAL_EPOCHS = 3
SERIAL_SCALE = dict(n_nodes=500_000, n_edges=250_000, n_comm=1000, avg=10.0, noise=0.01,
                    seed=0)
SERIAL_SCALE_D = 8
SERIAL_PLAN_LIMIT_S = 120.0
FEATURE_GRID = (2, 2)
# the bars of phase 31's comparisons with the plain unsharded f32 step, each
# 10-20 times the largest gap seen on an H100 (PERF.md §6): the relative
# loss gap (seen 6.8e-6); the largest gradient difference over the largest
# magnitude of the reference with tree interiors (seen 5.6e-7) and with the
# aligned interior, whose band kernel rounds its operands to bf16 (seen
# 1.9e-3 at SBM-60k, 2.2e-4 at 10M incidences), and the weights after three
# AdamW epochs on the aligned plan (seen 2.0e-3)
SERIAL_LOSS_RTOL = 1e-4
SERIAL_GRAD_REL = 1e-5
SERIAL_BF16_GRAD_REL = 2e-2
SERIAL_BF16_PARAM_REL = 2e-2


def serial_init(f: int, nhid: int, nclass: int, seed: int) -> dict:
    """serialized_halo_train_epochs' initial weights (JAX's draw)."""
    rng = np.random.default_rng(seed)
    return {"w1": (rng.normal(size=(f, nhid)) / np.sqrt(f)).astype(np.float32),
            "w2": (rng.normal(size=(nhid, max(nclass, 8))) / np.sqrt(nhid)).astype(np.float32)}


def serial_plain_loss(hgd, params, x, y, mask):
    """The unsharded two-layer HGNN over the nnz oracles of ops/refops.py:
    its masked NLL over every column (the serialized step's loss)."""
    from hypergef_tpu_torch.ops.refops import hgnn_aggregate_ref

    h = torch.relu(hgnn_aggregate_ref(hgd, x @ params["w1"]))
    z = hgnn_aggregate_ref(hgd, h @ params["w2"])
    picked = torch.log_softmax(z, dim=-1).gather(1, y[:, None])[:, 0]
    return -(picked * mask).sum() / mask.sum().clamp_min(1.0)


def serial_plain_step(hg, params, x, y, mask, device):
    """The plain step's loss and weight gradients, on the card."""
    hgd = hg.device_data(device)
    ps = {k: torch.as_tensor(v, device=device).requires_grad_(True) for k, v in params.items()}
    loss = serial_plain_loss(hgd, ps, torch.as_tensor(x, device=device),
                             torch.as_tensor(np.asarray(y, np.int64), device=device),
                             torch.as_tensor(mask, device=device))
    loss.backward()
    return float(loss.detach()), {k: p.grad.cpu().numpy() for k, p in ps.items()}


def check_turn_kernels(tables, widths, seed: int, device) -> dict:
    """Every kernel of a serialized run's shard turns against its plain
    twin, on each shard's tables as a turn holds them (put on the card from
    pinned host memory), at each width of the path: the band kernel over
    the aligned interior's V→E and E→V tables, the masked argmax over the
    V→E table, and the segment-sum kernel over every inverse table of the
    turn's takes and tree stages (a step's backward). Operands are drawn on
    the card. Not counted: called outside the window the launches are read
    in. Returns each kernel's largest error and the tables checked."""
    from hypergef_tpu_torch.ops import aligned_band, aligned_max

    plan = tables.plan
    aligned = plan.local_form == "aligned"
    errs = {"band": [], "argmax": [], "segsum": []} if aligned else {"segsum": []}
    n_seg = 0
    for d in range(plan.n_shards):
        loc = tables.local(d)
        inv = [getattr(loc, n).inverse for n in ("halo_send", "halo_take", "asm", "send")]
        for n in ("bnd", "v", "own") + (() if aligned else ("int_tree",)):
            st = getattr(loc, n)
            inv += list(st.inverse_levels) + [st.inverse_final]
        inv = [t for t in inv if t.nnz]
        for f in widths:
            g = torch.Generator(device=device).manual_seed(seed + 100 * d + f)
            if aligned:
                xs = torch.randn((plan.n_own, f), device=device, generator=g)
                gs = torch.randn((plan.e_int_pad, f), device=device, generator=g)
                for name, st, v in (("fwd", loc.int_fwd, xs), ("bwd", loc.int_bwd, gs)):
                    k, p = aligned_band.aligned_band(v, st), aligned_band.aligned_band_plain(v, st)
                    err = float((k - p).abs().max())
                    check(err <= 1e-5 * float(p.abs().max()) + 1e-5,
                          f"shard {d}: the band kernel ({name}, F = {f}) within 1e-5 of its "
                          f"twin ({err})")
                    errs["band"].append(err)
                val, arg = aligned_max.aligned_masked_argmax(xs, loc.int_fwd)
                pval, parg = aligned_max.aligned_max_plain(xs, loc.int_fwd)
                check(torch.equal(val, pval) and torch.equal(arg, parg),
                      f"shard {d}: the argmax kernel (F = {f}) bitwise equal to its twin")
                errs["argmax"].append(float((val - pval).abs().max()))
            rows = torch.randn((max(t.num_inputs for t in inv), f), device=device, generator=g)
            for t in inv:
                errs["segsum"].append(check_segsum(t, f, 0, device,
                                                   x=rows[:t.num_inputs])["max_abs_err"])
            n_seg += len(inv)
        del loc
    return {**{k: max(v) for k, v in errs.items()}, "segsum_tables": n_seg,
            "widths": list(widths)}


def serial_forward_cell(device, world: dict) -> dict:
    """Phase 31 (a): phase 30 (b)'s plan and x serialized, sum and max,
    against the world's outputs; each shard's kernels against their twins
    at the path's shapes after the tables' round trip (not counted)."""
    from hypergef_tpu_torch.parallel.launch import kernel_launches, reset_kernel_launches
    from hypergef_tpu_torch.parallel.serial_halo import ShardTables, serialized_halo_forward

    plan, x = world["plan"], world["x"]
    check(plan.local_form == "aligned" and plan.n_shards == SERIAL_D,
          "31a: phase 30 (b)'s plan, D = 4, aligned interior")
    t0 = time.perf_counter()
    tables = ShardTables(plan, device)
    out = {"tables_s": time.perf_counter() - t0, "tables_build_s": tables.build_s,
           "table_bytes": tables.nbytes, "combine_table_bytes": tables.combine_nbytes}
    torch.cuda.synchronize()
    reset_kernel_launches()
    for aggr in ("sum", "max"):
        stats = {}
        got = serialized_halo_forward(plan, x, aggr, device=device, tables=tables, stats=stats)
        want = world["outputs"][aggr]
        same = bool(np.array_equal(got, want))
        gap = float(np.abs(got - want).max())
        cell = {"bitwise_equal_world": same, "max_abs_diff": gap, "stats": stats}
        if not same:
            # the owner blocks whose rows differ, each the combine of one shard
            rows = np.nonzero(np.abs(got - want).max(axis=1))[0]
            cell["differing_owners"] = sorted({int(r) // plan.n_own for r in rows})
            print(f"31a {aggr}: serialized output differs from the world's by {gap} in owner "
                  f"blocks {cell['differing_owners']} (the ops of those owners' combines and "
                  f"of the shards whose partials they sum)", flush=True)
        check(same or gap <= 1e-6 * float(np.abs(want).max()),
              f"31a {aggr}: the serialized output equals the world's ({gap})")
        out[aggr] = cell
    torch.cuda.synchronize()
    out["launches"] = kernel_launches()
    check(out["launches"]["band"] > 0 and out["launches"]["argmax"] > 0,
          "31a: the serialized forward launched the band and argmax kernels")
    # the layers of a step run at nhid and at the padded classes
    out["kernel_errs"] = check_turn_kernels(tables, (SERIAL_F, SERIAL_CPAD), 40, device)
    return out


def serial_train_cell(device, hg, aligned_plan) -> dict:
    """Phase 31 (b): the serialized step on SBM-60k's tree and aligned
    plans against the plain step on the same weights; two runs bitwise
    equal; the segment-sum kernel against its twin on every inverse table
    of every shard's turn (not counted); three AdamW epochs against the
    same epochs unsharded."""
    from hypergef_tpu_torch.parallel.halo import plan_halo
    from hypergef_tpu_torch.parallel.launch import kernel_launches, reset_kernel_launches
    from hypergef_tpu_torch.parallel.serial_halo import ShardTables
    from hypergef_tpu_torch.parallel.serial_halo_train import (
        serialized_halo_train_epochs, serialized_halo_train_step)

    rng = np.random.default_rng(32)
    x = rng.normal(size=(hg.num_nodes, SERIAL_F)).astype(np.float32)
    y = rng.integers(0, NCLASS, size=hg.num_nodes)
    mask = (np.arange(hg.num_nodes) % 2 == 0).astype(np.float32)
    params = serial_init(SERIAL_F, 32, NCLASS, seed=4)
    want_loss, want = serial_plain_step(hg, params, x, y, mask, device)
    t0 = time.perf_counter()
    plans = {"tree": plan_halo(hg, SERIAL_D, local_form="tree"), "aligned": aligned_plan}
    out = {"tree_plan_s": time.perf_counter() - t0, "plain_loss": want_loss}
    launches = {}
    for form, plan in plans.items():
        check(plan.local_form == form, f"31b: the {form} plan took its interior")
        tables = ShardTables(plan, device)
        torch.cuda.synchronize()
        reset_kernel_launches()
        t0 = time.perf_counter()
        loss, grads = serialized_halo_train_step(plan, params, x, y, mask, device=device,
                                                 tables=tables)
        step_s = time.perf_counter() - t0
        torch.cuda.synchronize()
        launched = kernel_launches()
        for k, v in launched.items():
            launches[k] = launches.get(k, 0) + v
        again = serialized_halo_train_step(plan, params, x, y, mask, device=device,
                                           tables=tables)
        check(again[0] == loss and all(np.array_equal(again[1][k], grads[k]) for k in grads),
              f"31b {form}: two runs of the step give bitwise equal gradients")
        loss_gap = abs(loss - want_loss) / abs(want_loss)
        grad_errs = {k: rel_to_max(grads[k], want[k]) for k in want}
        check(loss_gap <= SERIAL_LOSS_RTOL,
              f"31b {form}: loss {loss} within {SERIAL_LOSS_RTOL} of the plain step's {want_loss}")
        bar = SERIAL_GRAD_REL if form == "tree" else SERIAL_BF16_GRAD_REL
        check(max(grad_errs.values()) <= bar,
              f"31b {form}: gradients within {bar}·max of the plain step's ({grad_errs})")
        kerr = check_turn_kernels(tables, (SERIAL_F, SERIAL_CPAD), 90, device)
        out[form] = {"loss": loss, "loss_rel_gap": loss_gap, "grad_rel_err": grad_errs,
                     "step_s": step_s, "launches": launched, "kernel_errs": kerr,
                     "tables_build_s": tables.build_s, "table_bytes": tables.nbytes}
        check(launched["segsum"] > 0, f"31b {form}: the step launched the segment sum")
    check(launches["band"] > 0, "31b: the aligned step launched the band kernel")
    out["launches"] = launches
    # three epochs of AdamW, serialized (aligned plan) against unsharded
    reset_kernel_launches()
    t0 = time.perf_counter()
    got, losses = serialized_halo_train_epochs(aligned_plan, x, y, mask, 32, NCLASS,
                                               epochs=SERIAL_EPOCHS, seed=5, device=device)
    epochs_s = time.perf_counter() - t0
    for k, v in kernel_launches().items():
        launches[k] += v
    hgd = hg.device_data(device)
    ps = {k: torch.as_tensor(v, device=device).requires_grad_(True)
          for k, v in serial_init(SERIAL_F, 32, NCLASS, seed=5).items()}
    opt = torch.optim.AdamW(list(ps.values()), lr=0.01, betas=(0.9, 0.999), eps=1e-8,
                            weight_decay=5e-4)
    xd, yd, md = (torch.as_tensor(x, device=device),
                  torch.as_tensor(np.asarray(y, np.int64), device=device),
                  torch.as_tensor(mask, device=device))
    want_losses = []
    for _ in range(SERIAL_EPOCHS):
        opt.zero_grad(set_to_none=True)
        loss = serial_plain_loss(hgd, ps, xd, yd, md)
        loss.backward()
        opt.step()
        want_losses.append(float(loss.detach()))
    check(bool(np.allclose(losses, want_losses, rtol=SERIAL_LOSS_RTOL, atol=0.0)),
          f"31b epochs: losses {losses} within {SERIAL_LOSS_RTOL} of unsharded {want_losses}")
    param_err = {k: rel_to_max(got[k], p.detach().cpu().numpy()) for k, p in ps.items()}
    check(max(param_err.values()) <= SERIAL_BF16_PARAM_REL,
          f"31b epochs: weights within {SERIAL_BF16_PARAM_REL}·max of unsharded ({param_err})")
    out["epochs"] = {"losses": losses, "unsharded_losses": want_losses,
                     "param_rel_err": param_err, "wall_s": epochs_s}
    return out


def _peak_delta(fn, device):
    """fn()'s result and the card's peak bytes above what was allocated
    before it."""
    torch.cuda.synchronize(device)
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated(device)
    torch.cuda.reset_peak_memory_stats(device)
    res = fn()
    torch.cuda.synchronize(device)
    return res, torch.cuda.max_memory_allocated(device) - base


def serial_scale_problem():
    """Phase 31 (c)'s host work, NumPy only: the graph, its edges sorted by
    median member (as experiments/scale_serialized.py), and the D = 8 halo
    plan with the aligned interior; halved while the plan takes longer
    than SERIAL_PLAN_LIMIT_S. Nothing else runs beside it, so no phase's
    times share the host with it."""
    from hypergef_tpu_torch.data.synthetic import community_hypergraph
    from hypergef_tpu_torch.parallel.halo import plan_halo
    from hypergef_tpu_torch.sparse.reorder import apply_vertex_order

    cfg = dict(SERIAL_SCALE)
    while True:
        t0 = time.perf_counter()
        hg = community_hypergraph(**cfg)
        gen_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        # edges sorted by median member, as experiments/scale_serialized.py
        hg, _ = apply_vertex_order(hg, np.arange(hg.num_nodes), sort_edges=True)
        order_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        plan = plan_halo(hg, SERIAL_SCALE_D, local_form="aligned")
        plan_s = time.perf_counter() - t0
        if plan_s <= SERIAL_PLAN_LIMIT_S:
            break
        print(f"31c: the plan of {cfg} took {plan_s} s (> {SERIAL_PLAN_LIMIT_S}): halving",
              flush=True)
        cfg = {**cfg, "n_nodes": cfg["n_nodes"] // 2, "n_edges": cfg["n_edges"] // 2,
               "n_comm": cfg["n_comm"] // 2}
    return hg, plan, {"graph": {**cfg, "nnz": hg.nnz}, "gen_s": gen_s, "order_s": order_s,
                      "plan_s": plan_s}


def serial_scale_cell(device, problem) -> dict:
    """Phase 31 (c): community_hypergraph at 2.5M incidences, D = 8, aligned
    interior (``problem``: serial_scale_problem's result): one forward and
    one step, each shard's host build, staging and device time, the
    exchange bytes, the card's peak against the bound and against all
    shards' tables together; the forward and the step against the plain
    unsharded forward and step on the card."""
    from hypergef_tpu_torch.ops.refops import hgnn_aggregate_ref
    from hypergef_tpu_torch.parallel.launch import kernel_launches, reset_kernel_launches
    from hypergef_tpu_torch.parallel.serial_halo import (
        ShardTables, peak_bound, serialized_halo_forward)
    from hypergef_tpu_torch.parallel.serial_halo_train import serialized_halo_train_step

    hg, plan, info = problem
    check(plan.local_form == "aligned", "31c: the plan took the aligned interior")
    out = {**info, "interior_fraction": plan.interior_fraction(),
           "exchange_bytes_a_layer_padded": plan.exchange_bytes(SERIAL_F)}
    t0 = time.perf_counter()
    tables = ShardTables(plan, device)
    out.update(tables_s=time.perf_counter() - t0, tables_build_s=tables.build_s,
               table_bytes=tables.nbytes, max_table_bytes=max(tables.nbytes),
               sum_table_bytes=sum(tables.nbytes))
    rng = np.random.default_rng(33)
    x = rng.normal(size=(hg.num_nodes, SERIAL_F)).astype(np.float32)
    reset_kernel_launches()
    stats = {}
    t0 = time.perf_counter()
    got, peak = _peak_delta(lambda: serialized_halo_forward(
        plan, x, device=device, tables=tables, stats=stats), device)
    fwd_s = time.perf_counter() - t0
    bound = peak_bound(tables, SERIAL_F)
    out["forward"] = {"wall_s": fwd_s, "stats": stats, "peak_bytes": peak, "bound_bytes": bound}
    check(got.shape == (hg.num_nodes, SERIAL_F) and bool(np.isfinite(got).all()),
          "31c: the forward is finite, [N, F]")
    check(peak <= bound, f"31c: forward peak {peak} B within the bound {bound} B")
    check(peak < sum(tables.nbytes),
          f"31c: forward peak {peak} B below all shards' tables {sum(tables.nbytes)} B")
    # the step: JAX's padded classes, half the rows in the mask
    y = rng.integers(0, NCLASS, size=hg.num_nodes)
    mask = (rng.random(hg.num_nodes) < 0.5).astype(np.float32)
    params = serial_init(SERIAL_F, 32, NCLASS, seed=6)
    tstats = {}
    t0 = time.perf_counter()
    (loss, grads), tpeak = _peak_delta(lambda: serialized_halo_train_step(
        plan, params, x, y, mask, stats=tstats, device=device, tables=tables), device)
    step_s = time.perf_counter() - t0
    out["step"] = {"wall_s": step_s, "loss": loss, "peak_bytes": tpeak, "bound_bytes": bound,
                   "layer_turn_s": tstats["per_shard_wall_s"],
                   "layer_turn_device_ms": tstats["per_shard_device_ms"]}
    torch.cuda.synchronize()
    out["launches"] = kernel_launches()
    check(tpeak <= bound, f"31c: step peak {tpeak} B within the bound {bound} B")
    check(tpeak < sum(tables.nbytes),
          f"31c: step peak {tpeak} B below all shards' tables {sum(tables.nbytes)} B")
    # each shard's kernels against their twins on its tables (not counted)
    t0 = time.perf_counter()
    out["kernel_errs"] = check_turn_kernels(tables, (SERIAL_F, SERIAL_CPAD), 60, device)
    out["kernel_checks_s"] = time.perf_counter() - t0
    del tables
    # the unsharded forward and step on the card, after the measured runs
    hgd = hg.device_data(device)
    with torch.no_grad():
        want = hgnn_aggregate_ref(hgd, torch.as_tensor(x, device=device)).cpu().numpy()
    out["forward"]["rel_err_vs_plain"] = rel_to_max(got, want)
    # the bf16 bar of JAX's own halo check (tests/test_halo.py:255)
    check(out["forward"]["rel_err_vs_plain"] <= 5e-3,
          f"31c: the forward within 5e-3·max of the plain one ({out['forward']['rel_err_vs_plain']})")
    del hgd
    want_loss, want_grads = serial_plain_step(hg, params, x, y, mask, device)
    out["step"].update(plain_loss=want_loss, loss_rel_gap=abs(loss - want_loss) / abs(want_loss),
                       grad_rel_err={k: rel_to_max(grads[k], want_grads[k]) for k in grads})
    check(out["step"]["loss_rel_gap"] <= SERIAL_LOSS_RTOL,
          f"31c: the step's loss within {SERIAL_LOSS_RTOL} of the plain step's")
    check(max(out["step"]["grad_rel_err"].values()) <= SERIAL_BF16_GRAD_REL,
          f"31c: the step's gradients within {SERIAL_BF16_GRAD_REL}·max of the plain step's "
          f"({out['step']['grad_rel_err']})")
    return out


def feature_rank(dense_plan, x, cot, degv, agg_plan, widths) -> dict:
    """Phase 31 (d), in each rank of the 2 x 2 grid: the feature-sharded
    dense shard's aggregation and gradient (the counted main path), then the
    record-routed sum against its twin on this rank's shard of the CLI's
    plan at the column widths of the feature-sharded max layers."""
    from hypergef_tpu_torch.parallel.dense_shard import sharded_dense_hgnn_aggregate
    from hypergef_tpu_torch.parallel.launch import kernel_launches, reset_kernel_launches
    from hypergef_tpu_torch.parallel.mesh import make_mesh

    mesh = make_mesh(*FEATURE_GRID)
    dev = mesh.device
    reset_kernel_launches()
    xt = torch.tensor(x, device=dev, requires_grad=True)
    o = sharded_dense_hgnn_aggregate(dense_plan, xt, None, "sum",
                                     degV=torch.as_tensor(degv, device=dev), mesh=mesh,
                                     feature_sharded=True)
    (o * torch.as_tensor(cot, device=dev)).sum().backward()
    torch.cuda.synchronize(dev)
    out = {"out": o.detach().cpu().numpy(), "dx": xt.grad.cpu().numpy(),
           "launches": kernel_launches(), "coords": (mesh.rank, mesh.feature.rank)}
    loc = agg_plan.local(mesh.rank, dev)
    out["record_checks"] = []
    for f in widths:
        g, arg = stage_record_operands(loc.e_stage, f, 70 + 10 * mesh.rank + mesh.feature.rank,
                                       dev)
        out["record_checks"].append(check_record_sum(g, arg, loc.record))
    return out


def feature_cells(device, cli_cells: dict) -> dict:
    """Phase 31 (d): the CLI's --shards 2 --feature-shards 2 (HGNN sum and
    max) against phase 30 (a)'s one-rank nccl world; the feature-sharded
    dense shard on 20news against the dense route; the record sum in every
    rank at the column widths 16 and 3."""
    from hypergef_tpu_torch.ops import fused
    from hypergef_tpu_torch.parallel import launch
    from hypergef_tpu_torch.parallel.dense_shard import plan_sharded_dense
    from hypergef_tpu_torch.parallel.partition import plan_sharded_aggregation
    from hypergef_tpu_torch.sparse.planner import AggregationPlan
    from hypergef_tpu_torch.train import cli

    e, f = FEATURE_GRID
    out = {}
    for name in ("HGNN sum", "HGNN max"):
        res = cli.main(DIST_CLI + DIST_CLI_RUNS[name] + [
            "--shards", str(e), "--feature-shards", str(f), "--dist-backend", "gloo"])
        losses, ref = np.asarray(res["losses"]), np.asarray(cli_cells[name]["nccl1_losses"])
        check(bool(np.allclose(losses, ref, rtol=DIST_LOSS_RTOL, atol=0.0)),
              f"31d {name}: the 2 x 2 grid's losses {losses[-3:]} within {DIST_LOSS_RTOL} of "
              f"the one-rank nccl world's {ref[-3:]}")
        check(len(res["ranks"]) == e * f, f"31d {name}: {e * f} ranks ran")
        if name.endswith("max"):
            check(all(r["launches"]["recsum"] > 0 for r in res["ranks"]),
                  f"31d {name}: every rank launched the record-routed sum")
        out[name] = {"world_s": res["world_s"], "setup_s": res["setup_s"],
                     "timeline": launch.last_world, "final_loss": res["final_loss"],
                     "max_loss_rel_diff_vs_nccl1": float(np.abs(losses - ref).max() /
                                                         np.abs(ref).max()),
                     "ranks": res["ranks"]}
    args = cli.parse(DIST_CLI)
    hg_cli, _, _ = cli.load_problem(args)
    agg_plan = plan_sharded_aggregation(hg_cli, e)
    hg = make_graph("20news")
    plan = plan_sharded_dense(hg, e)
    rng = np.random.default_rng(34)
    x = rng.normal(size=(hg.num_nodes, DIST_F)).astype(np.float32)
    cot = rng.normal(size=(hg.num_nodes, DIST_F)).astype(np.float32)
    t0 = time.perf_counter()
    ranks = launch.spawn(feature_rank, e * f, backend="gloo", platform="cuda",
                         args=(plan, x, cot, hg.degV, agg_plan,
                               (32 // f, args.classes // f)), timeout_s=600)
    world_s = time.perf_counter() - t0
    xt = torch.tensor(x, device=device, requires_grad=True)
    o = fused.hgnn_aggregate(hg.device_data(device), xt, None, "sum", backend="dense",
                             plan=AggregationPlan.dense_plan(hg, device))
    (o * torch.as_tensor(cot, device=device)).sum().backward()
    cell = {"world_s": world_s, "timeline": launch.last_world,
            "coords": [r["coords"] for r in ranks],
            "ranks": [{"launches": r["launches"]} for r in ranks],
            "record_checks": [c for r in ranks for c in r["record_checks"]]}
    for key, want in (("out", o.detach().cpu().numpy()), ("dx", xt.grad.cpu().numpy())):
        got = ranks[0][key]
        cell[f"{key}_bitwise_dense_route"] = bool(np.array_equal(got, want))
        cell[f"{key}_max_abs_err"] = float(np.abs(got - want).max())
        # phase 30 (c)'s bar (two bf16 roundings)
        check(bool(np.allclose(got, want, rtol=1e-2, atol=1e-2 * np.abs(want).max())),
              f"31d dense {key}: the feature-sharded dense shard within 1e-2 of the dense "
              f"route ({cell[f'{key}_max_abs_err']})")
        for r in ranks[1:]:
            check(bool(np.array_equal(r[key], got)), f"31d dense {key}: every rank alike")
    out["dense"] = cell
    return out


def serial_phase(device, card: str, aligned: dict, cli_cells: dict) -> dict:
    """Phase 31: (a)-(d); every launch of the path summed. (c) builds its
    graph and plan on the host first (serial_scale_problem), alone."""
    torch.cuda.empty_cache()
    out = {}
    for key, fn in (("a", lambda: serial_forward_cell(device, aligned["halo_world"])),
                    ("b", lambda: serial_train_cell(device, aligned["sbm"],
                                                    aligned["halo_world"]["plan"])),
                    ("c", lambda: serial_scale_cell(device, serial_scale_problem())),
                    ("d", lambda: feature_cells(device, cli_cells))):
        t0 = time.perf_counter()
        out[key] = fn()
        out[key]["phase_s"] = time.perf_counter() - t0
        print(f"phase 31 {key} (card {card}): {json.dumps(out[key])}", flush=True)
    launches = {}
    for part in (out["a"]["launches"], out["b"]["launches"], out["c"]["launches"]):
        for k, v in part.items():
            launches[k] = launches.get(k, 0) + v
    for cell in (out["d"]["HGNN sum"], out["d"]["HGNN max"], out["d"]["dense"]):
        for r in cell["ranks"]:
            for k, v in r["launches"].items():
                launches[k] = launches.get(k, 0) + v
    out["launches"] = launches
    print(f"phase 31 launches: {json.dumps(launches)}", flush=True)
    return out


# phase 32, the experiment drivers on the card at their own widths (F = 32,
# nhid 32, the datasets' feature widths) and a reduced depth
DRIVER_REALISTIC = ("cora", "pubmed", "coauthor_dblp", "ModelNet40", "20newsW100", "Mushroom")
DRIVER_ITERS = 10  # calls a timed window (the drivers' default 30)
DRIVER_FIG10 = ("20news", "4,8,16,32,64,128")
DRIVER_FIG6 = ("cora", "coauthor_dblp", "20newsW100")
DRIVER_SERVE = "cora_shaped"
DRIVER_MINIBATCH = ("dblp_shaped", 30)  # workload, --epochs (the driver's default 150)
DRIVER_MAX_COMPILES = 3
# JAX's plan_aggregation pick on each DRIVER_REALISTIC graph, and on zoo
# (tests/test_torch_port_cuda.py's), after the driver's pipeline
# (clustered_at_dims, the raw-order shuffle, the coarsen reorder); held
# against JAX on the CPU by tests/test_torch_port_experiments.py
REALISTIC_PICKS = {"cora": "precomp", "pubmed": "aligned", "coauthor_dblp": "aligned",
                   "ModelNet40": "aligned", "20newsW100": "dense", "Mushroom": "dense",
                   "zoo": "dense"}


def csv_lines(path) -> list:
    with open(path) as f:
        lines = f.read().splitlines()
    check(lines[0].startswith("# card: "), f"{path} opens with the card's row: {lines[0]!r}")
    return lines


def check_route_errors(where: str, errors: dict) -> None:
    """Each timed route's output against the ``xla`` route's on the same x,
    within its bar (``common.route_tolerance``) of max|xla|."""
    from hypergef_tpu_torch.experiments import common

    for b, e in errors.items():
        check(e["rel_tol"] == common.route_tolerance(b)
              and e["max_abs_err"] <= e["rel_tol"] * e["max_abs_xla"],
              f"{where}/{b}: {e['max_abs_err']} against {e['rel_tol']}·{e['max_abs_xla']}")


def realistic_cell(path) -> dict:
    """Phase 32 (a): fig7_9_realistic on DRIVER_REALISTIC. The driver holds
    each route against xla before timing it (and ends SystemExit off its
    bar); here each dataset's errors, its auto column against JAX's pick
    on the same pipeline (REALISTIC_PICKS), and each FLOOR beside row 4's
    bound of the same stage."""
    from hypergef_tpu_torch.experiments import fig7_9_realistic

    res = fig7_9_realistic.main(["--configs", ",".join(DRIVER_REALISTIC),
                                 "--iters", str(DRIVER_ITERS), "--out", path])
    lines = csv_lines(path)
    check([r["dataset"] for r in res] == list(DRIVER_REALISTIC), "a result a dataset")
    out = {}
    for r in res:
        name, auto = r["dataset"], r["auto"]
        want_pick = REALISTIC_PICKS[name]
        (summary,) = [ln for ln in lines if ln.startswith(f"SUMMARY,{name},")]
        check(auto == want_pick and f",auto={want_pick}," in summary,
              f"{name}: auto column {auto} against JAX's pick {want_pick}")
        want = {"xla", auto} | ({"aligned"} if r["plan"].aligned is not None else set())
        check(set(r["times_us"]) == want == set(r["errors"]),
              f"{name}: timed {sorted(r['times_us'])}, held {sorted(r['errors'])}")
        check_route_errors(name, r["errors"])
        cell = {"nnz": r["nnz"], "auto": auto, "times_us": r["times_us"],
                "errors": r["errors"], "host_bound": r["host_bound"],
                "generate_s": r["generate_s"], "reorder_s": r["reorder_s"], "plan_s": r["plan_s"]}
        if "floor" in r:
            stages = r["plan"].aligned.device(torch.device("cuda", 0))
            cell["floor_vs_row4"] = {}
            for side, stage in zip(("edge", "vertex"), stages):
                fl, row4 = r["floor"][f"{side}_stage"], band_bound(stage, 32)
                cell["floor_vs_row4"][side] = {
                    "floor_ms": fl["floor_s"] * 1e3, "t_elems_ms": fl["t_mxu_elems_s"] * 1e3,
                    "t_bytes_ms": fl["t_hbm_bytes_s"] * 1e3, "row4_bound_ms": row4["bound_ms"],
                    "row4_bound_by": row4["bound_by"]}
        out[name] = cell
    return out


def auto_matrix_cell(path) -> dict:
    """Phase 32 (b): auto_matrix on its five workloads: every applicable
    fixed route timed and held against xla; the ladder's picks of the
    graphs earlier phases plan are LADDER_PICKS."""
    from hypergef_tpu_torch.experiments import auto_matrix

    res = auto_matrix.main(["--out", path])
    lines = csv_lines(path)
    check(lines[1] == auto_matrix.HEADER and len(lines) == 2 + len(auto_matrix.WORKLOADS),
          "auto_matrix: its header and a row a workload")
    out = {}
    for r in res:
        name = r["workload"]
        want = LADDER_PICKS.get(name)
        check(want is None or r["auto_pick"] == want,
              f"{name}: ladder pick {r['auto_pick']}, want {want}")
        routes = set(auto_matrix.applicable_backends(r["plan"]))
        check(set(r["times_us"]) == routes == set(r["errors"]) and r["auto_pick"] in routes,
              f"{name}: timed {sorted(r['times_us'])}, applicable {sorted(routes)}")
        check(all(np.isfinite(v) and v > 0 for v in r["times_us"].values()),
              f"{name}: times {r['times_us']}")
        check_route_errors(name, r["errors"])
        out[name] = {k: r[k] for k in ("nnz", "auto_pick", "best_fixed", "times_us", "errors",
                                       "tuned_pick", "tuned_params", "near_best",
                                       "host_bound")}
    return out


def driver_phase(device, card: str) -> dict:
    """Phase 32: the experiment drivers' ``main`` in process, each writing
    its CSV into a temporary directory, with the kernels' counts set to 0
    just before and read just after."""
    import os
    import tempfile

    from hypergef_tpu_torch.experiments import fig6, fig10, minibatch_bench, serve_bench

    counters = kernel_counters()
    torch.cuda.synchronize()
    for module, attr in counters.values():
        setattr(module, attr, 0)
    out = {}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_drivers_") as tmp:
        def path(name):
            return os.path.join(tmp, f"{name}.csv")

        t0 = time.perf_counter()
        out["a fig7_9_realistic"] = realistic_cell(path("fig7_9_realistic"))
        out["a_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        out["b auto_matrix"] = auto_matrix_cell(path("auto_matrix"))
        out["b_s"] = time.perf_counter() - t0

        t0 = time.perf_counter()
        config, ngs = DRIVER_FIG10
        rows = fig10.main(["--config", config, "--ngs", ngs, "--iters", str(DRIVER_ITERS),
                           "--out", path("fig10")])
        check(len(csv_lines(path("fig10"))) == 1 + len(rows)
              and [r["ngs"] for r in rows] == [int(g) for g in ngs.split(",")]
              and all(np.isfinite(r["us"]) and r["us"] > 0 for r in rows),
              f"fig10: a finite row an ngs: {rows}")
        for r in rows:
            check_route_errors(f"fig10 ngs={r['ngs']}", {"tree": r["error"]})
        out["c fig10"] = rows
        out["c_s"] = time.perf_counter() - t0

        t0 = time.perf_counter()
        rows = fig6.main(["--datasets", ",".join(DRIVER_FIG6), "--models", "HGNN",
                          "--hids", "32", "--quick", "--out", path("fig6")])
        lines = csv_lines(path("fig6"))
        check(len(rows) == len(DRIVER_FIG6) and len(lines) == 1 + len(rows)
              and not any("failed" in r for r in rows), f"fig6: no FAILED row: {rows}")
        for r in rows:
            check(r["step"] == "captured" and all(np.isfinite(r[k]) for k in (
                "train_epoch_time_s", "inference_time_s", "test_acc", "final_loss")),
                f"fig6 {r['dataset']}: a captured step, finite columns: {r}")
        out["d fig6"] = rows
        out["d_s"] = time.perf_counter() - t0

        t0 = time.perf_counter()
        (row,) = serve_bench.main(["--workloads", DRIVER_SERVE, "--out", path("serve_bench"),
                                   "--artifact-dir", os.path.join(tmp, "artifacts")])
        csv_lines(path("serve_bench"))
        check(row["parity_max_abs"] < serve_bench.PARITY_MAX,
              f"serve_bench: parity {row['parity_max_abs']}")
        out["e serve_bench"] = row
        out["e_s"] = time.perf_counter() - t0

        t0 = time.perf_counter()
        workload, epochs = DRIVER_MINIBATCH
        rows = minibatch_bench.main(["--workloads", workload, "--epochs", str(epochs),
                                     "--out", path("minibatch_bench")])
        csv_lines(path("minibatch_bench"))
        full, mb = rows
        check(mb["step"] == "captured" and 1 <= mb["compile_count"] <= DRIVER_MAX_COMPILES,
              f"minibatch_bench: {mb['compile_count']} recordings ({mb['step']})")
        check(all(np.isfinite(r["reached_acc"]) for r in rows), f"minibatch_bench: {rows}")
        out["f minibatch_bench"] = rows
        out["f_s"] = time.perf_counter() - t0
    torch.cuda.synchronize()
    out["launches"] = {k: getattr(module, attr) for k, (module, attr) in counters.items()}
    for key in ("a fig7_9_realistic", "b auto_matrix", "c fig10", "d fig6", "e serve_bench",
                "f minibatch_bench"):
        print(f"phase 32 {key} (card {card}): {json.dumps(out[key])}", flush=True)
    for name, cell in out["a fig7_9_realistic"].items():
        for side, fl in cell.get("floor_vs_row4", {}).items():
            print(f"phase 32 FLOOR {name} {side} stage at F=32 (card rates; row 4's bound of "
                  f"the same stage): floor {fl['floor_ms']} ms, row 4 {fl['row4_bound_ms']} ms "
                  f"({fl['row4_bound_by']})", flush=True)
    print(f"phase 32 launches: {json.dumps(out['launches'])}", flush=True)
    return out


# phase 33, the scale drivers at a reduced depth (each driver's own widths):
# argv tails of each driver's main, and the bars of its checks
SCALE_E2E = ["--iters", "5"]  # clustered_e2e: SBM-60k, 30 epochs (its default: 30 iters)
SCALE_ALIGNED = ["--configs", "pubmed_clustered", "--iters", "10"]
SCALE_PROJECTION = ["--sizes", "200000:100000:400"]  # one shard of 1M incidences
SCALE_SERIAL = ["--nodes", "200000", "--edges", "100000", "--comm", "400", "--shards", "4",
                "--epoch"]
SCALE_MINIBATCH = ["--nodes", "300000", "--edges", "214000", "--epochs", "1",
                   "--eval-nodes", "20000"]  # about 1.5M incidences
SCALE_WEAK = ["--shards", "1,2,4", "--nnz-per-shard", "20000", "--iters", "10"]
SCALE_OVERLAP = ["--shards", "2,4", "--nnz-per-shard", "20000", "--iters", "10"]
# the serialized step's initial loss against ln(8) (random labels, JAX's
# initial weights: 2.16 on the CPU at the smoke size)
SCALE_LOSS_SPREAD = 0.5


def scale_phase(device, card: str) -> dict:
    """Phase 33: the eight scale drivers' ``main`` in process at a reduced
    depth, each writing its CSV into a temporary directory, the kernels'
    counts set to 0 just before and read just after. Each route a driver
    times is held against ``xla`` (or, for the dense shard, the D partials'
    sum) within its bar; clustered_e2e's test accuracy above chance;
    scale_serialized's output finite and its initial loss near ln(8);
    minibatch_scale's recordings and its full-batch row; halo_overlap's
    chain."""
    import math
    import os
    import tempfile

    from hypergef_tpu_torch.experiments import (
        clustered_e2e, dense_shard_scale, halo_overlap, minibatch_scale, scale_aligned,
        scale_projection, scale_serialized, weak_scaling,
    )

    counters = kernel_counters()
    torch.cuda.synchronize()
    for module, attr in counters.values():
        setattr(module, attr, 0)
    out = {}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_scale_") as tmp:
        def run(key, module, argv):
            path = os.path.join(tmp, f"{key}.csv")
            t0 = time.perf_counter()
            res = module.main(argv + ["--out", path])
            out[f"{key}_s"] = time.perf_counter() - t0
            return res, csv_lines(path)

        rows, lines = run("a", clustered_e2e, SCALE_E2E)
        check([r["backend"] for r in rows] == list(clustered_e2e.BACKENDS)
              and rows[0]["form"] == "pallas_auto"
              and all(r["test_acc"] > 100.0 / clustered_e2e.NCLASS and r["epoch_us"] > 0
                      for r in rows), f"clustered_e2e: accuracy above chance, kernel form: {rows}")
        out["a clustered_e2e"] = rows

        rows, lines = run("b", scale_aligned, SCALE_ALIGNED)
        check([r["backend"] for r in rows] == ["aligned", "tree"]
              and rows[0]["form"] == "pallas_auto", f"scale_aligned: {rows}")
        for r in rows:
            check_route_errors(f"scale_aligned {r['config']}", {r["backend"]: r["error"]})
        out["b scale_aligned"] = rows

        rows, lines = run("c", dense_shard_scale, [])
        check([r["devices"] for r in rows] == [1, *dense_shard_scale.SHARDS]
              and any("MODELED nvlink4" in ln for ln in lines), f"dense_shard_scale: {rows}")
        for r in rows:
            check_route_errors(f"dense_shard_scale D={r['devices']}",
                               {r["backend"] if r["devices"] == 1 else "dense": r["error"]})
        out["c dense_shard_scale"] = rows

        res, lines = run("d", scale_projection, SCALE_PROJECTION)
        check(len(res["points"]) == 1 and res["points"][0]["form"] == "pallas_auto"
              and any(ln.startswith("shard_compute_nnz") and card in ln for ln in lines),
              f"scale_projection: {res}")
        check_route_errors("scale_projection", {"aligned": res["points"][0]["error"]})
        out["d scale_projection"] = res

        res, lines = run("e", scale_serialized, SCALE_SERIAL)
        check(res["finite"] and res["local_form"] == "aligned"
              and abs(res["train_epoch_loss"] - math.log(8)) < SCALE_LOSS_SPREAD
              and any(ln.startswith("ici_transfer") and "MODELED" in ln for ln in lines),
              f"scale_serialized: finite, aligned, loss near ln(8): {res}")
        check_route_errors("scale_serialized", {"aligned": res["error"]})
        out["e scale_serialized"] = res

        res, lines = run("f", minibatch_scale, SCALE_MINIBATCH)
        check("full_batch" in res and any(ln.startswith("full_batch_step,") for ln in lines)
              and res["step"] == "captured" and 1 <= res["compile_count"] <= DRIVER_MAX_COMPILES
              and res["valid_acc"] > 1.0 / 8, f"minibatch_scale: {res}")
        out["f minibatch_scale"] = res

        rows, lines = run("g", weak_scaling, SCALE_WEAK)
        check(len(rows) == 2 * 3, f"weak_scaling: a row a graph and shard count: {rows}")
        for r in rows:
            check_route_errors(f"weak_scaling {r['graph']} D={r['shards']}", r["errors"])
        out["g weak_scaling"] = rows

        rows, lines = run("h", halo_overlap, SCALE_OVERLAP)
        check(len(rows) == 2 * 2 and all(r["chain_ok"] for r in rows),
              f"halo_overlap: chain_ok on every row: {rows}")
        for r in rows:
            check_route_errors(f"halo_overlap {r['graph']} D={r['shards']}", r["errors"])
        out["h halo_overlap"] = rows
    torch.cuda.synchronize()
    out["launches"] = {k: getattr(module, attr) for k, (module, attr) in counters.items()}
    for key in ("a clustered_e2e", "b scale_aligned", "c dense_shard_scale",
                "d scale_projection", "e scale_serialized", "f minibatch_scale",
                "g weak_scaling", "h halo_overlap"):
        print(f"phase 33 {key} (card {card}; {out[key[0] + '_s']:.2f} s): "
              f"{json.dumps(out[key], default=str)}", flush=True)
    print(f"phase 33 launches: {json.dumps(out['launches'])}", flush=True)
    return out


# phase 34: the ell, bsr and multihot routes. Routes (b) trains and serves
# on the sorted SBM-60k (bench.py's clustered shape), by name -> (backend,
# the multihot plan's form or None); their no-dropout losses' bar against
# ``xla`` (PERF.md §2: 1e-3 for the f32 routes, 1e-2 where one side rounds
# to bf16) and the served log-probs' bar against the f32 ``tree`` route
ROUTE_CELLS = {"bsr": ("bsr", None), "multihot": ("multihot", "multihot"),
               "multihot_precomp": ("multihot", "multihot_precomp"), "ell": ("ell", None)}
ROUTE_LOSS_RTOL = {"ell": 1e-3, "bsr": 1e-2, "multihot": 1e-2}
# calls a timed window of (a)'s clustered_bench (the driver's default 20)
ROUTES_ITERS = 10


def route_reference_plan(name: str, plan, hg):
    """The plan a phase 34 request is held against on CPU tensors: the
    cell's own (the block products and ELL kernels' plain twins there),
    except that the compare-built multihot forms are held against the
    host-built blocks of the same tiles (``multihot_precomp`` with a plain
    tree combine, no byte cap): the same function, its multihot matrices
    made another way, at a CPU cost of one product a tile."""
    from hypergef_tpu_torch.sparse.planner import AggregationPlan, plan_multihot

    if ROUTE_CELLS[name][1] != "multihot":
        return plan
    return AggregationPlan(tree=plan.tree, multihot=plan_multihot(
        hg, form="multihot_precomp", combine="tree", precomp_limit_bytes=1 << 62))


def route_epochs(problem, device) -> dict:
    """Eager against captured on one phase 34 cell, from the same seeded
    weights with dropout on: COMPILED_EPOCHS losses bitwise equal; then a
    step of each timed once (``time_steps``: wall and device ms)."""
    from hypergef_tpu_torch.train.trainer import Trainer

    cfg, hg, x, y, split, plan = problem
    trainers = {c: Trainer(cfg, hg, x, y, plan=plan, device=device, compiled=c == "captured")
                for c in ("eager", "captured")}
    fits = {c: tr.fit(split["train"], epochs=COMPILED_EPOCHS, warmup=0)
            for c, tr in trainers.items()}
    check(fits["captured"]["step"] == "captured", "the captured Trainer replays its step")
    equal = bool(np.array_equal(fits["captured"]["losses"], fits["eager"]["losses"]))
    check(equal, f"{cfg.backend}: captured losses bitwise equal to eager")
    turns = time_steps(trainers, split["train"], ("eager", "captured"), device)
    return {"losses_equal": equal, "capture_s": fits["captured"]["capture_s"], **turns}


def route_plan(name: str, hg, device, first_aggr: str = "sum"):
    """(plan, host seconds to build it, seconds to put it on ``device``, its
    device MiB) of a phase 34 cell: :func:`default_plan`, or the tree and
    the multihot plan of the cell's form."""
    from hypergef_tpu_torch.experiments.clustered_bench import device_bytes
    from hypergef_tpu_torch.sparse.planner import AggregationPlan, plan_multihot, plan_tree
    from hypergef_tpu_torch.train.trainer import default_plan, device_plans

    backend, form = ROUTE_CELLS[name]
    t0 = time.perf_counter()
    if form not in (None, "multihot"):
        plan = AggregationPlan(tree=plan_tree(hg), multihot=plan_multihot(hg, form=form))
    else:
        plan = default_plan(backend, hg, device, first_aggr)
    plan_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    tables = [p.device(device) for p in device_plans(plan)]
    torch.cuda.synchronize(device)
    return plan, plan_s, time.perf_counter() - t0, device_bytes(tables) / 2**20


def routes_phase(device, card: str, sbm) -> dict:
    """Phase 34: the ``ell``, ``bsr`` and ``multihot`` routes on the card.
    (a) clustered_bench at its defaults; (b) HGNN on the sorted SBM-60k on
    each route of ``ROUTE_CELLS``: 20 captured steps counted, captured
    against eager (bitwise, with a step of each timed), no-dropout losses
    against ``xla``, a request counted against the plain version; (c)
    HGNN max on ``multihot``, its E→V on the multihot plan's own stages;
    (d) the launches of the ELL gather and segment-sum kernels on ``ell``."""
    import os
    import tempfile

    from hypergef_tpu_torch.data.synthetic import random_features
    from hypergef_tpu_torch.experiments import clustered_bench
    from hypergef_tpu_torch.ops import ell_gather, fused, maxops, segment_sum, tree
    from hypergef_tpu_torch.train.splits import rand_train_test_idx
    from hypergef_tpu_torch.train.trainer import TrainConfig

    out = {"launches": {}}
    counters = kernel_counters()

    def add(launched):
        for k, v in launched.items():
            out["launches"][k] = out["launches"].get(k, 0) + v

    # (a) clustered_bench at its defaults, its counts from 0
    torch.cuda.synchronize()
    for module, attr in counters.values():
        setattr(module, attr, 0)
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_routes_") as tmp:
        path = os.path.join(tmp, "clustered.csv")
        rows = clustered_bench.main(["--iters", str(ROUTES_ITERS), "--out", path])
        lines = csv_lines(path)
    torch.cuda.synchronize()
    add({k: getattr(module, attr) for k, (module, attr) in counters.items()})
    out["a_s"] = time.perf_counter() - t0
    timed = [r for r in rows if "summary" not in r]
    summaries = {r["graph"]: r for r in rows if "summary" in r}
    check(set(summaries) == {"sbm", "random"} and card in lines[0],
          f"clustered_bench: both graphs, the card's row: {lines[:1]}")
    check(all(r["ok"] for r in timed), "clustered_bench: every route within its bar of xla")
    for g in ("sbm", "random"):
        routes = {r["backend"] for r in timed if r["graph"] == g}
        check({"cumsum", "tree", "multihot"} <= routes, f"clustered_bench {g}: {routes}")
        skipped = sum(ln.startswith(f"{g},") and ",multihot," in ln and ",SKIP," in ln
                      for ln in lines)
        check(sum(r["backend"] == "multihot" for r in timed if r["graph"] == g) + skipped == 6,
              f"clustered_bench {g}: the six multihot forms timed or skipped")
    # what the default multihot plan adds to the ladder's host time, on the
    # graph whose ladder ends on tree (phase 21's graphs stop before it)
    from hypergef_tpu_torch.data.synthetic import random_hypergraph
    from hypergef_tpu_torch.sparse.planner import plan_aggregation

    rnd = random_hypergraph(60_000, 30_000, avg_edge_size=12.0, seed=0)
    ladder_s = {}
    for key, flag in (("with_multihot", None), ("without", False)):
        t0 = time.perf_counter()
        plan = plan_aggregation(rnd, device, with_multihot=flag)
        torch.cuda.synchronize()
        ladder_s[key] = time.perf_counter() - t0
        check((plan.multihot is not None) == (flag is None) and plan.preferred_backend == "tree",
              f"the random graph's ladder ends on tree, multihot built by default: {ladder_s}")
    del rnd, plan
    out["a"] = {"ladder_s_random": ladder_s,
                "rows": [{k: r[k] for k in ("graph", "backend", "params", "us", "plan_s",
                                            "device_s", "device_mb", "max_abs_err", "rel_tol",
                                            "host_bound")} for r in timed],
                "refused": [ln for ln in lines if "FAILED" in ln or "SKIP" in ln
                            or "REFUSED" in ln],
                "picks": {g: {"card_fastest": s["fastest"], "ladder_pick": s["ladder_pick"],
                              "ladder_s": s["ladder_s"]} for g, s in summaries.items()}}

    # (b) training and serving on the sorted SBM-60k at bench.py's shape
    t0 = time.perf_counter()
    x, y = random_features(sbm.num_nodes, NFEAT, NCLASS, seed=1)
    split = rand_train_test_idx(y, seed=2)
    problems, plans = {}, {}
    for name, (backend, _) in ROUTE_CELLS.items():
        plan, plan_s, put_s, mb = route_plan(name, sbm, device)
        plans[name] = {"plan_s": plan_s, "device_s": put_s, "device_mb": mb}
        cfg = TrainConfig(model="HGNN", nhid=32, nlayer=2, first_aggr="sum", backend=backend)
        problems[name] = (cfg, sbm, x, y, split, plan)
    trained = train(problems, device)
    cells = {}
    for name, problem in problems.items():
        cfg, hg, _, _, _, plan = problem
        add(trained[name]["launches"])
        epochs = route_epochs(problem, device)
        nodrop = dataclasses.replace(cfg, dropout=0.0, input_drop=0.0)
        parity = loss_parity(name, (nodrop, plan, device),
                             (dataclasses.replace(nodrop, backend="xla"), None, device),
                             (hg, x, y, split), ROUTE_LOSS_RTOL[cfg.backend], "xla")
        # one request a route, counted, against the plain version on CPU
        # tensors within 1e-2 (PERF.md §2) and, for the f32 ell route, the
        # f32 xla route within 1e-3
        per = {"ell": {"gather": 4, "segsum": 4}}.get(cfg.backend, {})
        served = serve(device, hg, cfg.backend,
                       {k: (*counters[k], v) for k, v in per.items()}, plan=plan,
                       plain_plan=route_reference_plan(name, plan, hg), plain_device="cpu",
                       xla_atol=1e-3 if cfg.backend == "ell" else None, requests=1)
        add(served["launches"])
        cells[name] = {"plan": plans[name], "trained": trained[name], "epochs": epochs,
                       "parity": {k: parity[k] for k in ("ref", "rtol", "max_rel",
                                                         "first_rel")},
                       "served": {k: served[k] for k in ("route", "launches", "replayed",
                                                         "worst", "request_ms")}}
    out["b"] = cells
    out["b_s"] = time.perf_counter() - t0

    # (c) HGNN max on multihot: V→E by the argmax tree, E→V on the multihot stages
    t0 = time.perf_counter()
    plan, plan_s, put_s, mb = route_plan("multihot", sbm, device, "max")
    hgd = sbm.device_data(device)
    x32 = torch.as_tensor(np.random.default_rng(34).normal(
        size=(sbm.num_nodes, 32)).astype(np.float32), device=device)
    with torch.no_grad():
        got = fused.hgnn_aggregate(hgd, x32, None, "max", plan=plan, backend="multihot")
        ref = fused.hgnn_aggregate(hgd, x32, None, "max", backend="xla")
        e_stage, _ = plan.tree.device(device)
        fe_stage, fv_stage = plan.multihot.device(device)
        xe = maxops.v2e_max_tree(x32, e_stage, hgd.record) * hgd.degE
        own = tree.tree_matvec(xe, fv_stage, fe_stage) * hgd.degV
    err = float((got - ref).abs().max())
    scale = float(ref.abs().max())
    check(torch.equal(got, own), "multihot max: E→V rides the multihot plan's own stages")
    check(err <= 3e-2 * scale, f"multihot max within 3e-2·max|xla| ({err} of {scale})")
    cfg = TrainConfig(model="HGNN", nhid=32, nlayer=2, first_aggr="max", backend="multihot")
    problem = (cfg, sbm, x, y, split, plan)
    maxed = train({"multihot max": problem}, device)["multihot max"]
    add(maxed["launches"])
    nodrop = dataclasses.replace(cfg, dropout=0.0, input_drop=0.0)
    parity = loss_parity("multihot max", (nodrop, plan, device),
                         (dataclasses.replace(nodrop, backend="xla"), None, device),
                         (sbm, x, y, split), ROUTE_LOSS_RTOL["multihot"], "xla")
    out["c"] = {"plan_s": plan_s, "device_s": put_s, "device_mb": mb, "max_abs_err": err,
                "max_abs_xla": scale, "e2v_own_stages": True, "trained": maxed,
                "parity": {k: parity[k] for k in ("ref", "rtol", "max_rel", "first_rel")}}
    out["c_s"] = time.perf_counter() - t0

    # (d) the ELL gather and segment-sum kernels on the ell route's paths
    ell = {k: cells["ell"]["trained"]["launches"][k] + cells["ell"]["served"]["launches"][k]
           for k in ("gather", "segsum")}
    check(min(ell.values()) > 0, f"the ell route launched both kernels: {ell}")
    out["d"] = ell
    for key in ("a", "b", "c"):
        print(f"phase 34 {key} (card {card}; {out[key + '_s']:.2f} s): "
              f"{json.dumps(out[key], default=str)}", flush=True)
    print(f"phase 34 d ell route launches (gather, segsum): {json.dumps(out['d'])}; phase "
          f"launches: {json.dumps(out['launches'])}", flush=True)
    return out

# phase 35: the packed-int4 dense incidence. The fused kernel's cases are
# phase 2's (graph, F, seed), with a 20news table whose counts reach 7 in
# place of phase 2's counts of 2.
PACKED_CASES = (("20news", 32, 1), ("20news", 4, 2), ("20news", 100, 11),
                ("pubmed_real", 32, 3), ("cora", 32, 12), ("cora", 7, 13),
                ("20news counts 7", 32, 15))
PACKED_SHARDS = 4


def repeated_incidences(hg, seed: int):
    """``hg`` with a fifth of its incidences listed 2-7 times, one of them 7
    times: a table whose counts reach 7, the most a nibble holds."""
    from hypergef_tpu_torch.sparse.hypergraph import Hypergraph

    rng = np.random.default_rng(seed)
    v = hg.ht_indices.astype(np.int64)
    ed = np.repeat(np.arange(hg.num_edges), np.diff(hg.ht_indptr))
    reps = np.where(rng.random(v.size) < 0.2, rng.integers(2, 8, v.size), 1)
    reps[0] = 7
    return Hypergraph.from_coo(np.repeat(v, reps), np.repeat(ed, reps), num_nodes=hg.num_nodes,
                               num_edges=hg.num_edges, dedup=False, name=f"{hg.name} counts 7")


class PackedTables:
    """Each graph's int8 table and nibble carrier on the card, built once."""

    def __init__(self, graphs, device):
        self.graphs, self.device, self.built = graphs, device, {}

    def __call__(self, name):
        if name not in self.built:
            from hypergef_tpu_torch.sparse.planner import DenseIncidence, pack_nibbles

            hg = self.graphs[name]
            i8 = DenseIncidence.from_hypergraph(hg, self.device)
            packed = DenseIncidence.from_hypergraph(hg, self.device, packed=True)
            check(torch.equal(packed.h.cpu(), torch.as_tensor(pack_nibbles(i8.h.cpu().numpy()))),
                  f"{name}: the carrier packs the int8 table")
            self.built[name] = (i8, packed)
        return self.built[name]

    def operands(self, name, f: int, seed: int):
        """(int8 table, carrier, x, scale_e, scale_v): ``kernel_operands``
        on the tables built once."""
        i8, packed = self(name)
        h, x, se, sv = kernel_operands(self.graphs[name], f, seed, self.device, h=i8.h)
        return h, packed.h, x, se, sv


def check_packed(tables, name: str, f: int, seed: int) -> dict:
    """(a) the packed form against the int8 form (bitwise) and its plain
    twin (phase 2's bar), two runs, one count a call."""
    from hypergef_tpu_torch.ops import fused_dense

    h, carrier, x, se, sv = tables.operands(name, f, seed)
    before = (fused_dense.launches, fused_dense.packed_launches)
    got = fused_dense.fused_dense_two_stage(carrier, x, se, sv, packed=True)
    again = fused_dense.fused_dense_two_stage(carrier, x, se, sv, packed=True)
    torch.cuda.synchronize()
    check((fused_dense.launches, fused_dense.packed_launches) == (before[0], before[1] + 2),
          f"{name}: one packed launch a call, none of the int8 form")
    int8 = fused_dense.fused_dense_two_stage(h, x, se, sv)
    want = fused_dense.fused_dense_two_stage_plain(h, x, se, sv)
    scale = float(want.abs().max())
    torch.testing.assert_close(got, want, rtol=1e-2, atol=1e-2 * scale)
    diff = float((got - int8).abs().max())
    check(torch.equal(got, int8), f"{name} F={f}: packed bitwise equal to int8 ({diff})")
    check(torch.equal(got, again), f"{name} F={f}: two packed runs are bitwise equal")
    return {"graph": name, "f": f, "e": int(h.shape[1]), "carrier_cols": int(carrier.shape[1]),
            "max_abs_err": float((got - want).abs().max()), "max_abs_plain": scale,
            "max_count": int(h.max()), "bitwise_int8": True}


def packed_kernels_per_call(tables) -> dict:
    """(b) The CUDA kernels of one packed two-stage call and of one packed
    V→E phase at 20news F = 32, under ``torch.profiler``, in this process.
    Its sessions come late in a long process: opened otherwise than by
    ``utils/profiling.py::profiler``, a session kept CUPTI attached from the
    process's first session, and a short session's kernel, stamped from a
    stale clock correlation, fell out of its window (no device events); the
    helper detaches CUPTI at each stop."""
    from hypergef_tpu_torch.ops import fused_dense

    _, carrier, x, se, sv = tables.operands("20news", 32, 3)
    e = tables.graphs["20news"].num_edges
    counts = {"two_stage": cuda_kernels_per_call(
                  lambda: fused_dense.fused_dense_two_stage(carrier, x, se, sv, packed=True)),
              "v2e": cuda_kernels_per_call(lambda: fused_dense._launch_v2e(carrier, x, e))}
    check(counts == {"two_stage": 1, "v2e": 1},
          f"one CUDA kernel a packed call and a packed V→E phase, got {counts}")
    return counts


def packed_call_memory(tables, name: str) -> dict:
    """(b) The growth of the card's peak memory over a packed call: no more
    than the output and the scratch the wrapper allocates (each rounded to
    the allocator's 512-byte blocks, plus up to 1 MiB that the caching
    allocator leaves unsplit in a cached block), and under the int8
    table's bytes where that table is larger than them (pubmed_real: no
    [N, E] table is made)."""
    from hypergef_tpu_torch.ops import fused_dense

    h, carrier, x, se, sv = tables.operands(name, 32, 3)
    (n, e), f = h.shape, x.shape[1]
    ws = fused_dense._device_split(n, e, f, x.device)
    sizes = [n * f * 4, ws.splits_a * e * ws.fp * 4, e * ws.fp * 2,
             ws.splits_c * n * ws.fp * 4 if ws.splits_c > 1 else 0]
    allocated = sum(-(-b // 512) * 512 + (1 << 20) for b in sizes if b)
    fused_dense.fused_dense_two_stage(carrier, x, se, sv, packed=True)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(tables.device)
    base = torch.cuda.memory_allocated(tables.device)
    fused_dense.fused_dense_two_stage(carrier, x, se, sv, packed=True)
    torch.cuda.synchronize()
    grew = torch.cuda.max_memory_allocated(tables.device) - base
    check(grew <= allocated, f"{name}: a packed call's peak grew {grew} bytes, more than its "
                             f"output and scratch ({allocated})")
    if allocated < h.numel():
        check(grew < h.numel(), f"{name}: a packed call's peak grew {grew} bytes, not under "
                                f"the int8 table's {h.numel()}")
    return {"graph": name, "peak_growth_bytes": int(grew),
            "output_and_scratch_bytes": sum(sizes), "int8_table_bytes": int(h.numel()),
            "carrier_bytes": int(carrier.numel())}


def check_packed_backward(tables, name: str, f: int, seed: int) -> dict:
    """(c) dx, d scale_e, d scale_v on the carrier bitwise the int8 form's:
    the packed op twice and the packed V→E phase twice."""
    from hypergef_tpu_torch.ops import fused_dense

    h, carrier, x, se, sv = tables.operands(name, f, seed)
    g = torch.as_tensor(np.random.default_rng(seed + 1).normal(size=tuple(x.shape))
                        .astype(np.float32), device=tables.device)
    grads = {}
    for packed, table in ((False, h), (True, carrier)):
        ts = [t.clone().requires_grad_(True) for t in (x, se, sv)]
        out = fused_dense.fused_dense_two_stage(table, *ts, packed=packed)
        before = (fused_dense.packed_launches, fused_dense.packed_v2e_launches)
        grads[packed] = torch.autograd.grad(out, ts, g)
        torch.cuda.synchronize()
        launched = (fused_dense.packed_launches - before[0],
                    fused_dense.packed_v2e_launches - before[1])
        check(launched == ((2, 2) if packed else (0, 0)),
              f"{name}: a packed backward launches the op twice and V→E twice: {launched}")
    for what, a, b in zip(("dx", "d_scale_e", "d_scale_v"), grads[True], grads[False]):
        check(torch.equal(a, b), f"{name} F={f}: packed {what} bitwise the int8 form's "
                                 f"({float((a - b).abs().max())})")
    return {"graph": name, "f": f, "bitwise_int8": ["dx", "d_scale_e", "d_scale_v"]}


def packed_train(name: str, tables, device) -> dict:
    """(d) 20 captured steps on the int8 and the packed plan, each counted
    with the counts set to 0 just before it: losses bitwise equal."""
    from hypergef_tpu_torch.data.synthetic import random_features
    from hypergef_tpu_torch.sparse.planner import AggregationPlan
    from hypergef_tpu_torch.train.splits import rand_train_test_idx
    from hypergef_tpu_torch.train.trainer import TrainConfig, Trainer

    # train_problem's configurations, pubmed_real on the dense route
    hg = tables.graphs[name]
    nfeat, nclass = (NFEAT, NCLASS) if name == "20news" else (PUBMED_NFEAT, PUBMED_NCLASS)
    x, y = random_features(hg.num_nodes, nfeat, nclass, seed=1)
    split = rand_train_test_idx(y, seed=2)
    cfg = TrainConfig(model="HGNN", nhid=32, nlayer=2, first_aggr="sum", lr=0.01, wd=5e-4,
                      backend="pallas" if name == "20news" else "dense")
    counters = kernel_counters()
    out, trainers, losses = {"route": cfg.backend}, {}, {}
    for packed, dense in zip((False, True), tables(name)):
        per = ({"fused_packed" if packed else "fused": 4} if cfg.backend == "pallas" else {})
        tr = Trainer(cfg, hg, x, y, plan=AggregationPlan(dense=dense), device=device)
        torch.cuda.synchronize()
        for module, attr in counters.values():
            setattr(module, attr, 0)
        res = tr.fit(split["train"], epochs=TRAIN_STEPS, warmup=0)
        launched = {k: getattr(module, attr) for k, (module, attr) in counters.items()}
        check(res["step"] == "captured", f"{name}: the step is recorded")
        calls = res["capture_warmup"] + 1
        want = {k: calls * per.get(k, 0) for k in counters}
        check(launched == want, f"{name} packed={packed}: {calls} step calls launched "
                                f"{launched}, want {want}")
        (step,) = tr._steps.values()
        replayed = check_replays(f"{name}'s step graph", graph_kernels(step), counters, per,
                                 TRAIN_STEPS)
        check(bool(np.isfinite(res["losses"]).all()), f"{name}: finite losses")
        key = "packed" if packed else "int8"
        trainers[key], losses[key] = tr, res["losses"]
        out[key] = {"launches": {k: v for k, v in launched.items() if v},
                    "replayed": replayed, "capture_s": res["capture_s"]}
    check(np.array_equal(losses["packed"], losses["int8"]),
          f"{name}: packed losses bitwise the int8 plan's "
          f"(max diff {float(np.abs(losses['packed'] - losses['int8']).max())})")
    out.update(losses=losses["packed"].tolist(), bitwise_int8=True)
    return {"line": out, "trainers": trainers}


def packed_serve(trainers, device, root: str) -> dict:
    """(e) 5 requests from a built server on the packed plan and from its
    export (both captured, counted from 0), bitwise equal to each other and
    to a server on the int8 plan, from the packed trainer's weights."""
    import os

    from hypergef_tpu_torch import serve
    from hypergef_tpu_torch.data.synthetic import random_features

    tr = trainers["packed"]
    cfg, hg = tr.cfg, tr.hg
    nfeat, nclass = int(tr.x.shape[1]), tr.nclass
    params = tr.model.state_dict()
    xs = [torch.as_tensor(random_features(hg.num_nodes, nfeat, nclass, seed=350 + i)[0],
                          device=device) for i in range(REQUESTS)]
    counters = kernel_counters()
    per = {"fused_packed": 2}  # two layers a request

    def counted(make):
        torch.cuda.synchronize()
        for module, attr in counters.values():
            setattr(module, attr, 0)
        server = make()
        answers = [server.predict(x) for x in xs]
        torch.cuda.synchronize()
        launched = {k: getattr(module, attr) for k, (module, attr) in counters.items()}
        check(server.compiled, "the server is recorded")
        want = {k: 2 * per.get(k, 0) for k in counters}  # warm-up and recording
        check(launched == want, f"a packed server launched {launched}, want {want}")
        check_replays("the packed request graph", graph_kernels(server._graph), counters, per,
                      REQUESTS)
        return answers, {k: v for k, v in launched.items() if v}

    built, built_launches = counted(lambda: serve.ServingModel(
        cfg, hg, nfeat, nclass, device, params=params, plan=tr.plan))
    path = os.path.join(root, "packed.hgefsrv")
    meta = serve.export_trainer(tr, path)
    exported, export_launches = counted(lambda: serve.ServingModel.load(path))
    int8 = serve.ServingModel(cfg, hg, nfeat, nclass, device, params=params,
                              plan=trainers["int8"].plan, compiled=False)
    for i, (a, b, x) in enumerate(zip(built, exported, xs)):
        c = int8.predict(x)
        check(torch.equal(a, b), f"request {i}: the export answers as the built server")
        check(torch.equal(a, c), f"request {i}: the packed plan answers as the int8 plan")
        check(tuple(a.shape) == (hg.num_nodes, nclass) and bool(torch.isfinite(a).all()),
              "finite answers of the right shape")
    return {"requests": REQUESTS, "built_launches": built_launches,
            "export_launches": export_launches, "payload_bytes": meta["payload_bytes"],
            "bitwise": ["built", "export", "int8 plan"]}


def packed_shard(hg, device) -> dict:
    """(f) ``local_two_stage`` on each slice of a D = 4 packed plan, forward
    and backward, bitwise the unpacked plan's."""
    from hypergef_tpu_torch.parallel import dense_shard

    plans = {p: dense_shard.plan_sharded_dense(hg, PACKED_SHARDS, packed=p)
             for p in (False, True)}
    rng = np.random.default_rng(21)
    x = torch.as_tensor(rng.normal(size=(hg.num_nodes, 32)).astype(np.float32), device=device)
    cot = torch.as_tensor(rng.normal(size=(hg.num_nodes, 32)).astype(np.float32), device=device)
    for r in range(PACKED_SHARDS):
        res = []
        for packed, plan in plans.items():
            loc = plan.local(r, device)
            xt = x.clone().requires_grad_(True)
            out = dense_shard.local_two_stage(loc, xt)
            (dx,) = torch.autograd.grad(out, xt, cot)
            res.append((out, dx))
        check(torch.equal(res[0][0], res[1][0]) and torch.equal(res[0][1], res[1][1]),
              f"rank {r}: the packed slice's product and gradient are the unpacked one's")
    return {"shards": PACKED_SHARDS, "e_pad": plans[True].e_pad,
            "slice_mb": {("packed" if p else "int8"): plan.table_bytes_per_device() / 1e6
                         for p, plan in plans.items()}, "bitwise_unpacked": True}


def time_packed(tables, name: str) -> dict:
    """(g) The packed kernel, the int8 kernel, the packed plain twin (the
    unpack and the plain form) and the int8 row's two library products on a
    bf16 copy of H made before the window, in turns, at F = 32. The bound:
    the carrier, x, the scales and the output moved once (``bound_ms``),
    and with the carrier read in each stage (``bound_table_twice_ms``)."""
    from hypergef_tpu_torch.ops import fused_dense
    from hypergef_tpu_torch.sparse.planner import unpack_nibbles

    h, carrier, x, se, sv = tables.operands(name, 32, 7)
    e = int(h.shape[1])
    hb = h.to(torch.bfloat16)

    def library():
        xe = torch.mm(hb.t(), x.to(torch.bfloat16), out_dtype=torch.float32) * se
        return torch.mm(hb, xe.to(torch.bfloat16), out_dtype=torch.float32) * sv

    fns = {
        "kernel": lambda: fused_dense.fused_dense_two_stage(carrier, x, se, sv, packed=True),
        "int8": lambda: fused_dense.fused_dense_two_stage(h, x, se, sv),
        "plain": lambda: fused_dense.fused_dense_two_stage_plain(unpack_nibbles(carrier, e),
                                                                 x, se, sv),
        "library": library,
    }
    out = time_turns(fns, ("plain", "kernel", "int8", "library",
                           "library", "int8", "kernel", "plain"))
    ops_count = 4 * int((h != 0).sum()) * 32
    moved = nbytes(x, se, sv) + nbytes(x)
    out.update(bound(nbytes(carrier) + moved, ops_count))
    out["bound_table_twice_ms"] = bound(2 * nbytes(carrier) + moved, ops_count)["bound_ms"]
    out["int8_bound_table_twice_ms"] = bound(2 * nbytes(h) + moved, ops_count)["bound_ms"]
    out.update(int8_table_mb=nbytes(h) / 1e6, carrier_mb=nbytes(carrier) / 1e6)
    return out


def packed_phase(device, card: str, graphs) -> dict:
    """Phase 35: the packed-int4 dense incidence on the card, (a)-(g) of the
    module docstring. ``launches`` holds the packed kernel's launches on the
    phase's paths: the packed Trainer's steps, the built server and the
    exported one."""
    import tempfile

    t0 = time.perf_counter()
    graphs = {**graphs, "20news counts 7": repeated_incidences(graphs["20news"], 16)}
    tables = PackedTables(graphs, device)
    out = {"cases": [check_packed(tables, *c) for c in PACKED_CASES]}
    check(out["cases"][-1]["max_count"] == 7, "the repeated table holds counts of 7")
    out["kernels_per_call"] = packed_kernels_per_call(tables)
    out["memory"] = [packed_call_memory(tables, g) for g in ("20news", "pubmed_real")]
    out["backward"] = [check_packed_backward(tables, "pubmed_real", 32, 6),
                       check_packed_backward(tables, "20news", 32, 4),
                       check_packed_backward(tables, "20news counts 7", 4, 5)]
    out["a_c_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    trained = {name: packed_train(name, tables, device) for name in ("20news", "pubmed_real")}
    out["trained"] = {name: t["line"] for name, t in trained.items()}
    with tempfile.TemporaryDirectory() as root:
        out["served"] = packed_serve(trained["20news"]["trainers"], device, root)
    out["d_e_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    out["shard"] = packed_shard(graphs["pubmed_real"], device)
    out["times"] = {g: time_packed(tables, g) for g in ("20news", "cora", "pubmed_real")}
    out["f_g_s"] = time.perf_counter() - t0
    out["launches"] = (out["trained"]["20news"]["packed"]["launches"]["fused_packed"]
                       + out["served"]["built_launches"]["fused_packed"]
                       + out["served"]["export_launches"]["fused_packed"])
    for c in out["cases"]:
        print(f"phase 35 a packed kernel vs int8 vs plain: {json.dumps(c)}", flush=True)
    print(f"phase 35 b CUDA kernels a call (torch.profiler): "
          f"{json.dumps(out['kernels_per_call'])}; peak memory over a call: "
          f"{json.dumps(out['memory'])}", flush=True)
    print(f"phase 35 c backward: {json.dumps(out['backward'])}", flush=True)
    for name, t in out["trained"].items():
        print(f"phase 35 d train {name}: {json.dumps(t)}", flush=True)
    print(f"phase 35 e serve: {json.dumps(out['served'])}", flush=True)
    print(f"phase 35 f shard: {json.dumps(out['shard'])}", flush=True)
    print(f"phase 35 g times (ms, CUDA events behind a queued sleep, median of 20; card {card}) "
          "at F=32: " + "; ".join(
              f"{g} packed {t['kernel']} int8 {t['int8']} plain {t['plain']} library "
              f"{t['library']} bound {t['bound_ms']} (carrier twice "
              f"{t['bound_table_twice_ms']}; int8 table twice {t['int8_bound_table_twice_ms']}); "
              f"tables int8 {t['int8_table_mb']} MB, carrier {t['carrier_mb']} MB"
              for g, t in out["times"].items()), flush=True)
    print(f"phase 35 seconds: a-c {out['a_c_s']:.2f}, d-e {out['d_e_s']:.2f}, "
          f"f-g {out['f_g_s']:.2f}; launches {out['launches']}", flush=True)
    return out



# phase 36: the op-level counts and the profiler (utils/profiling.py). (a)
# fig8 at cora and pubmed on the card and on the CPU; (b) cost_analysis of one
# eager training step on three routes: its kernel ops against the launch
# counters, and against the same step's count on the CPU; (c) profiler
# sessions in this long process, each followed by a recorded step held
# against the eager one, the last through trace()
FIG8_ROUTES = [("cora", "xla"), ("cora", "cumsum"), ("cora", "tree"), ("cora", "dense"),
               ("pubmed", "xla"), ("pubmed", "cumsum"), ("pubmed", "tree")]
PROFILE_SESSIONS = 5
PROFILE_FIT_STEPS = 3
# each kernel op of a count and the counter (kernel_counters' names, with
# the fused dense V→E phases') its launches raise
COUNTED_BY = {"fused_dense_two_stage": "fused", "fused_dense_two_stage_packed": "fused_packed",
              "fused_dense_v2e": "v2e", "fused_dense_v2e_packed": "packed_v2e",
              "ell_gather_sum": "gather", "aligned_band": "band",
              "aligned_masked_argmax": "argmax", "aligned_masked_argsum": "argsum",
              "bitmm": "bitmm", "gather_segment_sum": "segsum", "record_routed_dx": "recsum",
              "row_gather": "row_gather", "chunk_masked_sum": "chunk_sum",
              "chunk_masked_sum_ring": "chunk_sum", "scaled_copy": "scaled_copy"}


def counted_step(problem, dev, counters) -> dict:
    """The count of one eager training step on ``dev`` (after one step that
    builds the route's lazy tables), with the launches it made."""
    from hypergef_tpu_torch.train.trainer import Trainer
    from hypergef_tpu_torch.utils import profiling

    cfg, hg, x, y, split, plan = problem
    tr = Trainer(cfg, hg, x, y, plan=plan, device=dev, compiled=False)
    idx = torch.as_tensor(split["train"], device=dev)
    tr.step(idx)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    for module, attr in counters.values():
        setattr(module, attr, 0)
    count = profiling.cost_analysis(tr.step, idx, device=dev)
    count["launched"] = {k: getattr(m, a) for k, (m, a) in counters.items() if getattr(m, a)}
    return count


def profiling_phase(device, card: str, graphs, sbm, al_plan) -> dict:
    """Phase 36 (a)-(c)."""
    import os
    from pathlib import Path

    from hypergef_tpu_torch.experiments import fig8
    from hypergef_tpu_torch.ops import fused_dense
    from hypergef_tpu_torch.train.trainer import Trainer
    from hypergef_tpu_torch.utils import profiling

    build = Path(__file__).resolve().parent / "build"
    out = {}
    # (a) each route's count on the card beside its count on the CPU
    t0 = time.perf_counter()
    rows = {dev: fig8.main(["--configs", "cora,pubmed", "--device", dev,
                            "--out", str(build / f"chip_smoke_fig8_{dev}.csv")])
            for dev in ("cuda", "cpu")}
    for dev, rs in rows.items():
        check([(r["graph"], r["route"]) for r in rs] == FIG8_ROUTES,
              f"fig8 on {dev}: JAX's routes, got {[(r['graph'], r['route']) for r in rs]}")
        check(all(np.isfinite(r["bytes"]) and r["bytes"] > 0 and np.isfinite(r["flops"])
                  for r in rs), f"fig8 on {dev}: finite counts")
    out["fig8"] = [{"graph": c["graph"], "route": c["route"], "card_bytes": c["bytes"],
                    "cpu_bytes": p["bytes"], "card_flops": c["flops"], "cpu_flops": p["flops"],
                    "card_ratio": c["ratio"], "cpu_ratio": p["ratio"]}
                   for c, p in zip(rows["cuda"], rows["cpu"])]
    out["a_s"] = time.perf_counter() - t0
    # (b) kernel ops against the launch counters, and against the CPU's count
    t0 = time.perf_counter()
    counters = {**kernel_counters(), "v2e": (fused_dense, "v2e_launches"),
                "packed_v2e": (fused_dense, "packed_v2e_launches")}
    steps = {"20news pallas": train_problem("20news"),
             "coauthor_dblp cumsum": default_problem(graphs["coauthor_dblp"], DBLP_NFEAT,
                                                     DBLP_NCLASS, backend="cumsum"),
             "sbm60k aligned kernel": sbm_problem(sbm, al_plan)}
    out["steps"] = {}
    for name, problem in steps.items():
        card_count = counted_step(problem, device, counters)
        cpu_count = counted_step(problem, torch.device("cpu"), counters)
        by_counter = {}
        for kernel, row in card_count["kernels"].items():
            by_counter[COUNTED_BY[kernel]] = by_counter.get(COUNTED_BY[kernel], 0) + row["count"]
        check(card_count["kernel_ops"] > 0 and by_counter == card_count["launched"],
              f"{name}: kernel ops {by_counter} against launches {card_count['launched']}")
        check(not cpu_count["launched"], f"{name}: the CPU step launched {cpu_count['launched']}")
        check(card_count["kernels"] == cpu_count["kernels"],
              f"{name}: the card's kernel ops {card_count['kernels']} against the CPU's "
              f"{cpu_count['kernels']}")
        out["steps"][name] = {
            "kernels": card_count["kernels"], "launched": card_count["launched"],
            **{f"{dev}_{k}": c[k] for dev, c in (("card", card_count), ("cpu", cpu_count))
               for k in ("flops", "bytes accessed", "kernel_ops")},
            "card_aten_ops": sum(r["count"] for r in card_count["ops"].values()),
            "cpu_aten_ops": sum(r["count"] for r in cpu_count["ops"].values())}
    out["b_s"] = time.perf_counter() - t0
    # (c) sessions in this long process, a recording after each
    t0 = time.perf_counter()
    cfg, hg, x, y, split, _ = train_problem("20news")
    ops = kernel_operands(graphs["20news"], 32, 1, device)
    traces = build / "chip_smoke_traces"
    out["sessions"] = []
    for i in range(PROFILE_SESSIONS):
        last = i == PROFILE_SESSIONS - 1
        with (profiling.trace(str(traces), device) if last else profiling.profiler()) as prof:
            fused_dense.fused_dense_two_stage(*ops)
            torch.cuda.synchronize()
        names = [e.name for e in profiling.device_events(prof)]
        eager, captured = (Trainer(cfg, hg, x, y, device=device, compiled=c)
                           for c in (False, True))
        want, got = (t.fit(split["train"], epochs=PROFILE_FIT_STEPS, warmup=0)
                     for t in (eager, captured))
        check(len(names) == 1 and "fused_dense_kernel" in names[0],
              f"profiler session {i + 1}: one fused dense kernel, got {names}")
        check(got["step"] == "captured" and np.array_equal(got["losses"], want["losses"]),
              f"the recording after session {i + 1}: losses {got['losses']} against eager "
              f"{want['losses']}")
        out["sessions"].append({"session": i + 1, "device_events": len(names)})
    (path,) = traces.glob(f"trace-{os.getpid()}-*.json")
    events = json.loads(path.read_text())["traceEvents"]
    kernels = [e for e in events if e.get("cat") == "kernel"]
    check(any("fused_dense_kernel" in e.get("name", "") for e in kernels),
          f"the trace holds the fused dense kernel, got {[e.get('name') for e in kernels]}")
    out["trace"] = {"path": str(path.relative_to(build.parent)), "events": len(events),
                    "kernel_events": len(kernels)}
    out["c_s"] = time.perf_counter() - t0
    for r in out["fig8"]:
        print(f"phase 36 a fig8 (counts, not times) {r['graph']},{r['route']}: card bytes="
              f"{r['card_bytes']:.0f} flops={r['card_flops']:.0f} ratio={r['card_ratio']:.3f} | "
              f"cpu bytes={r['cpu_bytes']:.0f} flops={r['cpu_flops']:.0f} "
              f"ratio={r['cpu_ratio']:.3f}", flush=True)
    for name, r in out["steps"].items():
        print(f"phase 36 b cost_analysis {name} (card {card}): {json.dumps(r)}", flush=True)
    print(f"phase 36 c profiler sessions, a recorded step after each: "
          f"{json.dumps(out['sessions'])}; trace {json.dumps(out['trace'])}", flush=True)
    print(f"phase 36 seconds: a {out['a_s']:.2f}, b {out['b_s']:.2f}, c {out['c_s']:.2f}",
          flush=True)
    return out

def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if sys.argv[1:] == ["--profile"]:
        print(f"card: {card_line()}", flush=True)
        profile_band(torch.device("cuda", 0))
        profile_steps(torch.device("cuda", 0))
        return 0
    import shutil
    from pathlib import Path

    from hypergef_tpu_torch.ops import _build
    from hypergef_tpu_torch.utils import graphs as cuda_graphs

    run_t0 = time.perf_counter()
    device = torch.device("cuda", 0)
    card = card_line()
    # phases 1-25 write each recorded graph out, to read its kernel nodes
    dumps = Path(__file__).resolve().parent / "build" / "chip_smoke_graphs"
    shutil.rmtree(dumps, ignore_errors=True)
    dumps.mkdir(parents=True)
    cuda_graphs.DUMP_DIR = str(dumps)
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
                   {"fused": (fused_dense, "launches", 2)})
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
    gather_cases = [("edge", 32, True), ("edge", 3, True), ("vertex", 32, True),
                    ("vertex", 3, True), ("edge", 32, False)]
    gathers = [check_gather(tables[stage], f, seed, device, aligned)
               for seed, (stage, f, aligned) in enumerate(gather_cases)]
    for (stage, _, _), g in zip(gather_cases, gathers):
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
                    for stage, f in (("edge", 32), ("edge", 3), ("vertex", 32), ("vertex", 3))}
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

    # 26. the compiled step: eager against captured on each training and
    # request cell of phases 3-24, its recordings timed without dumps
    cuda_graphs.DUMP_DIR = None
    shutil.rmtree(dumps, ignore_errors=True)
    t0 = time.perf_counter()
    compiled_phase(device, card, *compiled_cells(problems, aligned, streamed,
                                                   defaults["problems"], graphs))
    print(f"phase 26: {time.perf_counter() - t0:.2f} s", flush=True)

    # 27. the training CLI on the card
    t0 = time.perf_counter()
    clied = cli_phase(device, card)
    for key in ("a", "segsum", "b", "c", "d pallas", "d max", "g", "subprocess"):
        print(f"phase 27 cli {key} (card {card}): {json.dumps(clied[key])}", flush=True)
    for name, line in clied["e"].items():
        print(f"phase 27 cli e {name}: {json.dumps(line)}", flush=True)
    for name, line in clied["f"].items():
        print(f"phase 27 cli f {name} --validate-parity: {line}", flush=True)
    a, b, c, g = clied["a"], clied["b"], clied["c"], clied["g"]
    print(f"phase 27 summary (card {card}): coauthor_dblp-sized powerlaw run on "
          f"{a['route']}: epoch {a['train_epoch_time_s'] * 1e3} ms, request "
          f"{a['inference_time_s'] * 1e3} ms (CUDA events, host included); tune sweep "
          f"(us a call, F=32): {json.dumps(b['sweep_us'])}, pick {b['pick']} "
          f"{json.dumps(b['pick_params'])} against the ladder's {b['ladder_pick']}; plan "
          f"cache: Trainer set-up {c['build_setup_s']} s building, {c['load_setup_s']} s "
          f"loading; --profile: {g['in_use_mib']} MiB in use, {g['peak_mib']} MiB peak; "
          f"segment-sum kernel at F=32 (ms, V→E / E→V, longest segment "
          f"{clied['segsum']['v2e']['longest_segment']} / "
          f"{clied['segsum']['e2v']['longest_segment']}): "
          f"{clied['segsum']['v2e']['kernel']} / {clied['segsum']['e2v']['kernel']}; "
          f"launches {json.dumps(clied['launches'])}", flush=True)
    print(f"phase 27: {time.perf_counter() - t0:.2f} s", flush=True)

    # 28. the serving export; 29. minibatch training
    cuda_graphs.DUMP_DIR = str(dumps)
    dumps.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    exported = export_phase(device, card, export_cells(problems, aligned, streamed,
                                                       defaults["problems"]))
    cuda_graphs.DUMP_DIR = None
    shutil.rmtree(dumps, ignore_errors=True)
    print(f"phase 28: {time.perf_counter() - t0:.2f} s", flush=True)
    t0 = time.perf_counter()
    minibatched = minibatch_phase(device, card, streamed)
    print(f"phase 29: {time.perf_counter() - t0:.2f} s", flush=True)
    t0 = time.perf_counter()
    distributed = dist_phase(device, card, aligned)
    print(f"phase 30: {time.perf_counter() - t0:.2f} s", flush=True)
    t0 = time.perf_counter()
    serial = serial_phase(device, card, aligned, distributed["a"])
    print(f"phase 31: {time.perf_counter() - t0:.2f} s", flush=True)
    t0 = time.perf_counter()
    drivers = driver_phase(device, card)
    print(f"phase 32: {time.perf_counter() - t0:.2f} s", flush=True)
    t0 = time.perf_counter()
    scaled = scale_phase(device, card)
    print(f"phase 33: {time.perf_counter() - t0:.2f} s", flush=True)
    # 34. the ell, bsr and multihot routes; their recordings are read as
    # phases 1-25's are
    cuda_graphs.DUMP_DIR = str(dumps)
    dumps.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    routed = routes_phase(device, card, aligned["sbm"])
    print(f"phase 34: {time.perf_counter() - t0:.2f} s", flush=True)
    # 35. the packed-int4 dense incidence, its recordings read as phase 34's
    t0 = time.perf_counter()
    packed = packed_phase(device, card, {**graphs, "cora": cora})
    cuda_graphs.DUMP_DIR = None
    shutil.rmtree(dumps, ignore_errors=True)
    print(f"phase 35: {time.perf_counter() - t0:.2f} s", flush=True)
    # 36. the op-level counts and the profiler
    t0 = time.perf_counter()
    profiling_phase(device, card, ladder_graphs, aligned["sbm"], aligned["plan"])
    print(f"phase 36: {time.perf_counter() - t0:.2f} s", flush=True)

    fd_bwd_err = max(max(c["max_abs_err"].values()) for c in bwd)
    timed = {"fused_dense_two_stage": times["20news"], "ell_gather_sum": gather_times["edge F=32"],
             "aligned_band": aligned["band_times"]["edge F=32"],
             "aligned_masked_argmax": maxed["argmax_times"]["edge F=32"],
             "aligned_masked_argsum": maxed["argsum_times"]["vertex F=32"],
             "bitstream_bitmm": streamed["bitmm_times"]["stream100k Ht F=32"],
             "gather_segment_sum": dtimes["segsum_times"]["v2e F=32"],
             "record_routed_dx": maxed["record_times"]["F=32"],
             "fused_dense_two_stage_packed": packed["times"]["20news"],
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
        # forward and backward launches of the serving and the pallas training
        # paths, and of the CLI's pallas run (phase 27)
        "launches": (served["launches"]["fused"] + trained["20news"]["launches"]["fused"]
                     + clied["launches"]["fused"]),
        "cli_launches": clied["launches"]["fused"],
        "max_abs_err": max(max(c["max_abs_err"] for c in cases), fd_bwd_err),
        "cuda_kernels_per_call": fd_kernels,
        **{f"{g}_{k}": times[g][key] for g in ("cora", "pubmed_real")
           for k, key in (("ms", "kernel"), ("plain_ms", "plain"), ("library_ms", "library"),
                          ("bound_ms", "bound_ms"))},
        "pubmed_real_bound_table_twice_ms": times["pubmed_real"]["bound_table_twice_ms"],
        "bwd_ms": bwd_times["20news"]["kernel"],
        "bwd_plain_ms": bwd_times["20news"]["plain"],
    }, {
        "name": "fused_dense_two_stage_packed",
        "route": "cuda",
        "source": "hypergef_tpu_torch/csrc/fused_dense.cu",
        # the packed Trainer's steps, the built server and its export (phase 35)
        "launches": packed["launches"],
        "max_abs_err": max(c["max_abs_err"] for c in packed["cases"]),
        "bitwise_int8": all(c["bitwise_int8"] for c in packed["cases"]),
        "cuda_kernels_per_call": packed["kernels_per_call"]["two_stage"],
        "peak_growth_bytes": {c["graph"]: c["peak_growth_bytes"] for c in packed["memory"]},
        "int8_ms": packed["times"]["20news"]["int8"],
        **{f"{g}_{k}": packed["times"][g][key] for g in ("cora", "pubmed_real")
           for k, key in (("ms", "kernel"), ("int8_ms", "int8"), ("plain_ms", "plain"),
                          ("library_ms", "library"), ("bound_ms", "bound_ms"),
                          ("bound_table_twice_ms", "bound_table_twice_ms"))},
        "table_mb": {g: {"int8": t["int8_table_mb"], "carrier": t["carrier_mb"]}
                     for g, t in packed["times"].items()},
    }, {
        "name": "ell_gather_sum",
        "route": "cuda",
        "source": "hypergef_tpu_torch/csrc/ell_gather.cu",
        "launches": trained["pubmed_real"]["launches"]["gather"],
        # the ELL level-0 probes with x resident (phase 25)
        "probe_launches": probed["launches"]["ell_gather_sum"],
        "max_abs_err": max([g["max_abs_err"] for g in gathers] + [probe_err["ell_gather_sum"]]),
        # the line's own times are the pubmed_real edge stage's at F = 32;
        # the other stage and widths beside them, and the 2M-row scale
        **{f"{stage}_f{w}_{k}": gather_times[f"{stage} F={w}"][key]
           for stage, w in (("edge", 3), ("vertex", 32), ("vertex", 3))
           for k, key in (("ms", "kernel"), ("plain_ms", "plain"), ("library_ms", "library"),
                          ("bound_ms", "bound_ms"))},
        **r2_big(probed, "big pallas_vmem"),
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
        # and the CLI's runs on the cumsum route (phase 27)
        "launches": sum(dblp_segsum) + clied["launches"]["segsum"],
        "cli_launches": clied["launches"]["segsum"],
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
                     + defaults["trained"]["coauthor_dblp HGNN max"]["launches"]["recsum"]
                     + clied["launches"]["recsum"]),
        # the CLI's max run (phase 27)
        "cli_launches": clied["launches"]["recsum"],
        "max_abs_err": max(c["max_abs_err"] for c in segsum["records"]),
        # the line's own times are SBM-60k's at F = 32; every graph at F = 32
        # and at its classes' width beside them
        **{f"{g}_f{w[2:]}_{k}": t[w][key]
           for g, t in (("sbm60k", maxed["record_times"]),
                        ("stream100k", streamed["record_times"]),
                        ("coauthor_dblp", dtimes["record_times"]))
           for w in t
           for k, key in (("ms", "kernel"), ("plain_ms", "plain"), ("library_ms", "library"),
                          ("bound_ms", "bound_ms"))},
        "layout_bytes": {c["graph"]: c["layout_bytes"] for c in segsum["records"]},
        "layout_build_s": {c["graph"]: c["layout_build_s"] for c in segsum["records"]},
    }]
    # the probe kernels: their path is phase 25, the checked call of each case
    for name, source in (("row_gather", "probes.cu"), ("chunk_masked_sum", "probes.cu"),
                         ("scaled_copy", "probes.cu")):
        kernels.append({"name": name, "route": "cuda",
                        "source": f"hypergef_tpu_torch/csrc/{source}",
                        "launches": probed["launches"][name],
                        "max_abs_err": probe_err[name]})
    # the chunk sum's ring (pallas_dma_stage's form) at probe_r2_gather's
    # 2M-row scale, each depth, beside the gathered form the line times
    from hypergef_tpu_torch.probes import RING_DEPTHS

    (chunk_sum,) = [k for k in kernels if k["name"] == "chunk_masked_sum"]
    chunk_sum.update({f"ring_n_buf{nb}_{k}": v for nb in RING_DEPTHS
                      for k, v in r2_big(probed, f"big pallas_dma n_buf={nb}").items()})
    # the row gather: each ring depth at the take the line times, and every
    # form at probe_r2_gather's 2M-row scale with its two bounds; the
    # scaled copy at [1,048,576, 128] and an empty launch's time
    (rows,) = [k for k in kernels if k["name"] == "row_gather"]
    rows.update({f"ring_n_buf{nb}_ms": probed["times"]["row_gather"][f"ring_n_buf{nb}"]
                 for nb in RING_DEPTHS})
    big = {r["case"].removeprefix("big xla_gather "): r for r in probed["rows"]
           if r["probe"] == "probe_r2_gather" and r["case"].startswith("big xla_gather")}
    rows.update({f"big_{form.replace(' ', '_').replace('=', '')}_ms": r["ms"]
                 for form, r in big.items()})
    rows.update({"big_library_ms": big["direct"]["library_ms"],
                 "big_bound_ms": probed["times"]["r2 gather bound"]["bound_ms"],
                 "big_bound_named_ms": probed["times"]["r2 gather bound"]["bound_named_ms"]})
    (copy,) = [k for k in kernels if k["name"] == "scaled_copy"]
    copy.update({f"large_{k}": probed["times"]["scaled_copy"][f"large_{key}"]
                 for k, key in (("ms", "kernel"), ("plain_ms", "plain"),
                                ("library_ms", "library"), ("bound_ms", "bound_ms"))})
    copy["empty_launch_ms"] = probed["times"]["scaled_copy"]["empty_launch_ms"]
    # phases 28-29: the exported requests and the minibatch steps
    counter_of = {"fused_dense_two_stage": "fused",
                  "fused_dense_two_stage_packed": "fused_packed", "ell_gather_sum": "gather",
                  "aligned_band": "band", "aligned_masked_argmax": "argmax",
                  "aligned_masked_argsum": "argsum", "bitstream_bitmm": "bitmm",
                  "gather_segment_sum": "segsum", "record_routed_dx": "recsum"}
    for k in kernels:
        c = counter_of.get(k["name"])
        if c is not None:
            k["export_launches"] = sum(cell["launches"][c] for cell in exported.values()
                                       if "launches" in cell)
            k["minibatch_launches"] = sum(cell["launches"][c] for cell in minibatched.values())
            k["dist_launches"] = distributed["launches"].get(c, 0)
            k["serial_launches"] = serial["launches"].get(c, 0)
            k["driver_launches"] = drivers["launches"].get(c, 0)
            k["scale_launches"] = scaled["launches"].get(c, 0)
            k["routes_launches"] = routed["launches"].get(c, 0)
            k["launches"] += (k["export_launches"] + k["minibatch_launches"]
                              + k["dist_launches"] + k["serial_launches"]
                              + k["driver_launches"] + k["scale_launches"]
                              + k["routes_launches"])
    # the segment sum over each minibatch cell's padded runs (the recorded
    # steps' tables) against the batch's exact runs, F = 32 (phase 29)
    (segsum_line,) = [k for k in kernels if k["name"] == "gather_segment_sum"]
    for cell, res in minibatched.items():
        for side in ("v2e", "e2v"):
            t = res["padded_runs"][f"{side} F=32"]
            segsum_line.update({f"minibatch_{cell}_{side}_{key}": t[key] for key in (
                "padded_ms", "exact_ms", "plain_ms", "library_ms", "bound_ms", "runs_padded",
                "runs_exact")})
    for k in kernels:
        t = timed[k["name"]]
        sites = KERNEL_SITES.get(SITE_OF_FORM.get(k["name"], k["name"]), [RECORD_SUM_SITE])
        k.update({"replaces": sites[0], **({"also_replaces": sites[1:]} if sites[1:] else {}),
                  "ms": t["kernel"], "plain_ms": t["plain"], "bound_ms": t["bound_ms"],
                  "bound_by": t["bound_by"], "library_ms": t.get("library")})
        check(k["launches"] > 0, f"{k['name']} was launched on its path")
    print(f"chip_smoke: {time.perf_counter() - run_t0:.2f} s", flush=True)
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
