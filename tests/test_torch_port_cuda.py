"""The port's CUDA kernels against their plain versions, on the card.

Every test here needs an NVIDIA Hopper card and skips without one. This
file imports no JAX, so it also runs where JAX is not installed:

    python -m pytest --noconftest -m cuda tests/test_torch_port_cuda.py

Tolerances:

* fused dense op, forward and backward: rtol 1e-2 and atol 1e-2·max|plain|.
  Kernel and plain version round the same operands to bf16, but sum in
  different orders, so Xe can round to a neighbouring bf16 value (2^-8
  relative) before the second stage.
* gather kernel: bitwise equal to the sequential plain loop, which rounds
  each product and each sum in the same order.
* band kernel (aligned stages): rtol 1e-5 and atol 1e-5·max|plain|. The
  products are exact in f32 in both forms; the kernel sums each row in one
  order (window, then spill), the plain chain in bmm's order and band and
  spill apart.
* masked argmax kernel: values and ids bitwise equal to the twin (a max is
  one of its inputs; both take the lowest id among equal values).
* masked arg-sum kernel: rtol 1e-6 and atol 1e-6·max|plain| (the same few
  f32 terms summed in another order).
* bit-packed product kernel: rtol 1e-5 and atol 1e-5·max|plain|. The
  products are exact (0/1 times bf16); the kernel sums each row in its
  layout's order (word ascending, then bit), the twin in its matmul's
  order.
* segment-sum kernel and its masked form, the record-routed sum: rtol 1e-6
  and atol 1e-6·max|plain| (the same f32 terms: every value is one lane's
  f32 sum in CSR order, long segments included, against segment_reduce's
  own order).
"""

import dataclasses
import functools
import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

from hypergef_tpu_torch.data.synthetic import community_hypergraph
from hypergef_tpu_torch.ops import (
    aligned_band, aligned_max, bitstream, ell_gather, fused, fused_dense,
)
from hypergef_tpu_torch.sparse import planner
from hypergef_tpu_torch.sparse.hypergraph import Hypergraph
from hypergef_tpu_torch.sparse.reorder import apply_vertex_order, community_reorder

pytestmark = pytest.mark.cuda

REPO = Path(__file__).resolve().parents[1]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _operands(n, e, f, density, seed, device):
    rng = np.random.default_rng(seed)
    h = (rng.random((n, e)) < density).astype(np.int8)
    h[rng.random((n, e)) < density / 8] = 3  # repeated incidences count too
    x = rng.normal(size=(n, f)).astype(np.float32)
    se = rng.uniform(0.1, 1.0, size=(e, 1)).astype(np.float32)
    sv = rng.uniform(0.1, 1.0, size=(n, 1)).astype(np.float32)
    return [torch.as_tensor(a, device=device) for a in (h, x, se, sv)]


@pytest.mark.parametrize(
    "n,e,f,density",
    [
        (5, 3, 1, 0.5),
        (120, 80, 8, 0.06),
        (301, 187, 17, 0.03),
        (1000, 500, 4, 0.01),
        (2048, 300, 40, 0.02),
        (16242, 100, 32, 0.04),
        (16242, 100, 100, 0.04),
        (2708, 2708, 32, 0.0015),
        (2708, 2708, 7, 0.0015),
        (19717, 7963, 32, 0.0014),
        (130, 4099, 3, 0.01),
        (3000, 17, 65, 0.2),
    ],
)
def test_kernel_matches_plain(cuda, n, e, f, density):
    h, x, se, sv = _operands(n, e, f, density, seed=n + e + f, device=cuda)
    before = fused_dense.launches
    got = fused_dense.fused_dense_two_stage(h, x, se, sv)
    again = fused_dense.fused_dense_two_stage(h, x, se, sv)
    torch.cuda.synchronize()
    assert fused_dense.launches == before + 2
    want = fused_dense.fused_dense_two_stage_plain(h, x, se, sv)
    scale = float(want.abs().max())
    torch.testing.assert_close(got, want, rtol=1e-2, atol=1e-2 * scale)
    assert torch.equal(got, again), "two runs differ"


@pytest.mark.parametrize("n,e,f,density", [(301, 187, 17, 0.03), (16242, 100, 4, 0.04),
                                           (2708, 2708, 32, 0.0015)])
def test_backward_matches_plain_formula(cuda, n, e, f, density):
    h, x, se, sv = _operands(n, e, f, density, seed=n + f, device=cuda)
    g = torch.as_tensor(np.random.default_rng(f).normal(size=(n, f)).astype(np.float32),
                        device=cuda)
    ts = [t.clone().requires_grad_(True) for t in (x, se, sv)]
    out = fused_dense.fused_dense_two_stage(h, *ts)
    before = (fused_dense.launches, fused_dense.v2e_launches)
    out.backward(g)
    torch.cuda.synchronize()
    # dx and d scale_v run the op once each, d scale_e its first phase twice
    assert (fused_dense.launches, fused_dense.v2e_launches) == (before[0] + 2, before[1] + 2)
    for name, t, want in zip(("dx", "d_scale_e", "d_scale_v"), ts,
                             fused_dense.fused_dense_backward_plain(h, x, se, sv, g)):
        scale = float(want.abs().max())
        torch.testing.assert_close(t.grad, want, rtol=1e-2, atol=1e-2 * scale, msg=name)


def _gather_operands(n, c, ngs, f, seed, device):
    rng = np.random.default_rng(seed)
    x = torch.as_tensor(rng.normal(size=(n, f)).astype(np.float32), device=device)
    gidx = torch.as_tensor(rng.integers(0, n, size=(c, ngs)).astype(np.int32), device=device)
    mask = torch.as_tensor((rng.random((c, ngs)) > 0.2).astype(np.float32), device=device)
    table = ell_gather.GatherTable(gidx=gidx, gidx_long=gidx.long(), mask=mask, num_inputs=n)
    return x, table


@pytest.mark.parametrize(
    "n,c,ngs,f",
    [(300, 700, 8, 16), (50, 3, 1, 1), (1000, 777, 5, 3), (2000, 1500, 37, 32),
     (500, 300, 12, 33), (19717, 9000, 12, 4), (7963, 20000, 4, 32)],
)
def test_gather_kernel_is_bitwise_plain(cuda, n, c, ngs, f):
    x, table = _gather_operands(n, c, ngs, f, seed=n + c + f, device=cuda)
    before = ell_gather.launches
    got = ell_gather.ell_gather_sum(x, table)
    again = ell_gather.ell_gather_sum(x, table)
    torch.cuda.synchronize()
    assert ell_gather.launches == before + 2
    want = ell_gather.ell_gather_sum_plain(x, table.gidx_long, table.mask)
    assert got.shape == want.shape == (c, f)
    assert torch.equal(got, want), float((got - want).abs().max())
    assert torch.equal(got, again), "two runs differ"


def test_gather_wrapper_rejects_what_the_kernel_does_not_take(cuda):
    x, table = _gather_operands(64, 32, 4, 8, seed=1, device=cuda)
    with pytest.raises(TypeError):
        ell_gather.ell_gather_sum(x.double(), table)
    with pytest.raises(TypeError):
        ell_gather.ell_gather_sum(x[:10], table)
    with pytest.raises(ValueError, match="contiguous"):
        ell_gather.ell_gather_sum(x.t().contiguous().t(), table)
    with pytest.raises(ValueError):
        ell_gather.ell_gather_sum(x.cpu(), table)


@pytest.mark.parametrize("offset", [1, 3, 8])
def test_kernel_reads_a_table_at_any_byte_offset(cuda, offset):
    """The table's rows are read as the aligned 16-byte words that hold
    them, so a table that starts off a 16-byte boundary (a view) gives the
    same result as a copy of it."""
    h, x, se, sv = _operands(777, 203, 12, 0.05, seed=offset, device=cuda)
    buf = torch.zeros(h.numel() + offset, dtype=torch.int8, device=cuda)
    view = buf[offset:].view(h.shape)
    view.copy_(h)
    assert view.data_ptr() % 16 != 0 or offset % 16 == 0
    got = fused_dense.fused_dense_two_stage(view, x, se, sv)
    assert torch.equal(got, fused_dense.fused_dense_two_stage(h, x, se, sv))


def test_kernel_is_one_cuda_kernel_a_call(cuda):
    from torch.profiler import ProfilerActivity, profile

    h, x, se, sv = _operands(16242, 100, 32, 0.04, seed=3, device=cuda)
    fused_dense.fused_dense_two_stage(h, x, se, sv)
    fused_dense._launch_v2e(h, x)
    torch.cuda.synchronize()
    for call in (lambda: fused_dense.fused_dense_two_stage(h, x, se, sv),
                 lambda: fused_dense._launch_v2e(h, x)):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            call()
            torch.cuda.synchronize()
        names = [e.name for e in prof.events()
                 if e.device_type == torch.autograd.DeviceType.CUDA]
        assert len(names) == 1 and "fused_dense_kernel" in names[0], names


def test_kernel_runs_on_two_streams_at_once(cuda):
    """Each call owns its scratch (partials, Xe): calls queued on two streams
    without waiting for each other each give the plain version's result,
    bitwise equal to the same call alone."""
    ops = [_operands(2708, 2708, 32, 0.0015, seed=s, device=cuda) for s in (1, 2)]
    alone = [fused_dense.fused_dense_two_stage(*o) for o in ops]
    streams = [torch.cuda.Stream(cuda) for _ in range(2)]
    torch.cuda.synchronize()
    outs = ([], [])
    for _ in range(20):
        for st, o, got in zip(streams, ops, outs):
            with torch.cuda.stream(st):
                got.append(fused_dense.fused_dense_two_stage(*o))
    torch.cuda.synchronize()
    for o, a, got in zip(ops, alone, outs):
        want = fused_dense.fused_dense_two_stage_plain(*o)
        torch.testing.assert_close(a, want, rtol=1e-2, atol=1e-2 * float(want.abs().max()))
        for g in got:
            assert torch.equal(g, a)


def test_entry_refuses_a_grid_beyond_the_coresident_limit(cuda):
    """A cooperative grid larger than the card holds at once is refused with
    an error (never run, never hung), and the wrapper's check raises on it."""
    from hypergef_tpu_torch.ops import _build

    h, x, se, sv = _operands(2708, 2708, 8, 0.0015, seed=4, device=cuda)
    lib = _build.load_library()
    sms, ctas = fused_dense._card(torch.cuda.current_device())
    ws = fused_dense.work_split(2708, 2708, 8, sms, ctas)
    out = torch.empty((2708, 8), device=cuda)
    pa = torch.empty((ws.splits_a, 2708, ws.fp), device=cuda)
    xe = torch.empty((2708, ws.fp), dtype=torch.bfloat16, device=cuda)
    pc = torch.empty((ws.splits_c, 2708, ws.fp), device=cuda)
    stream = torch.cuda.current_stream().cuda_stream

    def call(grid):
        return lib.hg_fused_dense_two_stage(
            h.data_ptr(), x.data_ptr(), se.data_ptr(), sv.data_ptr(), out.data_ptr(),
            pa.data_ptr(), xe.data_ptr(), pc.data_ptr(), 2708, 2708, 8, ws.splits_a, ws.k_a,
            ws.ways_a, ws.splits_c, ws.k_c, ws.ways_c, grid, stream)

    err = call(sms * 64 + 1)
    assert err != 0
    with pytest.raises(RuntimeError, match="launch failed"):
        fused_dense._raise_on(err, lib, "fused_dense_two_stage")
    assert call(ws.grid) == 0  # the refusal left no error behind
    want = fused_dense.fused_dense_two_stage_plain(h, x, se, sv)
    torch.testing.assert_close(out, want, rtol=1e-2, atol=1e-2 * float(want.abs().max()))


def test_wrapper_rejects_what_the_kernel_does_not_take(cuda):
    h, x, se, sv = _operands(64, 32, 8, 0.1, seed=1, device=cuda)
    with pytest.raises(TypeError):
        fused_dense.fused_dense_two_stage(h.float(), x, se, sv)
    with pytest.raises(ValueError, match="contiguous"):
        fused_dense.fused_dense_two_stage(h, x.t().contiguous().t(), se, sv)
    with pytest.raises(ValueError):
        fused_dense.fused_dense_two_stage(h.cpu(), x, se, sv)


def sorted_community_graph(n, e, comm, avg, noise, seed, duplicate=0.0):
    """A community graph from raw (shuffled) vertex ids, reordered by the
    coarsening pass, as bench.py builds its clustered graph. With
    ``duplicate`` that share of the incidences is listed twice, so the band
    and spill tables hold counts of 2."""
    hg = community_hypergraph(n, e, comm, avg, noise, seed)
    hg, _ = apply_vertex_order(hg, np.random.default_rng(7).permutation(n), sort_edges=False)
    hg, _ = community_reorder(hg)
    if duplicate:
        v = hg.ht_indices.astype(np.int64)
        ed = np.repeat(np.arange(e), np.diff(hg.ht_indptr))
        twice = np.random.default_rng(seed).random(v.size) < duplicate
        hg = Hypergraph.from_coo(np.concatenate([v, v[twice]]), np.concatenate([ed, ed[twice]]),
                                 num_nodes=n, num_edges=e, dedup=False)
    return hg


def split_buckets(st):
    """The same bucketed stage laid out as several band and spill buckets out
    of group order: odd groups' windows get one more block (block 0, with
    zero band columns), and the spilling groups go to two spill buckets, the
    first in reverse group order, padded to a common width with zero-row
    slots. Neither slot map is then the identity."""
    g_rows, b_rows, n = st.group_rows, st.block_rows, st.num_inputs
    band, win = {}, {}
    for b in st.buckets:
        for l, g in enumerate(b.group_ids):
            band[int(g)], win[int(g)] = b.b_dense[l], b.win_block[l]
    n_groups = len(st.base_slot)
    classes = {}
    for g in range(n_groups):
        classes.setdefault((g % 2, len(win[g])), []).append(g)
    buckets, base_slot, slot = [], np.zeros(n_groups, np.int32), 0
    for (odd, _), gids in sorted(classes.items()):
        bands = [np.concatenate([band[g], np.zeros((g_rows, b_rows * odd), np.int8)], axis=1)
                 for g in gids]
        wins = [np.concatenate([win[g], np.zeros(odd, np.int32)]) for g in gids]
        buckets.append(planner.AlignedBucket(np.stack(bands), np.stack(wins),
                                             np.asarray(gids, np.int32)))
        base_slot[gids] = slot + np.arange(len(gids))
        slot += len(gids)
    per_group = {}
    for sp in st.spills:
        for l, g in enumerate(sp.group_ids):
            per_group[int(g)] = (sp.b_spill[l], sp.spill_src[l])
    spilling = sorted(per_group)
    parts = [[g for g in spilling if g % 3 == 0][::-1], [g for g in spilling if g % 3]]
    spills, spill_slot, m = [], np.zeros(n_groups, np.int32), 0
    for gids in (p for p in parts if p):
        sw = max(per_group[g][1].size for g in gids)
        tabs = [np.pad(per_group[g][0], ((0, 0), (0, sw - per_group[g][0].shape[1])))
                for g in gids]
        srcs = [np.pad(per_group[g][1], (0, sw - per_group[g][1].size), constant_values=n)
                for g in gids]
        spills.append(planner.AlignedSpill(np.stack(tabs), np.stack(srcs).astype(np.int32),
                                           np.asarray(gids, np.int32)))
        spill_slot[gids] = m + np.arange(len(gids))
        m += len(gids)
    spill_slot[[g for g in range(n_groups) if g not in per_group]] = m
    return st._replace(buckets=tuple(buckets), spills=tuple(spills), base_slot=base_slot,
                       spill_slot=spill_slot)


def widen_windows(st, gids, extra):
    """The same bucketed stage with the windows of groups ``gids`` wider by
    ``extra`` blocks (block 0, with zero band columns), in a bucket of their
    own: groups far wider than the rest, which the band kernel splits."""
    g_rows, b_rows = st.group_rows, st.block_rows
    band, win = {}, {}
    for b in st.buckets:
        for l, g in enumerate(b.group_ids):
            band[int(g)], win[int(g)] = b.b_dense[l], b.win_block[l]
    buckets, base_slot, slot = [], np.zeros(len(st.base_slot), np.int32), 0
    for wide in (False, True):
        classes = {}
        for g in range(len(st.base_slot)):
            if (g in gids) == wide:
                classes.setdefault(len(win[g]), []).append(g)
        for _, members in sorted(classes.items()):
            pad = extra if wide else 0
            buckets.append(planner.AlignedBucket(
                np.stack([np.pad(band[g], ((0, 0), (0, pad * b_rows))) for g in members]),
                np.stack([np.pad(win[g], (0, pad)) for g in members]).astype(np.int32),
                np.asarray(members, np.int32)))
            base_slot[members] = slot + np.arange(len(members))
            slot += len(members)
    return st._replace(buckets=tuple(buckets), base_slot=base_slot)


def widen_spills(st, extra):
    """The same bucketed stage with ``extra`` more slots in every spill
    bucket (zero columns whose source is the zero row N), so no spill width
    is a multiple of 4 and the spill tables' rows lie at odd byte offsets."""
    n = st.num_inputs
    spills = tuple(
        planner.AlignedSpill(np.pad(sp.b_spill, ((0, 0), (0, 0), (0, extra))),
                             np.pad(sp.spill_src, ((0, 0), (0, extra)),
                                    constant_values=n).astype(np.int32),
                             sp.group_ids)
        for sp in st.spills)
    return st._replace(spills=spills)


def spill_only_rows(st):
    """The same stage with the window counts of every row that spills set to
    zero: those rows reach their sources through spill slots alone."""
    if isinstance(st, planner.AlignedStage):
        band = st.b_dense.copy()
        band[(st.b_spill != 0).any(axis=2)] = 0
        return st._replace(b_dense=band)
    spilling = {int(g): (sp.b_spill[l] != 0).any(axis=1)
                for sp in st.spills for l, g in enumerate(sp.group_ids)}
    buckets = []
    for b in st.buckets:
        band = b.b_dense.copy()
        for l, g in enumerate(b.group_ids):
            if int(g) in spilling:
                band[l][spilling[int(g)]] = 0
        buckets.append(b._replace(b_dense=band))
    return st._replace(buckets=tuple(buckets))


def with_gaps(hg):
    """``hg`` without the incidences of edges [128, 256) and vertices [256,
    384): a group of each stage with no live slot."""
    v = hg.ht_indices.astype(np.int64)
    e = np.repeat(np.arange(hg.num_edges), np.diff(hg.ht_indptr))
    keep = ~(((e >= 128) & (e < 256)) | ((v >= 256) & (v < 384)))
    return Hypergraph.from_coo(v[keep], e[keep], num_nodes=hg.num_nodes, num_edges=hg.num_edges)


@functools.lru_cache(maxsize=None)
def aligned_plan(case):
    """The host plans the band kernel is held at: a small community graph
    in each form and layout, and the shapes that go wrong."""
    if case == "dense":  # bands about half full: the max kernels' chunks cut by entries
        return planner.plan_aligned(sorted_community_graph(600, 400, 2, 150, 0.0, 5))
    if case == "gap":
        return planner.plan_aligned(with_gaps(sorted_community_graph(2000, 1600, 25, 5, 0.02, 3)))
    if case in ("spill_only", "uniform_spill_only"):
        plan = aligned_plan("bucketed" if case == "spill_only" else "uniform")
        return dataclasses.replace(plan, edge_stage=spill_only_rows(plan.edge_stage),
                                   vertex_stage=spill_only_rows(plan.vertex_stage))
    if case == "empty":
        return planner.plan_aligned(Hypergraph.from_coo([], [], num_nodes=300, num_edges=200))
    if case == "past_n":  # N = 300 rows, windows of 4 blocks: block 3 holds no row
        return planner.plan_aligned(sorted_community_graph(300, 200, 5, 4, 0.02, 1),
                                    form="uniform", window_blocks=4)
    if case == "width32":  # 4096-row windows
        return planner.plan_aligned(sorted_community_graph(6000, 3000, 24, 12, 0.02, 0),
                                    form="uniform", window_blocks=32)
    if case == "counts":
        return planner.plan_aligned(sorted_community_graph(2000, 1600, 25, 5, 0.02, 3, 0.05))
    hg = sorted_community_graph(2000, 1600, 25, 5, 0.02, 3)
    if case in ("split", "odd_spill", "wide", "wide200"):
        plan = planner.plan_aligned(hg, group_rows=200 if case == "wide200" else 128)
        relay = {"split": split_buckets, "odd_spill": functools.partial(widen_spills, extra=5),
                 "wide": functools.partial(widen_windows, gids=(0, 5, 6), extra=12),
                 "wide200": functools.partial(widen_windows, gids=(1, 4), extra=12)}[case]
        return dataclasses.replace(plan, edge_stage=relay(plan.edge_stage),
                                   vertex_stage=relay(plan.vertex_stage))
    kw = {"bucketed": {}, "uniform": {"form": "uniform"}, "group64": {"group_rows": 64},
          "block64": {"block_rows": 64}, "group200": {"group_rows": 200},
          "group24": {"group_rows": 24}, "block32": {"block_rows": 32},
          "block200": {"block_rows": 200}}[case]
    return planner.plan_aligned(hg, **kw)


ALIGNED_CASES = ("bucketed", "split", "uniform", "group64", "block64", "counts", "past_n",
                 "width32", "empty")
# the shapes the tensor-core band kernel cuts differently: groups taller than
# a CTA's 128 rows or not a multiple of its 16-row tiles, source blocks
# shorter than or not a multiple of its 64-row slabs, spill widths at odd
# byte offsets, groups so much wider than the rest that the kernel splits
# them over two CTAs (also with two CTAs of rows a group); width32: a window
# of 64 slabs, wider than the 4-slab ring
BAND_CASES = ALIGNED_CASES + ("group200", "group24", "block32", "block200", "odd_spill", "wide",
                              "wide200")


@pytest.mark.parametrize("case", BAND_CASES)
@pytest.mark.parametrize("f", [3, 5, 32, 48, 100])
def test_band_kernel_matches_plain(cuda, case, f):
    plan = dataclasses.replace(aligned_plan(case), form="pallas_auto")
    for stage in plan.device(cuda):
        x = torch.as_tensor(np.random.default_rng(f).normal(size=(stage.num_inputs, f))
                            .astype(np.float32), device=cuda)
        before = aligned_band.launches
        got = aligned_band.aligned_band(x, stage)
        again = aligned_band.aligned_band(x, stage)
        torch.cuda.synchronize()
        assert aligned_band.launches == before + 2  # one launch a stage apply
        want = aligned_band.aligned_band_plain(x, stage)
        assert got.shape == want.shape == (stage.num_segments, f)
        scale = float(want.abs().max()) if want.numel() else 0.0
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5 * scale)
        assert torch.equal(got, again), "two runs differ"


def test_band_kernel_reads_no_row_past_n(cuda):
    """x's rows are a view into a larger buffer full of NaN: rows past N and
    the spill zero row must never be read."""
    plan = dataclasses.replace(aligned_plan("past_n"), form="pallas_auto")
    for stage in plan.device(cuda):
        n, f = stage.num_inputs, 5
        buf = torch.full((n + 1000, f), float("nan"), device=cuda)
        buf[:n] = torch.as_tensor(np.random.default_rng(2).normal(size=(n, f))
                                  .astype(np.float32), device=cuda)
        got = aligned_band.aligned_band(buf[:n], stage)
        assert bool(torch.isfinite(got).all())
        want = aligned_band.aligned_band_plain(buf[:n].clone(), stage)
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5 * float(want.abs().max()))


def test_band_kernel_runs_on_two_streams_at_once(cuda):
    """A split group's halves meet through scratch and counters of their
    own call: launches over one table on two streams, queued without
    waiting for each other, each give the plain twin's result."""
    plan = dataclasses.replace(aligned_plan("wide"), form="pallas_auto")
    rng = np.random.default_rng(9)
    for stage in plan.device(cuda):
        assert stage.band.slots > 0
        xs = [torch.as_tensor(rng.normal(size=(stage.num_inputs, 32)).astype(np.float32),
                              device=cuda) for _ in range(2)]
        streams = [torch.cuda.Stream(cuda) for _ in range(2)]
        torch.cuda.synchronize()
        outs = ([], [])
        for _ in range(20):
            for s, x, got in zip(streams, xs, outs):
                with torch.cuda.stream(s):
                    got.append(aligned_band.aligned_band(x, stage))
        torch.cuda.synchronize()
        for x, got in zip(xs, outs):
            want = aligned_band.aligned_band_plain(x, stage)
            for g in got:
                torch.testing.assert_close(g, want, rtol=1e-5, atol=1e-5 * float(want.abs().max()))


@pytest.mark.parametrize("aggr", ["sum", "mean"])
def test_aligned_route_runs_the_kernel_forward_and_backward(cuda, aggr):
    """The route on the kernel form against the plain form on the card: the
    output and dx, with one launch per stage apply (2 forward, 2 backward)."""
    hg = sorted_community_graph(2000, 1600, 25, 5, 0.02, 3)
    plain = planner.plan_aligned(hg)
    kernel = dataclasses.replace(plain, form="pallas_auto")
    hgd = hg.device_data(cuda)
    rng = np.random.default_rng(4)
    x = torch.as_tensor(rng.normal(size=(hg.num_nodes, 16)).astype(np.float32), device=cuda)
    cot = torch.as_tensor(rng.normal(size=(hg.num_nodes, 16)).astype(np.float32), device=cuda)
    res = []
    for plan in (kernel, plain):
        xr = x.clone().requires_grad_(True)
        before = aligned_band.launches
        out = fused.hgnn_aggregate(hgd, xr, None, aggr, plan=plan, backend="aligned")
        (out * cot).sum().backward()
        torch.cuda.synchronize()
        res.append((out.detach(), xr.grad, aligned_band.launches - before))
    (out_k, dx_k, n_k), (out_p, dx_p, n_p) = res
    assert (n_k, n_p) == (4, 0)
    for got, want in ((out_k, out_p), (dx_k, dx_p)):
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5 * float(want.abs().max()))


def test_band_wrapper_rejects_what_the_kernel_does_not_take(cuda):
    kernel_stage, _ = dataclasses.replace(aligned_plan("bucketed"), form="pallas_auto").device(cuda)
    plain_stage, _ = aligned_plan("bucketed").device(cuda)
    n = kernel_stage.num_inputs
    x = torch.ones((n, 4), device=cuda)
    with pytest.raises(RuntimeError, match="autograd"):
        aligned_band.aligned_band(x.clone().requires_grad_(True), kernel_stage)
    with pytest.raises(TypeError):
        aligned_band.aligned_band(x.double(), kernel_stage)
    with pytest.raises(TypeError):
        aligned_band.aligned_band(x[:10], kernel_stage)
    with pytest.raises(ValueError, match="contiguous"):
        aligned_band.aligned_band(torch.ones((4, n), device=cuda).t(), kernel_stage)
    with pytest.raises(ValueError, match="kernel tables"):
        aligned_band.aligned_band(x, plain_stage)
    with pytest.raises(ValueError):
        aligned_band.aligned_band(x.cpu(), kernel_stage)


def _max_x(rows, f, seed, device):
    """Normal values, or integers in [-2, 2] (many ties) for even seeds."""
    rng = np.random.default_rng(seed)
    a = rng.integers(-2, 3, size=(rows, f)) if seed % 2 == 0 else rng.normal(size=(rows, f))
    return torch.as_tensor(a.astype(np.float32), device=device)


# the shapes the max kernels' live layout cuts differently: a group with no
# live slot, rows that reach sources only through spill slots, blocks of 200
# rows cut into chunks of 128 and 72 (a row's slots cross a chunk boundary),
# and bands so full that chunks are cut by their entries
MAX_CASES = ALIGNED_CASES + ("gap", "spill_only", "uniform_spill_only", "block200", "dense")
MAX_WIDTHS = (3, 4, 32, 48, 100)


def live_entries(table, live):
    """Every entry a LiveLayout lists, in its order: (segment, source, slot
    of the group, chunk, offset), int64 host arrays."""
    g_rows = table.group_rows
    c = live.chunks.cpu().numpy().astype(np.int64)
    gc = live.group_chunks.cpu().numpy().astype(np.int64)
    rp = live.row_ptr.cpu().numpy().astype(np.int64)[:len(c) * g_rows + 1]
    at = np.repeat(np.arange(len(c) * g_rows), np.diff(rp))  # (chunk, row) of each entry
    chunk, row = at // g_rows, at % g_rows
    group = np.repeat(np.arange(len(gc) - 1), np.diff(gc))[chunk]
    off = live.slots.cpu().numpy().astype(np.int64)[:rp[-1]]
    first, spill = c[chunk, 0], c[chunk, 2] == 1
    srcs = np.concatenate([table.src.cpu().numpy(), np.zeros(1, np.int32)])
    src = np.where(spill, srcs[np.where(spill, first + off, 0)], first + off)
    return group * g_rows + row, src, c[chunk, 3] + off, chunk, off


def _walk(table, live, step):
    """Call ``step(rows, sources)`` for the k-th entry of every row's list
    of each chunk, chunk by chunk, k ascending: the kernels' order."""
    seg, src, _, chunk, _ = live_entries(table, live)
    for i in np.unique(chunk):
        s, v = seg[chunk == i], src[chunk == i]
        k = np.arange(len(s)) - np.searchsorted(s, s)  # position in its row's list
        for at in range(int(k.max()) + 1):
            step(s[k == at], v[k == at])


def walk_argmax(x, table, live):
    """The argmax kernel's walk over ``live``, on the host: (val, arg)."""
    rows, f = table.num_groups * table.group_rows, x.shape[1]
    best = np.full((rows, f), np.float32(-3.0e38), np.float32)
    best_id = np.full((rows, f), 2**31 - 1, np.int64)

    def step(r, ids):
        xv = x[ids]
        win = (xv > best[r]) | ((xv == best[r]) & (ids[:, None] < best_id[r]))
        best[r] = np.where(win, xv, best[r])
        best_id[r] = np.where(win, ids[:, None], best_id[r])

    _walk(table, live, step)
    none = best_id == 2**31 - 1
    s = table.num_segments
    return (np.where(none, 0.0, best).astype(np.float32)[:s],
            np.where(none, -1, best_id).astype(np.int32)[:s])


def walk_argsum(g, arg, table, live):
    """The arg-sum kernel's walk over ``live``, on the host: each row's f32
    sum, from +0, in chunk and list order (slot order)."""
    out = np.zeros((table.num_groups * table.group_rows, g.shape[1]), np.float32)

    def step(r, e):
        out[r] = np.where(arg[e] == r[:, None], out[r] + g[e], out[r])

    _walk(table, live, step)
    return out[:table.num_segments]


@pytest.mark.parametrize("case", MAX_CASES)
@pytest.mark.parametrize("f,seed", [(3, 1), (4, 2), (32, 2), (32, 3), (48, 4), (100, 5)])
def test_argmax_kernel_is_bitwise_plain(cuda, case, f, seed):
    plan = dataclasses.replace(aligned_plan(case), form="pallas_auto")
    for stage in plan.device(cuda):
        x = _max_x(stage.num_inputs, f, seed, cuda)
        before = aligned_max.argmax_launches
        val, arg = aligned_max.aligned_masked_argmax(x, stage)
        val2, arg2 = aligned_max.aligned_masked_argmax(x, stage)
        torch.cuda.synchronize()
        assert aligned_max.argmax_launches == before + 2  # one launch a stage apply
        want_val, want_arg = aligned_max.aligned_max_plain(x, stage)
        assert val.shape == want_val.shape == (stage.num_segments, f)
        assert arg.dtype == torch.int32
        assert torch.equal(val, want_val), float((val - want_val).abs().max())
        assert torch.equal(arg, want_arg), int((arg != want_arg).sum())
        assert torch.equal(val, val2) and torch.equal(arg, arg2), "two runs differ"


@pytest.mark.parametrize("case", MAX_CASES)
@pytest.mark.parametrize("f", MAX_WIDTHS)
def test_argsum_kernel_matches_plain(cuda, case, f):
    """Over the vertex stage, with the arg table of the argmax kernel on the
    edge stage: within 1e-6 of the twin, and bitwise equal to the host walk
    over the live layout (every row summed in slot order, as the kernel
    over the flat tables summed it)."""
    e_st, v_st = dataclasses.replace(aligned_plan(case), form="pallas_auto").device(cuda)
    _, arg = aligned_max.aligned_masked_argmax(_max_x(e_st.num_inputs, f, 5, cuda), e_st)
    g = _max_x(v_st.num_inputs, f, 7, cuda)
    before = aligned_max.argsum_launches
    got = aligned_max.aligned_masked_argsum(g, arg, v_st)
    again = aligned_max.aligned_masked_argsum(g, arg, v_st)
    torch.cuda.synchronize()
    assert aligned_max.argsum_launches == before + 2
    want = aligned_max.aligned_argsum_plain(g, arg, v_st)
    assert got.shape == want.shape == (v_st.num_segments, f)
    scale = float(want.abs().max()) if want.numel() else 0.0
    torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6 * scale)
    assert torch.equal(got, again), "two runs differ"
    walked = walk_argsum(g.cpu().numpy(), arg.cpu().numpy(), v_st.band, v_st.band.live)
    assert torch.equal(got.cpu(), torch.as_tensor(walked))


def test_max_kernels_read_no_row_past_n(cuda):
    """x's (and g's and arg's) rows are a view into a larger buffer full of
    NaN (and of ids that would hit): rows past N and the spill zero row must
    never be read."""
    e_st, v_st = dataclasses.replace(aligned_plan("past_n"), form="pallas_auto").device(cuda)
    n, f = e_st.num_inputs, 5
    buf = torch.full((n + 1000, f), float("nan"), device=cuda)
    buf[:n] = _max_x(n, f, 3, cuda)
    val, arg = aligned_max.aligned_masked_argmax(buf[:n], e_st)
    assert bool(torch.isfinite(val).all())
    want_val, want_arg = aligned_max.aligned_max_plain(buf[:n].clone(), e_st)
    assert torch.equal(val, want_val) and torch.equal(arg, want_arg)
    m = v_st.num_inputs
    gbuf = torch.full((m + 1000, f), float("nan"), device=cuda)
    gbuf[:m] = _max_x(m, f, 5, cuda)
    abuf = torch.zeros((m + 1000, f), dtype=torch.int32, device=cuda)
    abuf[:m] = arg
    got = aligned_max.aligned_masked_argsum(gbuf[:m], abuf[:m], v_st)
    assert bool(torch.isfinite(got).all())
    want = aligned_max.aligned_argsum_plain(gbuf[:m].clone(), arg, v_st)
    torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6 * float(want.abs().max()))


def test_max_route_runs_the_kernels_forward_and_backward(cuda):
    """The aligned route with max on the kernel form against the plain form
    on the card: the output bitwise equal up to the band kernel's sums, dx
    (the CSR-routed backward) equal; one argmax and one band launch forward,
    one band launch backward."""
    hg = sorted_community_graph(2000, 1600, 25, 5, 0.02, 3)
    plain = planner.plan_aligned(hg)
    kernel = dataclasses.replace(plain, form="pallas_auto")
    hgd = hg.device_data(cuda)
    x = _max_x(hg.num_nodes, 16, 9, cuda)
    cot = _max_x(hg.num_nodes, 16, 11, cuda)
    res = []
    for plan in (kernel, plain):
        xr = x.clone().requires_grad_(True)
        before = (aligned_max.argmax_launches, aligned_band.launches)
        out = fused.hgnn_aggregate(hgd, xr, None, "max", plan=plan, backend="aligned")
        (out * cot).sum().backward()
        torch.cuda.synchronize()
        res.append((out.detach(), xr.grad, (aligned_max.argmax_launches - before[0],
                                            aligned_band.launches - before[1])))
    (out_k, dx_k, n_k), (out_p, dx_p, n_p) = res
    assert (n_k, n_p) == ((1, 2), (0, 0))
    for got, want in ((out_k, out_p), (dx_k, dx_p)):
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5 * float(want.abs().max()))


def test_segment_sum_sorted_is_deterministic_on_the_card(cuda):
    """The max backward's direct segment sum at SBM-60k's nnz and F = 32:
    two runs bitwise equal, and within 1e-5 of float64 sums on the host."""
    from hypergef_tpu_torch.ops.segments import segment_sum_sorted

    rng = np.random.default_rng(0)
    nnz, segs = 351737, 60000
    indptr = np.concatenate([[0], np.sort(rng.integers(0, nnz + 1, size=segs - 1)), [nnz]])
    vals = rng.normal(size=(nnz, 32)).astype(np.float32)
    v, ip = torch.as_tensor(vals, device=cuda), torch.as_tensor(indptr, device=cuda)
    got, again = segment_sum_sorted(v, ip), segment_sum_sorted(v, ip)
    assert torch.equal(got, again), "two runs differ"
    prefix = np.concatenate([np.zeros((1, 32)), np.cumsum(vals, axis=0, dtype=np.float64)])
    want = prefix[indptr[1:]] - prefix[indptr[:-1]]  # float64: exact enough here
    np.testing.assert_allclose(got.cpu().numpy(), want, rtol=1e-5, atol=1e-5)


def test_max_wrappers_reject_what_the_kernels_do_not_take(cuda):
    plan = dataclasses.replace(aligned_plan("uniform"), form="pallas_auto")
    e_st, v_st = plan.device(cuda)
    e_cpu, _ = plan.device("cpu")
    e_plain, v_plain = aligned_plan("uniform").device(cuda)
    x = torch.ones((e_st.num_inputs, 4), device=cuda)
    with pytest.raises(ValueError, match="table is on"):
        aligned_max.aligned_masked_argmax(x, e_cpu)
    with pytest.raises(TypeError):
        aligned_max.aligned_masked_argmax(x.double(), e_st)
    with pytest.raises(TypeError):
        aligned_max.aligned_masked_argmax(x[:10], e_st)
    with pytest.raises(ValueError, match="contiguous"):
        aligned_max.aligned_masked_argmax(torch.ones((4, e_st.num_inputs), device=cuda).t(), e_st)
    with pytest.raises(ValueError, match="kernel tables"):
        aligned_max.aligned_masked_argmax(x, e_plain)
    _, arg = aligned_max.aligned_masked_argmax(x, e_st)
    g = torch.ones((v_st.num_inputs, 4), device=cuda)
    with pytest.raises(TypeError):
        aligned_max.aligned_masked_argsum(g, arg.long(), v_st)
    with pytest.raises(TypeError):
        aligned_max.aligned_masked_argsum(g.double(), arg, v_st)
    with pytest.raises(ValueError, match="kernel tables"):
        aligned_max.aligned_masked_argsum(g, arg, v_plain)
    # a kernel-form stage whose table lost its live layout: no fallback
    for fn, st, args in ((aligned_max.aligned_masked_argmax, e_st, (x,)),
                         (aligned_max.aligned_masked_argsum, v_st, (g, arg))):
        bare = dataclasses.replace(st, band=dataclasses.replace(st.band, live=None))
        with pytest.raises(ValueError, match="BandTable.build"):
            fn(*args, bare)


def _bit_pack(m, k, density, seed, device):
    """The device pack (words and the kernel's layout) of a random 0/1
    matrix [m, k] with every third row empty and row 1 full, padded to 256
    rows as BitIncidence pads them; and the matrix."""
    rng = np.random.default_rng(seed)
    a = (rng.random((m, k)) < density).astype(np.float32)
    a[::3] = 0
    if m > 1:
        a[1] = 1
    return _pack_of(a, device), a


def _pack_of(a, device):
    import scipy.sparse as sp

    m, k = a.shape
    csr = sp.csr_matrix(a)
    words = bitstream.pack_bits_csr(csr.indptr, csr.indices, m, k)
    return bitstream.BitPack(np.pad(words, ((0, -m % 256), (0, 0))), m, k).to(device)


def _edge_matrix(case):
    """0/1 matrices of the layout's edge cases (as
    tests/test_torch_port_bitstream.py builds them)."""
    rng = np.random.default_rng(7)
    if case == "all_zero":
        return np.zeros((40, 5000), np.float32)
    a = np.zeros((9, 3 * 4096 + 50), np.float32)
    if case == "full_word":
        a[2, 7::128] = 1  # word 7 of row 2: its 32 bits
        a[5, 7:4096:128] = 1
    elif case == "every_word":
        a[1, :] = 1
        a[4, ::130] = 1
    elif case == "around_the_share":  # rows of 0 .. the largest share + 1 bits
        a = np.zeros((110, 700), np.float32)
        for r in range(110):
            a[r, rng.choice(700, size=r % (max(bitstream.RUN_SHARES) + 2), replace=False)] = 1
    return a


def _check_bitmm(pack, a, f, device):
    x = torch.as_tensor(np.random.default_rng(f).normal(size=(pack.k, f)).astype(np.float32),
                        device=device)
    before = bitstream.launches
    got = bitstream.bitmm(pack, x)
    again = bitstream.bitmm(pack, x)
    torch.cuda.synchronize()
    assert bitstream.launches == before + 2
    want = bitstream.bitmm_plain(pack.words, x, pack.m, pack.k)
    assert got.shape == want.shape == (pack.m, f)
    scale = max(float(want.abs().max()), 1e-30)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5 * scale)
    assert torch.equal(got, again), "two runs differ"
    assert not got[torch.as_tensor(a.sum(1) == 0, device=device)].any()  # empty rows
    exact = torch.as_tensor(a, device=device).double() @ bitstream.bf16_round(x).double()
    torch.testing.assert_close(got.double(), exact, rtol=1e-5,
                               atol=1e-5 * max(float(exact.abs().max()), 1e-30))


# m not a multiple of the kernel's 8 runs a CTA (1, 133, 257, 300, 4100);
# k = 140000: rows of 35 K tiles, so a row's words span many windows of 32
# pairs; row 1 full: every word of every tile set, its bits staged 64 at a
# time
@pytest.mark.parametrize("m,k,density", [(1, 1, 1.0), (300, 5000, 0.01), (257, 4096, 0.05),
                                         (1000, 9000, 0.002), (4100, 700, 0.03),
                                         (133, 140000, 0.0005)])
@pytest.mark.parametrize("f", [1, 3, 4, 32, 100, 300])
def test_bitmm_kernel_matches_plain(cuda, m, k, density, f):
    pack, a = _bit_pack(m, k, density, seed=m + k + f, device=cuda)
    _check_bitmm(pack, a, f, cuda)


@pytest.mark.parametrize("case", ["all_zero", "full_word", "every_word", "around_the_share"])
@pytest.mark.parametrize("f", [1, 3, 4, 32, 100, 300])
@pytest.mark.parametrize("largest_share", [False, True])
def test_bitmm_kernel_matches_plain_on_the_layouts_edge_cases(cuda, case, f, largest_share):
    """The card's own share (the smallest, at these sizes) and the largest,
    the one stream100k's packs take."""
    a = _edge_matrix(case)
    pack = _pack_of(a, cuda)
    if largest_share:
        lay = bitstream.bit_layout(pack.words.cpu().numpy(), pack.m, pack.k, sms=0)
        assert lay.share == max(bitstream.RUN_SHARES)
        pack = dataclasses.replace(pack, layout=lay.to(cuda))
    _check_bitmm(pack, a, f, cuda)


def test_bitmm_kernel_runs_on_two_streams_at_once(cuda):
    """Both packs of a graph queued on two streams without waiting for each
    other: each gives its twin's result."""
    from hypergef_tpu_torch.data.synthetic import random_hypergraph

    hg = random_hypergraph(5000, 4500, avg_edge_size=6.0, seed=3)
    packs = bitstream.BitIncidence.from_hypergraph(hg).device(cuda)
    rng = np.random.default_rng(5)
    xs = [torch.as_tensor(rng.normal(size=(p.k, 32)).astype(np.float32), device=cuda)
          for p in packs]
    streams = [torch.cuda.Stream(cuda) for _ in range(2)]
    torch.cuda.synchronize()
    outs = ([], [])
    for _ in range(20):
        for st, p, x, got in zip(streams, packs, xs, outs):
            with torch.cuda.stream(st):
                got.append(bitstream.bitmm(p, x))
    torch.cuda.synchronize()
    for p, x, got in zip(packs, xs, outs):
        want = bitstream.bitmm_plain(p.words, x, p.m, p.k)
        for o in got:
            assert torch.equal(o, got[0])
        torch.testing.assert_close(got[0], want, rtol=1e-5, atol=1e-5 * float(want.abs().max()))


def test_bit_matvec_gradient_matches_the_twin(cuda):
    from hypergef_tpu_torch.data.synthetic import random_hypergraph

    hg = random_hypergraph(5000, 4500, avg_edge_size=6.0, seed=2)
    h, ht = bitstream.BitIncidence.from_hypergraph(hg).device(cuda)
    rng = np.random.default_rng(4)
    x = torch.as_tensor(rng.normal(size=(hg.num_nodes, 20)).astype(np.float32), device=cuda)
    g = torch.as_tensor(rng.normal(size=(hg.num_edges, 20)).astype(np.float32), device=cuda)
    xr = x.clone().requires_grad_(True)
    before = bitstream.launches
    out = bitstream.bit_matvec(xr, ht, h)
    out.backward(g)
    torch.cuda.synchronize()
    assert bitstream.launches == before + 2  # one forward, one backward
    for got, want in ((out.detach(), bitstream.bitmm_plain(ht.words, x, ht.m, ht.k)),
                      (xr.grad, bitstream.bitmm_plain(h.words, g, h.m, h.k))):
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5 * float(want.abs().max()))


def test_bitmm_wrapper_rejects_what_the_kernel_does_not_take(cuda):
    pack, _ = _bit_pack(300, 5000, 0.01, seed=1, device=cuda)
    x = torch.ones((5000, 4), device=cuda)
    with pytest.raises(ValueError, match="on the CPU"):
        bitstream.bitmm(pack, x.cpu())
    with pytest.raises(ValueError, match="pack is on"):
        bitstream.bitmm(dataclasses.replace(pack, words=pack.words.cpu()), x)
    with pytest.raises(TypeError):
        bitstream.bitmm(pack, x.double())
    with pytest.raises(TypeError):
        bitstream.bitmm(pack, x[:10])
    with pytest.raises(TypeError):
        bitstream.bitmm(dataclasses.replace(pack, words=pack.words.long()), x)
    with pytest.raises(ValueError, match="contiguous"):
        bitstream.bitmm(pack, torch.ones((4, 5000), device=cuda).t())
    with pytest.raises(ValueError, match="contiguous"):
        bitstream.bitmm(dataclasses.replace(pack, words=pack.words[:, :128], k=4096), x[:4096])
    with pytest.raises(ValueError, match="unsupported pack"):
        bitstream.bitmm(dataclasses.replace(pack, k=9000), torch.ones((9000, 4), device=cuda))
    with pytest.raises(RuntimeError, match="bit_matvec"):
        bitstream.bitmm(pack, x.clone().requires_grad_(True))
    # a device pack without the kernel's layout is refused, never summed by the twin
    with pytest.raises(ValueError, match="BitIncidence.device"):
        bitstream.bitmm(dataclasses.replace(pack, layout=None), x)


def test_chip_smoke_imports_and_reads_the_card():
    """Imported everywhere, so its helpers are import-checked on the CPU
    too; the card-reading part skips without a card."""
    spec = importlib.util.spec_from_file_location("chip_smoke", REPO / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    assert callable(mod.main) and set(mod.GRAPHS) == {"20news", "pubmed_real"}
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    assert mod.card_line().split(",")[0].strip() == torch.cuda.get_device_name(0)


# ---- the segment-sum kernel (cumsum route), precomp, the ladder ----------


def _segment_csr(s, n, density, seed, identity=False):
    """A CSR of ``s`` segments over rows of an [n, F] input, with every
    fourth segment empty and one long one."""
    rng = np.random.default_rng(seed)
    sizes = rng.poisson(density, size=s)
    sizes[::4] = 0
    if s > 2:
        sizes[1] = 700
    indptr = np.concatenate([[0], np.cumsum(sizes)])
    if identity:
        indptr = np.minimum(indptr, n)
        return indptr, None
    return indptr, rng.integers(0, n, size=int(indptr[-1])).astype(np.int32)


@pytest.mark.parametrize("s,n,density", [(1, 5, 3.0), (300, 500, 6.0), (4100, 2000, 2.5)])
@pytest.mark.parametrize("f", [1, 3, 4, 32, 33, 100])
@pytest.mark.parametrize("identity", [False, True])
def test_segment_sum_kernel_matches_plain(cuda, s, n, density, f, identity):
    """rtol 1e-6, atol 1e-6·max|plain|: the same f32 terms, summed in CSR
    order by the kernel and by segment_reduce's own order."""
    from hypergef_tpu_torch.ops import segment_sum

    indptr, gather = _segment_csr(s, n if not identity else 10**6, density, s + f, identity)
    rows = max(n, int(indptr[-1])) if identity else n
    table = segment_sum.SegmentTable.build(indptr, gather, rows, cuda)
    x = torch.as_tensor(np.random.default_rng(f).normal(size=(rows, f)).astype(np.float32),
                        device=cuda)
    before = segment_sum.launches
    got = segment_sum.gather_segment_sum(x, table)
    again = segment_sum.gather_segment_sum(x, table)
    torch.cuda.synchronize()
    assert segment_sum.launches == before + 2
    want = segment_sum.gather_segment_sum_plain(x, table)
    assert got.shape == want.shape == (s, f)
    torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6 * float(want.abs().max()))
    assert torch.equal(got, again), "two runs differ"
    empty = torch.as_tensor(np.diff(indptr) == 0, device=cuda)
    assert not got[empty].any()


def _long_csr(seed):
    """Segments over 7000 rows: every third one empty, a 12,000-row one."""
    rng = np.random.default_rng(seed)
    sizes = rng.poisson(3.0, size=3000)
    sizes[::3] = 0
    sizes[5] = 12_000
    indptr = np.concatenate([[0], np.cumsum(sizes)])
    return indptr, rng.integers(0, 7000, size=int(indptr[-1])).astype(np.int32)


@pytest.mark.parametrize("f", [1, 3, 4, 6, 32, 100, 1425])
@pytest.mark.parametrize("aligned", [True, False])
def test_segment_sum_kernel_on_a_long_segment_and_unaligned_rows(cuda, f, aligned):
    """The warp runs' two modes (several segments a warp's lane groups; one
    long segment a column a lane), on rows read 16 (or at F = 6, 8) bytes a
    lane and, from an x 4 bytes past a 16-byte boundary, one float a lane:
    rtol 1e-6 and atol 1e-6·max|plain|, repeats bitwise equal, one launch a
    call."""
    from hypergef_tpu_torch.ops import segment_sum

    indptr, gather = _long_csr(f)
    table = segment_sum.SegmentTable.build(indptr, gather, 7000, cuda)
    vals = torch.as_tensor(np.random.default_rng(f).normal(size=(7000, f)).astype(np.float32),
                           device=cuda)
    buf = torch.empty(7000 * f + 1, device=cuda)
    x = buf[1:].view(7000, f) if not aligned else buf[:-1].view(7000, f)
    x.copy_(vals)
    assert (x.data_ptr() % 16 == 0) == aligned
    before = segment_sum.launches
    got = segment_sum.gather_segment_sum(x, table)
    again = segment_sum.gather_segment_sum(x, table)
    torch.cuda.synchronize()
    assert segment_sum.launches == before + 2
    want = segment_sum.gather_segment_sum_plain(vals, table)
    torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6 * float(want.abs().max()))
    assert torch.equal(got, again), "two runs differ"
    assert not got[torch.as_tensor(np.diff(indptr) == 0, device=cuda)].any()


def _tree_record(cuda, seed, f):
    """(g, arg int64, e2v) of a max V→E through the tree on a random graph,
    tie-heavy (integers in [-2, 2]) so that ids of several members tie."""
    from hypergef_tpu_torch.data.synthetic import random_hypergraph
    from hypergef_tpu_torch.ops import maxops

    hg = random_hypergraph(3000, 1700, avg_edge_size=6.0, seed=seed)
    stage = planner.plan_tree(hg).device(cuda)[0]
    rng = np.random.default_rng(seed)
    x = torch.as_tensor(rng.integers(-2, 3, size=(hg.num_nodes, f)).astype(np.float32),
                        device=cuda)
    g = torch.as_tensor(rng.normal(size=(hg.num_edges, f)).astype(np.float32), device=cuda)
    _, arg = maxops.tree_max_with_arg(x, stage)
    return g, arg, hg.device_data(cuda).e2v


@pytest.mark.parametrize("ids", ["tree", "int32"])
@pytest.mark.parametrize("f", [32, 6, 3])
def test_record_routed_sum_matches_plain(cuda, ids, f):
    """The masked kernel on the tree's int64 record table and on its int32
    copy (the aligned argmax's type): rtol 1e-6, atol 1e-6·max|plain|,
    repeats bitwise equal, one record launch a call and no plain-sum launch."""
    from hypergef_tpu_torch.ops import segment_sum

    g, arg, e2v = _tree_record(cuda, 7 + f, f)
    assert arg.dtype == torch.int64
    if ids == "int32":
        arg = arg.to(torch.int32)
    before = (segment_sum.launches, segment_sum.record_launches)
    got = segment_sum.record_routed_dx(g, arg, e2v)
    again = segment_sum.record_routed_dx(g, arg, e2v)
    torch.cuda.synchronize()
    assert (segment_sum.launches, segment_sum.record_launches) == (before[0], before[1] + 2)
    want = segment_sum.record_routed_dx_plain(g, arg, e2v)
    assert bool((want != 0).any())
    torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6 * float(want.abs().max()))
    assert torch.equal(got, again), "two runs differ"


def test_segment_sum_kernels_run_on_two_streams_at_once(cuda):
    """The plain and the masked sum over one table, queued on two streams
    without waiting for each other: each gives its plain twin's result."""
    from hypergef_tpu_torch.ops import segment_sum

    g, arg, e2v = _tree_record(cuda, 3, 32)
    streams = [torch.cuda.Stream(cuda) for _ in range(2)]
    calls = [lambda: segment_sum.gather_segment_sum(g, e2v),
             lambda: segment_sum.record_routed_dx(g, arg, e2v)]
    torch.cuda.synchronize()
    outs = ([], [])
    for _ in range(20):
        for st, call, got in zip(streams, calls, outs):
            with torch.cuda.stream(st):
                got.append(call())
    torch.cuda.synchronize()
    wants = (segment_sum.gather_segment_sum_plain(g, e2v),
             segment_sum.record_routed_dx_plain(g, arg, e2v))
    for got, want in zip(outs, wants):
        for o in got:
            torch.testing.assert_close(o, want, rtol=1e-6, atol=1e-6 * float(want.abs().max()))


def test_record_routed_sum_rejects_what_the_kernel_does_not_take(cuda):
    from hypergef_tpu_torch.ops import segment_sum

    g, arg, e2v = _tree_record(cuda, 5, 4)
    with pytest.raises(TypeError, match="int32 or int64"):
        segment_sum.record_routed_dx(g, arg.float(), e2v)
    with pytest.raises(TypeError, match="int32 or int64"):
        segment_sum.record_routed_dx(g, arg[:, :2].contiguous(), e2v)
    with pytest.raises(ValueError, match="contiguous"):
        segment_sum.record_routed_dx(g, arg.t().contiguous().t(), e2v)
    with pytest.raises(TypeError, match="f32"):
        segment_sum.record_routed_dx(g.double(), arg, e2v)


def test_incidence_gather_sum_backward_is_the_transposed_csr(cuda):
    from hypergef_tpu_torch.data.synthetic import random_hypergraph
    from hypergef_tpu_torch.ops import segment_sum
    from hypergef_tpu_torch.ops.segments import incidence_gather_sum

    hg = random_hypergraph(3000, 1700, avg_edge_size=4.5, seed=3)
    hgd = hg.device_data(cuda)
    rng = np.random.default_rng(5)
    x = torch.as_tensor(rng.normal(size=(hg.num_nodes, 32)).astype(np.float32), device=cuda)
    g = torch.as_tensor(rng.normal(size=(hg.num_edges, 32)).astype(np.float32), device=cuda)
    xr = x.clone().requires_grad_(True)
    before = segment_sum.launches
    y = incidence_gather_sum(xr, hgd.v2e, hgd.e2v)
    y.backward(g)
    torch.cuda.synchronize()
    assert segment_sum.launches == before + 2  # one forward, one backward
    for got, want in ((y.detach(), segment_sum.gather_segment_sum_plain(x, hgd.v2e)),
                      (xr.grad, segment_sum.gather_segment_sum_plain(g, hgd.e2v))):
        torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6 * float(want.abs().max()))


@pytest.mark.parametrize("aggr", ["sum", "mean", "max"])
def test_cumsum_route_runs_the_kernel_forward_and_backward(cuda, aggr):
    """Sum and mean launch the kernel twice forward and twice backward;
    max takes V→E from the tree and launches it once each way."""
    from hypergef_tpu_torch.data.synthetic import random_hypergraph
    from hypergef_tpu_torch.ops import segment_sum

    hg = random_hypergraph(2000, 1500, avg_edge_size=4.0, seed=4)
    plan = planner.AggregationPlan(tree=planner.plan_tree(hg)) if aggr == "max" else None
    rng = np.random.default_rng(6)
    x = rng.normal(size=(hg.num_nodes, 16)).astype(np.float32)
    outs, grads = [], []
    for dev in (cuda, torch.device("cpu")):
        xt = torch.as_tensor(x, device=dev).requires_grad_(True)
        before = segment_sum.launches
        out = fused.hgnn_aggregate(hg.device_data(dev), xt, None, aggr, plan=plan,
                                   backend="cumsum")
        (out ** 2).sum().backward()
        if dev.type == "cuda":
            torch.cuda.synchronize()
            assert segment_sum.launches - before == (2 if aggr == "max" else 4)
        outs.append(out.detach().cpu())
        grads.append(xt.grad.cpu())
    torch.testing.assert_close(outs[0], outs[1], rtol=1e-5, atol=1e-5 * float(outs[1].abs().max()))
    torch.testing.assert_close(grads[0], grads[1], rtol=1e-5,
                               atol=1e-5 * float(grads[1].abs().max()))


def test_segment_sum_wrapper_rejects_what_the_kernel_does_not_take(cuda):
    from hypergef_tpu_torch.ops import segment_sum

    indptr, gather = _segment_csr(50, 80, 3.0, 1)
    table = segment_sum.SegmentTable.build(indptr, gather, 80, cuda)
    cpu_table = segment_sum.SegmentTable.build(indptr, gather, 80, "cpu")
    x = torch.ones((80, 4), device=cuda)
    with pytest.raises(ValueError, match="table is on"):
        segment_sum.gather_segment_sum(x, cpu_table)
    with pytest.raises(TypeError):
        segment_sum.gather_segment_sum(x.double(), table)
    with pytest.raises(TypeError):
        segment_sum.gather_segment_sum(x[:10], table)
    with pytest.raises(ValueError, match="contiguous"):
        segment_sum.gather_segment_sum(torch.ones((4, 80), device=cuda).t(), table)
    with pytest.raises(RuntimeError, match="incidence_gather_sum"):
        segment_sum.gather_segment_sum(x.requires_grad_(True), table)
    with pytest.raises(ValueError, match=r"\[0, 80\)"):
        segment_sum.SegmentTable.build(indptr, gather + 80, 80, cuda)


def test_precomp_product_on_the_card_is_unrounded_f32(cuda):
    """A·bf16(x) with an f32 result: within 1e-5 of the float64 product of
    the same bf16 values (not rounded to bf16), and its gradient within the
    same of bf16(Aᵀ·bf16(g))."""
    from hypergef_tpu_torch.data.synthetic import random_hypergraph
    from hypergef_tpu_torch.ops.fused_dense import bf16_round

    hg = random_hypergraph(2708, 2708, avg_edge_size=4.0, seed=0)
    pre = planner.DensePrecomp.from_hypergraph(hg, cuda)
    rng = np.random.default_rng(7)
    x = torch.as_tensor(rng.normal(size=(hg.num_nodes, 32)).astype(np.float32), device=cuda)
    g = torch.as_tensor(rng.normal(size=(hg.num_nodes, 32)).astype(np.float32), device=cuda)
    xr = x.clone().requires_grad_(True)
    y = fused.precomp_matvec(pre.a, xr)
    y.backward(g)
    a = pre.a.double()
    want = a @ bf16_round(x).double()
    assert y.dtype == torch.float32
    torch.testing.assert_close(y.double(), want, rtol=1e-5, atol=1e-5 * float(want.abs().max()))
    assert not torch.equal(y, bf16_round(y))  # not rounded to bf16
    want_dx = bf16_round((a.t() @ bf16_round(g).double()).float())
    torch.testing.assert_close(xr.grad, want_dx, rtol=1e-2, atol=1e-2 * float(want_dx.abs().max()))


def test_plan_aggregation_takes_the_aligned_kernel_form_on_the_card(cuda):
    """Past the dense and precomp gates (closed here: the graph is small) a
    community-sorted graph takes ``aligned``, in the kernel form on the card."""
    hg, _ = community_reorder(community_hypergraph(2000, 1600, 25, 5, 0.02, 3))
    gates = dict(dense_threshold=0, with_precomp=False)
    plan = planner.plan_aggregation(hg, cuda, **gates)
    assert plan.preferred_backend == "aligned" and plan.aligned.form == "pallas_auto"
    assert plan.tree.form == "xla"
    assert planner.plan_aggregation(hg, "cpu", **gates).aligned.form == "xla"
    before = aligned_band.launches
    x = torch.ones((hg.num_nodes, 8), device=cuda)
    fused.hgnn_aggregate(hg.device_data(cuda), x, plan=plan, backend="auto")
    torch.cuda.synchronize()
    assert aligned_band.launches == before + 2


# ---- the probe kernels ----------------------------------------------------


@pytest.mark.parametrize("f", [1, 4, 32, 64, 128, 132])
@pytest.mark.parametrize("n_buf", [0, 4, 8, 16])
def test_row_gather_kernel_is_bitwise_plain(cuda, f, n_buf):
    from hypergef_tpu_torch import probes

    if n_buf and f % 4:
        pytest.skip("the ring takes F % 4 == 0")
    rng = np.random.default_rng(f + n_buf)
    x = torch.as_tensor(rng.normal(size=(3000, f)).astype(np.float32), device=cuda)
    idx = torch.as_tensor(rng.integers(0, 3000, size=5001).astype(np.int32), device=cuda)
    before = probes.row_gather_launches
    got = probes.row_gather(x, idx, n_buf)
    torch.cuda.synchronize()
    assert probes.row_gather_launches == before + 1
    assert torch.equal(got, probes.row_gather_plain(x, idx))


@pytest.mark.parametrize("ngs,f", [(2, 3), (8, 32), (8, 128), (5, 33)])
def test_chunk_masked_sum_kernels_are_bitwise_plain(cuda, ngs, f):
    from hypergef_tpu_torch import probes

    rng = np.random.default_rng(ngs * f)
    c, n = 1234, 900
    g = torch.as_tensor(rng.normal(size=(c, ngs, f)).astype(np.float32), device=cuda)
    mask = torch.as_tensor((rng.random((c, ngs)) > 0.2).astype(np.float32), device=cuda)
    before = probes.chunk_sum_launches
    assert torch.equal(probes.chunk_masked_sum(g, mask), probes.chunk_masked_sum_plain(g, mask))
    if f % 4 == 0:
        x = torch.as_tensor(rng.normal(size=(n, f)).astype(np.float32), device=cuda)
        gidx = torch.as_tensor(rng.integers(0, n, size=(c, ngs)).astype(np.int32), device=cuda)
        want = ell_gather.ell_gather_sum_plain(x, gidx.long(), mask)
        for nb in probes.RING_DEPTHS:
            assert torch.equal(probes.chunk_masked_sum_ring(x, gidx, mask, nb), want)
    torch.cuda.synchronize()
    assert probes.chunk_sum_launches == before + 1 + (3 if f % 4 == 0 else 0)


@pytest.mark.parametrize("numel", [1, 7, 4096, 1_000_003])
def test_scaled_copy_kernel_is_bitwise_plain(cuda, numel):
    from hypergef_tpu_torch import probes

    x = torch.as_tensor(np.random.default_rng(numel).normal(size=numel).astype(np.float32),
                        device=cuda)
    assert torch.equal(probes.scaled_copy(x, 2.0), x * 2.0)


def test_probes_hold_against_their_oracles_on_the_card(cuda):
    """Every probe of scripts/ at the scripts' shapes (probe_r2_gather's tiny
    and pubmed scales), each row against the script's oracle."""
    from hypergef_tpu_torch import probes

    for name, fn in probes.PROBES.items():
        kw = ({"scales": {k: probes.R2_SCALES[k] for k in ("tiny", "pubmed")}}
              if name == "probe_r2_gather" else {})
        rows = fn(cuda, **kw)
        bad = [(r["case"], r["max_abs_err"]) for r in rows if not r["ok"]]
        assert not bad, f"{name}: {bad}"
        assert all(r["launches"] == 1 for r in rows), name
