"""The segment-sum kernel's host side and the record-routed sum, on the CPU.

* The warp runs (``segment_sum.warp_runs``): every segment lies in exactly
  one run, the runs cover [0, S) in order, each run's first entry is its
  first segment's, and a run costs (nnz + segments) at most one share plus
  its largest segment; a run of several segments stays within the
  kernel's 64 entries and 32 segments.
* The kernel's work split, emulated in NumPy over those runs (a long
  segment a column a lane; otherwise the segments dealt to the lane groups
  in turn): every entry summed exactly once, every segment written once,
  the sums (each in CSR order) within rtol 1e-6 of the plain twin.
* The record-routed sum's plain twin (``record_routed_dx`` on CPU
  tensors), with the e2v table and int32 or int64 ids, against JAX's
  ``_v2e_max_bwd`` through ``jax.vjp`` of ``v2e_max_tree``, on tie-heavy
  inputs (integers in [-2, 2]): rtol 1e-6 (the same few f32 terms; JAX
  sums by prefix differences, exact for these integers).
* ``plan_aggregation``'s default device is the card: it raises without
  one, and ``"cpu"`` plans on the CPU.
"""

import functools
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import hypergef_tpu.data.synthetic as jsyn
from hypergef_tpu.ops import maxops as jmaxops
from hypergef_tpu.sparse import planner as jplanner

import hypergef_tpu_torch.data.synthetic as tsyn
from hypergef_tpu_torch.ops import _build, maxops, segment_sum
from hypergef_tpu_torch.sparse import planner

SHARE = segment_sum.RUN_SHARE
# csrc/segment_sum.cu: kRows (rows in flight a lane, above which a lone
# segment is summed a column a lane), kMaxSegs, kMaxEntries
UNROLL, MAX_SEGS, MAX_ENTRIES = 4, 32, 64


def _sizes(case):
    rng = np.random.default_rng(len(case))
    if case == "random_with_empty":
        sizes = rng.poisson(3.0, size=500)
        sizes[::3] = 0
    elif case == "one_holds_most":
        sizes = rng.poisson(2.0, size=300)
        sizes[137] = 20_000
    elif case == "one_segment":
        sizes = np.array([57])
    elif case == "fewer_than_warps":
        sizes = np.array([2, 0, 5])
    elif case == "all_empty":
        sizes = np.zeros(40, dtype=np.int64)
    elif case == "at_the_share":  # lengths around the long-segment cut
        sizes = np.tile([SHARE - 2, SHARE - 1, SHARE, SHARE + 1, 1, 0], 30)
    else:  # power law: hubs among short segments
        sizes = np.minimum(rng.zipf(1.8, size=2000), 5000)
    return sizes.astype(np.int64)


CASES = ["random_with_empty", "one_holds_most", "one_segment", "fewer_than_warps", "all_empty",
         "at_the_share", "power_law"]


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("share", [16, SHARE])
def test_warp_runs_cover_whole_segments_in_order(case, share):
    sizes = _sizes(case)
    indptr = np.concatenate([[0], np.cumsum(sizes)])
    runs = segment_sum.warp_runs(indptr, share)
    s = sizes.size
    assert runs.dtype == np.int32 and runs.ndim == 2 and runs.shape[1] == 2
    first, entry = runs[:, 0].astype(np.int64), runs[:, 1].astype(np.int64)
    assert first[0] == 0 and first[-1] == s and (np.diff(first) > 0).all()
    np.testing.assert_array_equal(entry, indptr[first])
    owner = np.repeat(np.arange(len(first) - 1), np.diff(first))
    assert owner.size == s  # every segment in exactly one run, in order
    for lo, hi in zip(first[:-1], first[1:]):
        seg = sizes[lo:hi]
        cost = int(seg.sum()) + seg.size
        assert cost <= share + int(seg.max())
        if seg.size > 1:
            assert int(seg.sum()) <= MAX_ENTRIES and seg.size <= MAX_SEGS
        else:
            assert hi - lo == 1
    long = np.flatnonzero(sizes + 1 > share)
    np.testing.assert_array_equal(np.diff(first)[np.searchsorted(first, long, "right") - 1], 1)


def _emulate(x, rows, indptr, runs, lanes, arg=None):
    """The kernel's work split over its runs, in NumPy f32: a run of one
    segment of more than UNROLL entries is summed a column a lane; in any
    other run the segments are dealt to the 32 // ``lanes`` lane groups in
    turn. Every sum runs in CSR order from 0. Also returns how often each
    entry was summed and each segment written."""
    s, f = indptr.size - 1, x.shape[1]
    out = np.zeros((s, f), dtype=np.float32)
    seen = np.zeros(int(indptr[-1]), dtype=np.int64)
    written = np.zeros(s, dtype=np.int64)

    def segment_sum(seg):
        acc = np.zeros(f, dtype=np.float32)
        for k in range(indptr[seg], indptr[seg + 1]):
            seen[k] += 1
            v = x[rows[k]]
            acc = acc + (v if arg is None else np.where(arg[rows[k]] == seg, v, np.float32(0)))
        out[seg] = acc
        written[seg] += 1

    groups = 32 // lanes
    for (s0, k0), (s1, k1) in zip(runs[:-1], runs[1:]):
        nseg, nk = s1 - s0, k1 - k0
        if nseg == 1 and nk > UNROLL:
            segment_sum(s0)
            continue
        assert nseg <= MAX_SEGS and nk <= MAX_ENTRIES
        for g in range(groups):
            for i in range(g, nseg, groups):
                segment_sum(s0 + i)
    return out, seen, written


@pytest.mark.parametrize("case", ["random_with_empty", "one_holds_most", "at_the_share",
                                  "fewer_than_warps"])
@pytest.mark.parametrize("lanes", [1, 8, 32])
@pytest.mark.parametrize("masked", [False, True])
def test_kernel_order_sums_every_entry_once(case, lanes, masked):
    sizes = _sizes(case)
    if case == "one_holds_most":
        sizes[137] = 700  # keeps the emulation short
    indptr = np.concatenate([[0], np.cumsum(sizes)])
    rng = np.random.default_rng(lanes)
    n, f = 90, 3
    rows = rng.integers(0, n, size=int(indptr[-1]))
    x = rng.normal(size=(n, f)).astype(np.float32)
    arg = rng.integers(0, sizes.size, size=(n, f)) if masked else None
    got, seen, written = _emulate(x, rows, indptr, segment_sum.warp_runs(indptr), lanes, arg)
    assert (seen == 1).all() and (written == 1).all()
    table = segment_sum.SegmentTable.build(indptr, rows, n, "cpu")
    if masked:
        want = segment_sum.record_routed_dx_plain(torch.as_tensor(x), torch.as_tensor(arg), table)
    else:
        want = segment_sum.gather_segment_sum_plain(torch.as_tensor(x), table)
    np.testing.assert_allclose(got, want.numpy(), rtol=1e-6,
                               atol=1e-6 * float(want.abs().max()))


# (n, e, avg_edge_size, seed): a random graph, and one with empty edges and
# vertices of no edge
GRAPHS = {"random": (300, 200, 5.0, 2), "sparse": (200, 260, 1.5, 1)}


@functools.lru_cache(maxsize=None)
def _graphs(name):
    n, e, avg, seed = GRAPHS[name]
    return (jsyn.random_hypergraph(n, e, avg_edge_size=avg, seed=seed),
            tsyn.random_hypergraph(n, e, avg_edge_size=avg, seed=seed))


@pytest.mark.parametrize("graph", list(GRAPHS))
@pytest.mark.parametrize("ids", ["int64", "int32"])
def test_record_routed_dx_matches_jax_v2e_max_bwd(graph, ids):
    """The tree's record table (int64, or int32 as the aligned argmax gives
    it) routed over the e2v table, against JAX's backward of v2e_max_tree;
    tie-heavy x, so many (edge, feature) pairs have several maximal members."""
    jhg, thg = _graphs(graph)
    jd, td = jhg.device_data(), thg.device_data("cpu")
    jst, tst = jplanner.plan_tree(jhg).device()[0], planner.plan_tree(thg).device("cpu")[0]
    rng = np.random.default_rng(len(graph))
    x = rng.integers(-2, 3, size=(thg.num_nodes, 7)).astype(np.float32)
    cot = rng.integers(-2, 3, size=(thg.num_edges, 7)).astype(np.float32)
    _, vjp = jax.vjp(lambda v: jmaxops.v2e_max_tree(v, jst, jd.h_edge, jd.h_segids, jd.h_indptr),
                     jnp.asarray(x))
    (want,) = vjp(jnp.asarray(cot))
    _, arg = maxops.tree_max_with_arg(torch.as_tensor(x), tst)
    assert arg.dtype == torch.int64
    before = (segment_sum.launches, segment_sum.record_launches)
    got = segment_sum.record_routed_dx(torch.as_tensor(cot), arg.to(getattr(torch, ids)), td.e2v)
    assert (segment_sum.launches, segment_sum.record_launches) == before  # the twin on the CPU
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)
    xt = torch.as_tensor(x).requires_grad_(True)
    maxops.v2e_max_tree(xt, tst, td.e2v).backward(torch.as_tensor(cot))
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)


def test_kernel_entry_and_constants_match_the_source():
    """The ctypes signature holds as many arguments as the C entry takes, and
    the host's constants are the kernel's."""
    source = (_build.CSRC / "segment_sum.cu").read_text()
    m = re.search(r'extern "C" int hg_gather_segment_sum\(([^)]*)\)', source)
    assert m and len(m.group(1).split(",")) == len(_build.ENTRIES["hg_gather_segment_sum"])
    assert f"constexpr int kRows = {UNROLL};" in source
    assert f"constexpr int kMaxSegs = {MAX_SEGS};" in source
    assert f"constexpr int kMaxEntries = {MAX_ENTRIES};" in source
    # a run of several segments fits the kernel's staging
    assert 2 * SHARE - 2 <= MAX_ENTRIES and SHARE <= MAX_SEGS


@pytest.mark.parametrize("f,want", [(32, (4, 8)), (4, (4, 1)), (100, (4, 32)), (6, (2, 4)),
                                    (3, (1, 4)), (1425, (1, 32))])
def test_layout_reads_rows_in_as_few_loads_as_alignment_allows(f, want):
    x = torch.zeros(8 * f + 4)
    assert segment_sum.layout(f, [x[:8 * f]]) == want
    # 4 bytes past an aligned start: one column a load
    assert segment_sum.layout(f, [x[1:8 * f + 1]])[0] == 1
    ids = torch.zeros(8 * f, dtype=torch.int64)  # int64 ids: 16-byte loads of two
    assert segment_sum.layout(f, [x[:8 * f], ids]) == want


def test_segment_table_builds_runs_only_on_the_card():
    indptr = np.array([0, 3, 3, 7])
    table = segment_sum.SegmentTable.build(indptr, [0, 1, 2, 3, 4, 0, 1], 5, "cpu")
    assert table.runs is None
    np.testing.assert_array_equal(segment_sum.warp_runs(indptr), [[0, 0], [3, 7]])


def test_plan_aggregation_plans_for_the_card_by_default(monkeypatch):
    _, thg = _graphs("random")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        planner.plan_aggregation(thg)
    plan = planner.plan_aggregation(thg, "cpu")
    assert plan.preferred_backend in ("precomp", "dense", "cumsum")
    assert plan.tree is not None
