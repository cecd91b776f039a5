"""The port's aligned route against the JAX package's, on the CPU.

Same NumPy inputs into ``hypergef_tpu`` and ``hypergef_tpu_torch``; JAX
runs on the CPU, its Pallas band kernel in interpret mode as
tests/test_aligned_pallas.py runs it. The graph is the SBM recipe of
``experiments/clustered_bench.py`` at the size of tests/test_aligned_pallas.py
(2000 × 1600, 25 communities), shuffled and then reordered by each package.
Tolerances:

* host tables (orders, reordered graphs, aligned stages and plans, the
  bucket-merge cost model, identity flags): exact, the same NumPy code;
* plain applies against JAX's XLA chains and its interpret-mode Pallas
  kernel: rtol = atol = 1e-5 (exact products, f32 sums in another order);
* the ``aligned`` route and its gradients: 1e-3, the f32 tolerance of
  tests/test_fuzz_backends.py:46;
* Trainer and ServingModel against JAX's: the bars of
  tests/test_torch_port_train.py and tests/test_torch_port_serve.py.
"""

import dataclasses
import functools
import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import hypergef_tpu.data.synthetic as jsyn
from experiments.clustered_bench import community_hypergraph as jcommunity_hypergraph
from hypergef_tpu.models.zoo import build_model as jbuild_model
from hypergef_tpu.ops import fused as jfused
from hypergef_tpu.ops import tree as jtree
from hypergef_tpu.ops.aligned_pallas import apply_aligned_b_pallas
from hypergef_tpu.sparse import planner as jplanner
from hypergef_tpu.sparse import reorder as jreorder
from hypergef_tpu.train import splits as jsplits
from hypergef_tpu.train.trainer import TrainConfig as JTrainConfig
from hypergef_tpu.train.trainer import Trainer as JTrainer

import hypergef_tpu_torch.data.synthetic as tsyn
from hypergef_tpu_torch.models.convert import params_from_flax
from hypergef_tpu_torch.ops import aligned_band, fused, tree
from hypergef_tpu_torch.ops.fused_dense import bf16_round
from hypergef_tpu_torch.serve import ServingModel
from hypergef_tpu_torch.sparse import planner, reorder
from hypergef_tpu_torch.sparse.planner import AggregationPlan
from hypergef_tpu_torch.train.trainer import TrainConfig, Trainer, default_plan
from test_torch_port_cuda import aligned_plan, split_buckets, widen_windows

REPO = Path(__file__).resolve().parents[1]
N, E = 2000, 1600
SBM = (N, E, 25, 5, 0.02, 3)  # community_hypergraph's arguments
TOL = dict(rtol=1e-5, atol=1e-5)
F32_TOL = dict(rtol=1e-3, atol=1e-3)
NFEAT, NCLASS = 12, 4


@pytest.fixture(autouse=True)
def deterministic():
    prev = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    yield
    torch.use_deterministic_algorithms(prev)


@functools.lru_cache(maxsize=None)
def _graphs(kind):
    """(JAX, port) graphs: ``raw`` is the SBM graph with shuffled vertex ids
    (bench.py:172-174), ``sorted`` the same after each package's
    ``community_reorder``."""
    perm = np.random.default_rng(7).permutation(N)
    jraw, _ = jreorder.apply_vertex_order(jcommunity_hypergraph(*SBM), perm, sort_edges=False)
    traw, _ = reorder.apply_vertex_order(tsyn.community_hypergraph(*SBM), perm, sort_edges=False)
    if kind == "raw":
        return jraw, traw
    return jreorder.community_reorder(jraw)[0], reorder.community_reorder(traw)[0]


def _assert_same_graph(jhg, thg):
    assert (thg.num_nodes, thg.num_edges, thg.name) == (jhg.num_nodes, jhg.num_edges, jhg.name)
    for name in ("h_indptr", "h_indices", "ht_indptr", "ht_indices"):
        a, b = getattr(jhg, name), getattr(thg, name)
        assert a.dtype == b.dtype, name
        np.testing.assert_array_equal(a, b, err_msg=name)


def _assert_same(a, b, what=""):
    """Two host structures (NamedTuples, tuples, arrays, scalars) equal,
    dtypes included."""
    if isinstance(a, np.ndarray):
        assert isinstance(b, np.ndarray) and a.dtype == b.dtype, what
        np.testing.assert_array_equal(a, b, err_msg=what)
    elif isinstance(a, tuple) and hasattr(a, "_fields"):
        assert type(a).__name__ == type(b).__name__ and a._fields == b._fields, what
        for field in a._fields:
            _assert_same(getattr(a, field), getattr(b, field), f"{what}.{field}")
    elif isinstance(a, tuple):
        assert isinstance(b, tuple) and len(a) == len(b), what
        for i, (x, y) in enumerate(zip(a, b)):
            _assert_same(x, y, f"{what}[{i}]")
    else:
        assert a == b, what


# ---- reorder and generator -------------------------------------------


@pytest.mark.parametrize("seed", [0, 3])
def test_community_hypergraph_is_bit_equal(seed):
    args = (700, 500, 12, 6, 0.05, seed)
    _assert_same_graph(jcommunity_hypergraph(*args), tsyn.community_hypergraph(*args))


@pytest.mark.parametrize("iters", [1, 8])
def test_community_order_is_bit_equal(iters):
    jraw, traw = _graphs("raw")
    got = reorder.community_order_numpy(traw, iters)
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, jreorder.community_order_numpy(jraw, iters))
    np.testing.assert_array_equal(reorder.community_order(traw, iters),
                                  jreorder.community_order(jraw, iters))


@pytest.mark.parametrize("graph", ["raw", "random"])
def test_coarsen_order_is_bit_equal(graph):
    """Against JAX's NumPy path and its default (the native library where
    it is built)."""
    if graph == "raw":
        jhg, thg = _graphs("raw")
    else:  # edges past edge_cap, empty edges, no community structure
        jhg = jsyn.random_hypergraph(300, 200, avg_edge_size=8.0, seed=5)
        thg = tsyn.random_hypergraph(300, 200, avg_edge_size=8.0, seed=5)
    got = reorder.coarsen_order(thg)
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, jreorder.coarsen_order(jhg, use_native=False))
    np.testing.assert_array_equal(got, jreorder.coarsen_order(jhg))
    np.testing.assert_array_equal(reorder.coarsen_order(thg, edge_cap=4, max_levels=2),
                                  jreorder.coarsen_order(jhg, edge_cap=4, max_levels=2,
                                                         use_native=False))


@pytest.mark.parametrize("sort_edges", [True, False])
def test_apply_vertex_order_is_bit_equal(sort_edges):
    jraw, traw = _graphs("raw")
    order = np.random.default_rng(11).permutation(N).astype(np.int32)
    (jhg, jrank), (thg, trank) = (jreorder.apply_vertex_order(jraw, order, sort_edges),
                                  reorder.apply_vertex_order(traw, order, sort_edges))
    _assert_same_graph(jhg, thg)
    assert trank.dtype == jrank.dtype
    np.testing.assert_array_equal(trank, jrank)


@pytest.mark.parametrize("method", ["coarsen", "labelprop"])
def test_community_reorder_is_bit_equal(method):
    jraw, traw = _graphs("raw")
    (jhg, jrank), (thg, trank) = (jreorder.community_reorder(jraw, method=method),
                                  reorder.community_reorder(traw, method=method))
    _assert_same_graph(jhg, thg)
    np.testing.assert_array_equal(trank, jrank)


# ---- aligned host layer ----------------------------------------------


def _directions(hg):
    return ((hg.ht_indptr, hg.ht_indices, hg.num_nodes), (hg.h_indptr, hg.h_indices, hg.num_edges))


@pytest.mark.parametrize("wb", [2, 4, 8])
def test_uniform_stage_and_spill_stats_are_bit_equal(wb):
    jhg, _ = _graphs("sorted")
    for indptr, indices, n_in in _directions(jhg):
        for g_rows in (128, 64):
            assert (planner.aligned_spill_stats(indptr, indices, n_in, g_rows, wb)
                    == jplanner.aligned_spill_stats(indptr, indices, n_in, g_rows, wb))
            _assert_same(jplanner.build_aligned_stage(indptr, indices, n_in, g_rows, wb),
                         planner.build_aligned_stage(indptr, indices, n_in, g_rows, wb))


@pytest.mark.parametrize("kw", [
    {}, {"block_rows": 64}, {"group_rows": 64}, {"max_width": 32},
    {"spill_pad_pow2": True}, {"feat_bytes": 8, "spill_fudge": 0},
], ids=lambda kw: "-".join(f"{k}={v}" for k, v in kw.items()) or "default")
def test_bucketed_stage_is_bit_equal(kw):
    jhg, _ = _graphs("sorted")
    for indptr, indices, n_in in _directions(jhg):
        want = jplanner.build_aligned_stage_bucketed(indptr, indices, n_in, **kw)
        got = planner.build_aligned_stage_bucketed(indptr, indices, n_in, **kw)
        _assert_same(want, got)
        assert got.spill_fraction == want.spill_fraction
        assert got.window_blocks == want.window_blocks
        assert got.table_bytes() == want.table_bytes()


def _identity_flags(stage):
    return (stage.base_identity, stage.spill_identity)


@pytest.mark.parametrize("form,wb,g_rows", [
    ("bucketed", None, 128), ("bucketed", 32, 128), ("bucketed", None, 64),
    ("uniform", None, 128), ("uniform", 32, 128),
])
def test_plan_aligned_is_bit_equal(form, wb, g_rows):
    """Every array of both stages, and (bucketed) the identity flags of
    JAX's device stages (planner.py:295-305)."""
    jhg, thg = _graphs("sorted")
    jplan = jplanner.plan_aligned(jhg, form=form, window_blocks=wb, group_rows=g_rows)
    tplan = planner.plan_aligned(thg, form=form, window_blocks=wb, group_rows=g_rows)
    assert (tplan.num_nodes, tplan.num_edges, tplan.form) == (jplan.num_nodes, jplan.num_edges,
                                                              "xla")
    _assert_same(jplan.edge_stage, tplan.edge_stage, "edge")
    _assert_same(jplan.vertex_stage, tplan.vertex_stage, "vertex")
    if form == "bucketed":
        for jst, tst in zip(jplan.device(), tplan.device("cpu")):
            assert _identity_flags(tst) == _identity_flags(jst)


def test_identity_flags_of_multi_bucket_and_partial_spill_stages():
    """A stage split into several buckets out of group order has neither
    identity; a single spill bucket that misses one group is no identity."""
    jhg, thg = _graphs("sorted")
    for g_rows in (128, 64):
        tplan = planner.plan_aligned(thg, group_rows=g_rows)
        split = dataclasses.replace(tplan, edge_stage=split_buckets(tplan.edge_stage),
                                    vertex_stage=split_buckets(tplan.vertex_stage))
        for st in split.device("cpu"):
            assert _identity_flags(st) == (False, False)
        jsplit = jplanner.TreePlan(*(_to_jax(st) for st in (split.edge_stage,
                                                            split.vertex_stage)),
                                   num_nodes=N, num_edges=E)
        assert [_identity_flags(s) for s in jsplit.device()] == [(False, False)] * 2
    vst = planner.plan_aligned(thg, group_rows=64).vertex_stage
    assert len(vst.spills) == 1 and vst.spills[0].group_ids.size == len(vst.spill_slot) - 1
    assert _identity_flags(planner.plan_aligned(thg, group_rows=64).device("cpu")[1]) == (True,
                                                                                         False)


def _to_jax(st):
    """The same host stage as the JAX package's NamedTuples."""
    return jplanner.AlignedStageB(
        buckets=tuple(jplanner.AlignedBucket(*b) for b in st.buckets),
        spills=tuple(jplanner.AlignedSpill(*s) for s in st.spills),
        base_slot=st.base_slot, spill_slot=st.spill_slot, counts=st.counts,
        num_inputs=st.num_inputs, num_segments=st.num_segments, group_rows=st.group_rows,
        block_rows=st.block_rows)


def test_cost_model_is_bit_equal():
    for name in ("ALIGNED_BLOCK", "ALIGNED_A_ELEM_RATE", "ALIGNED_STREAM_BPS",
                 "ALIGNED_GATHER_S_PER_ROW", "ALIGNED_KERNEL_FIXED_S",
                 "ALIGNED_KERNELS_PER_BUCKET", "ALIGNED_SPILL_PAD_GATHER_S"):
        assert getattr(planner, name) == getattr(jplanner, name), name
    rng = np.random.default_rng(0)
    for size in (1, 7, 300):
        widths = rng.choice([1, 2, 3, 4, 6, 8, 12, 16, 24, 32], size=size).astype(np.int64)
        for unit in (1e-9, 3.25e-8, 1e-6):
            for kw in ({}, {"max_buckets": 2}, {"fixed_s": planner.ALIGNED_KERNEL_FIXED_S}):
                _assert_same(jplanner._merge_buckets_cost(widths, unit, **kw),
                             planner._merge_buckets_cost(widths, unit, **kw))
        sw = (rng.integers(1, 20, size=size) * 8).astype(np.int64)
        for min_count in (1, 8, 40):
            _assert_same(jplanner._merge_small_buckets(sw, min_count),
                         planner._merge_small_buckets(sw, min_count))
    # the window optimizer against JAX's (its native twin where it is built)
    jhg, _ = _graphs("sorted")
    for indptr, indices, n_in in _directions(jhg):
        seg = np.repeat(np.arange(len(indptr) - 1, dtype=np.int64), np.diff(indptr))
        grp, blk = seg // 128, indices.astype(np.int64) // 128
        cnt = np.bincount(grp, minlength=-(-(len(indptr) - 1) // 128))
        nb = -(-n_in // 128)
        for max_width in (2, 8, 32):
            _assert_same(jplanner._group_windows_opt(grp, blk, cnt, nb, max_width, 128),
                         planner._group_windows_opt(grp, blk, cnt, nb, max_width, 128))


def test_refusals_match_jax():
    """An unsorted graph spills too much (ValueError); a small spill_limit
    refuses the tables (MemoryError); the messages are JAX's."""
    jrand = jsyn.random_hypergraph(N, E, avg_edge_size=5.0, seed=1)
    trand = tsyn.random_hypergraph(N, E, avg_edge_size=5.0, seed=1)
    jsorted, tsorted = _graphs("sorted")
    cases = [((jrand, trand), {"form": "bucketed"}, ValueError),
             ((jrand, trand), {"form": "uniform"}, ValueError),
             ((jsorted, tsorted), {"spill_limit": 100}, MemoryError),
             ((jsorted, tsorted), {"form": "uniform", "spill_limit": 100}, MemoryError),
             ((jsorted, tsorted), {"form": "banded"}, ValueError)]
    for (jhg, thg), kw, exc in cases:
        with pytest.raises(exc) as want:
            jplanner.plan_aligned(jhg, **kw)
        with pytest.raises(exc) as got:
            planner.plan_aligned(thg, **kw)
        assert str(got.value) == str(want.value)
    assert "community_reorder" in str(pytest.raises(ValueError, planner.plan_aligned, trand).value)


# ---- applies -----------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _layout_plans(layout):
    """(JAX plan, port plan) of one aligned layout on the sorted graph."""
    jhg, thg = _graphs("sorted")
    if layout in ("split", "wide"):
        relay = (split_buckets if layout == "split"
                 else functools.partial(widen_windows, gids=(0, 5, 6), extra=12))
        tplan = planner.plan_aligned(thg)
        tplan = dataclasses.replace(tplan, edge_stage=relay(tplan.edge_stage),
                                    vertex_stage=relay(tplan.vertex_stage))
        jplan = jplanner.TreePlan(_to_jax(tplan.edge_stage), _to_jax(tplan.vertex_stage),
                                  num_nodes=N, num_edges=E)
        return jplan, tplan
    kw = {"bucketed": {}, "uniform": {"form": "uniform"}, "group64": {"group_rows": 64}}[layout]
    return jplanner.plan_aligned(jhg, **kw), planner.plan_aligned(thg, **kw)


def _x(rows, f, seed):
    return np.random.default_rng(seed).normal(size=(rows, f)).astype(np.float32)


@pytest.mark.parametrize("layout", ["bucketed", "split", "uniform", "group64"])
@pytest.mark.parametrize("stage", [0, 1], ids=["edge", "vertex"])
@pytest.mark.parametrize("f", [32, 4, 3])
def test_plain_apply_matches_jax(layout, stage, f):
    """The plain chains against JAX's ``_apply_aligned_b``/``_apply_aligned``
    and, for bucketed stages, its Pallas kernel in interpret mode."""
    jplan, tplan = _layout_plans(layout)
    jst, tst = jplan.device()[stage], tplan.device("cpu")[stage]
    x = _x(tst.num_inputs, f, seed=f + stage)
    got = tree._apply_any(torch.as_tensor(x), tst).numpy()
    assert got.shape == (tst.num_segments, f)
    np.testing.assert_allclose(got, np.asarray(jtree._apply_any(jnp.asarray(x), jst)), **TOL)
    if layout != "uniform" and f != 4:
        want = apply_aligned_b_pallas(jnp.asarray(x), jst, interpret=True)
        np.testing.assert_allclose(got, np.asarray(want), **TOL)


def _emulate_kernel(x, table):
    """What the band kernel computes, read from its BandTable alone: per
    group, the band over its window blocks (rows past N are zeros) plus
    its spill slots (source N is the zero row)."""
    n, f = x.shape
    xz = torch.cat([bf16_round(x), x.new_zeros((1, f))])
    g_rows, b_rows = table.group_rows, table.block_rows
    out = x.new_zeros((table.num_groups * g_rows, f))
    for g, (bo, wo, w, so, ro, sw) in enumerate(table.groups.tolist()):
        band = table.band[bo:bo + g_rows * w * b_rows].view(g_rows, w * b_rows).float()
        rows = torch.cat([torch.arange(b * b_rows, (b + 1) * b_rows)
                          for b in table.win[wo:wo + w].tolist()]).clamp(max=n)
        acc = band @ xz[rows]
        if sw:
            spill = table.spill[so:so + g_rows * sw].view(g_rows, sw).float()
            acc = acc + spill @ xz[table.src[ro:ro + sw].long()]
        out[g * g_rows:(g + 1) * g_rows] = acc
    return out[: table.num_segments]


@pytest.mark.parametrize("case", ["bucketed", "split", "uniform", "group64", "block64",
                                  "counts", "past_n", "empty", "group200", "group24", "block32",
                                  "block200", "odd_spill"])
def test_kernel_tables_hold_the_stage(case):
    """The directory and flat tables the kernel reads give the plain twin's
    result, for every layout the card tests run."""
    plan = dataclasses.replace(aligned_plan(case), form="pallas_auto")
    for st in plan.device("cpu"):
        table = st.band
        assert table is not None and table.num_groups == max(-(-st.num_segments // st.group_rows),
                                                             1)
        x = torch.as_tensor(_x(st.num_inputs, 5, seed=1))
        want = aligned_band.aligned_band_plain(x, st)
        torch.testing.assert_close(_emulate_kernel(x, table), want, **TOL)
    if case == "counts":  # the hand-made duplicates reach the tables as counts of 2
        e_st = aligned_plan(case).edge_stage
        assert max(int(b.b_dense.max()) for b in e_st.buckets) == 2
        assert max(int(s.b_spill.max()) for s in e_st.spills) == 2


def _unswizzle(tiles):
    """[n, G, SLAB] tiles as ``band_tiles`` stores them → plain row-major."""
    g_rows = tiles.shape[1]
    chunks = tiles.reshape(tiles.shape[0], g_rows, aligned_band.SLAB // 16, 16)
    perm = np.arange(chunks.shape[2])[None, :] ^ ((np.arange(g_rows)[:, None] >> 1) & 3)
    return np.take_along_axis(chunks, perm[None, :, :, None], axis=2).reshape(tiles.shape)


def _group_tiles(table, g):
    """Group g's window and spill tiles, unswizzled: [slabs, G, SLAB] each."""
    _, _, w, _, _, sw = table.groups[g].tolist()
    tile = table.group_rows * aligned_band.SLAB
    slabs = (w * -(-table.block_rows // aligned_band.SLAB), -(-sw // aligned_band.SLAB))
    tiles = table.tiles.numpy()
    return [_unswizzle(tiles[off:off + k * tile].reshape(k, table.group_rows, aligned_band.SLAB))
            for off, k in zip(table.tile_off[g].tolist(), slabs)]


def _jax_group_tables(jst, n_groups):
    """Each group's band [G, w·B] and spill [G, sw] of a JAX host stage."""
    if isinstance(jst, jplanner.AlignedStage):
        return [(jst.b_dense[g], jst.b_spill[g]) for g in range(n_groups)]
    band, spill = {}, {}
    for b in jst.buckets:
        band.update(zip(b.group_ids.tolist(), b.b_dense))
    for sp in jst.spills:
        spill.update(zip(sp.group_ids.tolist(), sp.b_spill))
    return [(band[g], spill.get(g)) for g in range(n_groups)]


@pytest.mark.parametrize("layout", ["bucketed", "split", "uniform", "group64", "wide"])
@pytest.mark.parametrize("stage", [0, 1], ids=["edge", "vertex"])
def test_band_tiles_hold_the_jax_stage(layout, stage):
    """The band kernel's tiles unpack to exactly the JAX plan's band and
    spill tables, and its work items cover every slab of every group once
    (the widest groups in two halves); a walk over the items in the
    kernel's order (window slabs, then spill slabs; rows past N and the
    spill zero row read as zeros; a split group's halves added first half
    first) gives JAX's apply (its Pallas kernel in interpret mode, or the
    uniform XLA chain) at 1e-5."""
    jplan, tplan = _layout_plans(layout)
    jhost = (jplan.edge_stage, jplan.vertex_stage)[stage]
    tst = dataclasses.replace(tplan, form="pallas_auto").device("cpu")[stage]
    assert tst.band.tiles is None  # laid out only on a CUDA device
    table = tst.band.with_kernel_layout()
    g_rows, b_rows, n, slab = table.group_rows, table.block_rows, table.num_inputs, aligned_band.SLAB
    x = _x(n, 5, seed=11 + stage)
    xz = np.concatenate([bf16_round(torch.as_tensor(x)).numpy(), np.zeros((1, 5), np.float32)])
    spb = -(-b_rows // slab)
    products = {}  # (group, slab) → its tile times its x rows
    for g, (band, spill) in enumerate(_jax_group_tables(jhost, table.num_groups)):
        _, wo, w, _, ro, sw = table.groups[g].tolist()
        win_tiles, spill_tiles = _group_tiles(table, g)
        cols = win_tiles.reshape(w, spb, g_rows, slab).transpose(2, 0, 1, 3).reshape(g_rows, w, -1)
        np.testing.assert_array_equal(cols[:, :, :b_rows].reshape(g_rows, -1), band)
        assert not cols[:, :, b_rows:].any()
        if sw:
            flat = spill_tiles.transpose(1, 0, 2).reshape(g_rows, -1)
            np.testing.assert_array_equal(flat[:, :sw], spill[:, :sw])
            assert not flat[:, sw:].any()
        for s, (blk, t0) in enumerate((b, t) for b in table.win[wo:wo + w].tolist()
                                      for t in range(0, spb * slab, slab)):
            rows = np.minimum(blk * b_rows + t0 + np.arange(slab), n)
            rows[t0 + np.arange(slab) >= b_rows] = n  # past the block: zero band columns
            products[g, s] = win_tiles[s].astype(np.float64) @ xz[rows]
        srcs = np.concatenate([table.src[ro:ro + sw].numpy(),
                               np.full(len(spill_tiles) * slab - sw, n)]).astype(np.int64)
        for s, tile in enumerate(spill_tiles):
            products[g, len(win_tiles) + s] = tile.astype(np.float64) @ xz[srcs[s * slab:(s + 1) * slab]]
    work = table.work.numpy()
    assert sorted((g, s) for g, b, e, _ in work for s in range(b, e)) == sorted(products)
    sizes = work[:, 2] - work[:, 1]
    assert (np.diff(sizes) <= 0).all()  # the longest first
    assert ((work[:, 3] >= 0).any()) == (layout == "wide")
    out = np.zeros((table.num_groups * g_rows, 5), np.float32)
    halves = {}
    for g, b, e, slot in work.tolist():
        acc = sum(products[g, s] for s in range(b, e))
        if slot >= 0:
            halves[g, b > 0] = acc
            if (g, not (b > 0)) not in halves:
                continue
            acc = halves[g, False] + halves[g, True]
        out[g * g_rows:(g + 1) * g_rows] = acc
    jst = jplan.device()[stage]
    want = (jtree._apply_any(jnp.asarray(x), jst) if layout == "uniform"
            else apply_aligned_b_pallas(jnp.asarray(x), jst, interpret=True))
    np.testing.assert_allclose(out[:table.num_segments], np.asarray(want), **TOL)


@pytest.mark.parametrize("ctas,group_rows,cuts", [(None, 128, 2), (12, 128, 0), (13, 128, 1),
                                                  (14, 128, 2), (25, 200, 0), (26, 200, 1)])
def test_band_work_cuts_the_widest_groups_within_one_wave(ctas, group_rows, cuts):
    """A group wider than 1.5x the median is cut in two only while every
    item's CTAs (one a 128 rows of its group) fit on the card at once, the
    widest first; every slab of every group lies in exactly one item, the
    longest items first, and a slot holds the two halves of one group."""
    width = np.array([2] * 10 + [9, 12])
    sw = np.array([0] * 11 + [70])  # the widest group also has two spill slabs
    slabs = width + -(-sw // aligned_band.SLAB)  # block_rows 64: one slab a block
    work, slots = aligned_band.band_work(width, sw, 64, group_rows, ctas)
    assert slots == cuts
    assert (np.diff(work[:, 2] - work[:, 1]) <= 0).all()
    covered = np.zeros(len(slabs), np.int64)
    np.add.at(covered, work[:, 0], work[:, 2] - work[:, 1])
    np.testing.assert_array_equal(covered, slabs)
    cut = sorted(int(g) for g, _, _, slot in work if slot >= 0)
    assert cut == sorted(2 * [11, 10][:cuts])
    for slot in range(slots):
        (g0, b0, e0, _), (g1, b1, e1, _) = sorted(w.tolist() for w in work if w[3] == slot)
        assert g0 == g1 and b0 == 0 and e0 == b1 == (slabs[g0] + 1) // 2 and e1 == slabs[g0]
    assert (work[:, 3] == -1).sum() == len(slabs) - cuts


def test_band_kernel_source_matches_the_wrapper():
    """The band kernel's layout constants are the wrapper's, and every
    ablation that ``chip_smoke.py --profile`` builds from its source applies
    (each substitution exactly once)."""
    import re

    from hypergef_tpu_torch.ops import _build

    source = (_build.CSRC / "aligned_band.cu").read_text()
    consts = {k: int(v) for k, v in re.findall(r"constexpr int (k\w+) = (\d+);", source)}
    warps = consts["kWarps"]
    assert (consts["kSlab"], 16 * warps, consts["kCtasPerSm"]) == (
        aligned_band.SLAB, aligned_band.ROWS_PER_CTA, aligned_band.CTAS_PER_SM)
    assert "__launch_bounds__(kThreads, kCtasPerSm)" in source
    spec = importlib.util.spec_from_file_location("chip_smoke", REPO / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    assert smoke.BAND_ABLATIONS
    for name in smoke.BAND_ABLATIONS:
        assert smoke.band_ablation_source(name, source) != source
    with pytest.raises(ValueError, match="once"):
        smoke.band_ablation_source(next(iter(smoke.BAND_ABLATIONS)), "")


def test_kernel_form_on_cpu_tensors_is_the_plain_form_bitwise():
    _, tplan = _layout_plans("bucketed")
    kplan = dataclasses.replace(tplan, form="pallas_auto")
    hgd = _graphs("sorted")[1].device_data("cpu")
    x = torch.as_tensor(_x(N, 6, seed=2))
    before = aligned_band.launches
    for kst, pst in zip(kplan.device("cpu"), tplan.device("cpu")):
        xi = torch.as_tensor(_x(kst.num_inputs, 6, seed=3))
        assert torch.equal(tree._apply_any(xi, kst), tree._apply_any(xi, pst))
    for aggr in ("sum", "mean"):
        assert torch.equal(fused.hgnn_aggregate(hgd, x, None, aggr, kplan, "aligned"),
                           fused.hgnn_aggregate(hgd, x, None, aggr, tplan, "aligned"))
    assert aligned_band.launches == before


def test_device_stages_belong_to_each_plan():
    """``dataclasses.replace(plan, form=...)`` builds its own device stages:
    a kernel-form copy of a plan already on a device does not reuse the
    plain stages (and the other way round), for aligned and tree plans."""
    _, thg = _graphs("sorted")
    plain = planner.plan_aligned(thg)
    plain_stages = plain.device("cpu")
    assert plain.device(torch.device("cpu")) is plain_stages  # built once per device
    kernel = dataclasses.replace(plain, form="pallas_auto")
    assert all(st.band is None for st in plain_stages)
    assert all(st.band is not None for st in kernel.device("cpu"))
    assert plain.device("cpu") is plain_stages
    assert dataclasses.replace(kernel, form="xla").device("cpu")[0].band is None
    assert "_device" not in {f.name for f in dataclasses.fields(plain) if f.init}
    tree_plan = planner.plan_tree(thg)
    assert tree_plan.device("cpu")[0].gather0 is None
    assert dataclasses.replace(tree_plan, form="pallas_auto").device("cpu")[0].gather0 is not None


def test_band_table_is_checked_once():
    st, _ = dataclasses.replace(aligned_plan("bucketed"), form="pallas_auto").device("cpu")
    t = st.band
    table = dict(band=t.band, win=t.win, spill=t.spill, src=t.src, groups=t.groups,
                 num_inputs=t.num_inputs, num_segments=t.num_segments,
                 group_rows=t.group_rows, block_rows=t.block_rows)
    aligned_band.BandTable(**table)
    bad_groups = t.groups.clone()
    bad_groups[0, 0] = t.band.numel()
    bad_src = t.src.clone()
    bad_src[0] = t.num_inputs + 1
    bad_win = t.win.clone()
    bad_win[0] = -1
    for change, exc, match in (
            ({"win": t.win.long()}, TypeError, "win"),
            ({"groups": bad_groups}, ValueError, "band table"),
            ({"src": bad_src}, ValueError, "spill sources"),
            ({"win": bad_win}, ValueError, "window block"),
            ({"groups": t.groups[:-1]}, ValueError, "groups must be")):
        with pytest.raises(exc, match=match):
            aligned_band.BandTable(**{**table, **change})
    with pytest.raises(RuntimeError, match="autograd"):
        aligned_band.aligned_band(torch.ones((st.num_inputs, 2), requires_grad=True), st)
    with pytest.raises(ValueError, match="on the CPU"):
        aligned_band.aligned_band(torch.ones((st.num_inputs, 2)),
                                  dataclasses.replace(st, counts=st.counts.to("meta")))


# ---- the route, training and serving -----------------------------------


@functools.lru_cache(maxsize=None)
def _jax_route(aggr, with_wdiag):
    """JAX's aligned route: output and the gradients w.r.t. x and wdiag."""
    jhg, _ = _graphs("sorted")
    x, w, cot = _route_inputs()
    jplan, _ = _layout_plans("bucketed")
    hgd = jhg.device_data()

    def f(xv, wv):
        out = jfused.hgnn_aggregate(hgd, xv, wv if with_wdiag else None, aggr, plan=jplan,
                                    backend="aligned")
        return jnp.sum(out * cot), out

    (_, out), (dx, dw) = jax.value_and_grad(f, argnums=(0, 1), has_aux=True)(
        jnp.asarray(x), jnp.asarray(w))
    return np.asarray(out), np.asarray(dx), np.asarray(dw)


def _route_inputs():
    rng = np.random.default_rng(9)
    return (rng.normal(size=(N, 5)).astype(np.float32),
            rng.uniform(0.5, 1.5, (E, 1)).astype(np.float32),
            rng.normal(size=(N, 5)).astype(np.float32))


@pytest.mark.parametrize("form", ["xla", "pallas_auto"])
@pytest.mark.parametrize("aggr", ["sum", "mean"])
@pytest.mark.parametrize("with_wdiag", [False, True])
def test_aligned_route_and_gradients_match_jax(form, aggr, with_wdiag):
    _, thg = _graphs("sorted")
    x, w, cot = _route_inputs()
    want_out, want_dx, want_dw = _jax_route(aggr, with_wdiag)
    plan = AggregationPlan(aligned=dataclasses.replace(_layout_plans("bucketed")[1], form=form))
    xt = torch.as_tensor(x).requires_grad_(True)
    wt = torch.as_tensor(w).requires_grad_(True)
    before = aligned_band.launches
    out = fused.hgnn_aggregate(thg.device_data("cpu"), xt, wt if with_wdiag else None, aggr,
                               plan=plan, backend="aligned")
    (out * torch.as_tensor(cot)).sum().backward()
    assert aligned_band.launches == before  # plain twins on the CPU
    np.testing.assert_allclose(out.detach().numpy(), want_out, **F32_TOL)
    np.testing.assert_allclose(xt.grad.numpy(), want_dx, **F32_TOL)
    if with_wdiag:
        np.testing.assert_allclose(wt.grad.numpy(), want_dw, **F32_TOL)


def _problem():
    jhg, thg = _graphs("sorted")
    x, y = jsyn.random_features(N, NFEAT, NCLASS, seed=4)
    return jhg, thg, x, y, jsplits.rand_train_test_idx(y, seed=2)


@pytest.mark.parametrize("first_aggr,nlayer,form", [("sum", 2, "xla"), ("mean", 2, "pallas_auto")])
def test_trainer_matches_jax_trainer_on_aligned(first_aggr, nlayer, form):
    """JAX's Trainer on AggregationPlan(tree=plan_tree, aligned=plan_aligned)
    (experiments/clustered_bench.py:136), the port's on its aligned plan,
    from the same weights, dropout off, 40 epochs."""
    jhg, thg, x, y, split = _problem()
    jcfg = JTrainConfig(model="HGNN", nhid=8, nlayer=nlayer, first_aggr=first_aggr,
                        dropout=0.0, input_drop=0.0, epochs=40, warmup=0, seed=0,
                        backend="aligned")
    jplan = jplanner.AggregationPlan(tree=jplanner.plan_tree(jhg),
                                     aligned=jplanner.plan_aligned(jhg))
    jtr = JTrainer(jcfg, jhg, x, y, nclass=NCLASS, plan=jplan)
    params = params_from_flax(jtr.params)
    want = [jtr.fit(split["train"], epochs=1, warmup=0)["final_loss"] for _ in range(40)]
    want_pred = np.asarray(jtr._forward(jtr.params, jtr.x)).argmax(1)

    cfg = TrainConfig(**dataclasses.asdict(jcfg))
    plan = None if form == "xla" else AggregationPlan(
        aligned=dataclasses.replace(planner.plan_aligned(thg), form=form))
    before = aligned_band.launches
    tr = Trainer(cfg, thg, x, y, nclass=NCLASS, plan=plan, device="cpu", params=params)
    assert tr.plan.aligned.form == form
    res = tr.fit(split["train"])
    assert aligned_band.launches == before
    np.testing.assert_allclose(res["losses"][:10], want[:10], rtol=1e-3)
    assert (tr.predict().argmax(1).numpy() == want_pred).mean() >= 0.98


def test_serving_matches_jax_on_aligned():
    """The JAX serving path on an aligned-route graph (never run in the
    JAX package itself) against the port's ServingModel, which builds the
    plan when none is given."""
    jhg, thg, x, _, _ = _problem()
    jmodel = jbuild_model("HGNN", NFEAT, 16, NCLASS, nlayer=2, backend="aligned")
    jhgd = jhg.device_data()
    jplan = jplanner.AggregationPlan(tree=jplanner.plan_tree(jhg),
                                     aligned=jplanner.plan_aligned(jhg))
    params = jmodel.init({"params": jax.random.key(0)}, jnp.asarray(x), jhgd, jplan)["params"]
    want = np.asarray(jmodel.apply({"params": params}, jnp.asarray(x), jhgd, jplan))
    cfg = TrainConfig(model="HGNN", nhid=16, nlayer=2, backend="aligned")
    server = ServingModel(cfg, thg, NFEAT, NCLASS, "cpu", params=params_from_flax(params))
    assert server.plan.aligned.form == "xla" and server.plan.aligned._device  # tables built
    got = server.predict(x).numpy()
    np.testing.assert_allclose(got, want, **F32_TOL)
    assert (got.argmax(1) == want.argmax(1)).mean() >= 0.98


def test_default_plan_for_aligned():
    _, thg = _graphs("sorted")
    plan = default_plan("aligned", thg, "cpu")
    assert plan.aligned.form == "xla" and (plan.dense, plan.tree, plan.pallas_sparse) == (
        None, None, None)
    _, traw = _graphs("raw")
    with pytest.raises(ValueError, match="community_reorder"):
        Trainer(TrainConfig(backend="aligned"), traw, np.zeros((N, 3), np.float32),
                np.zeros(N, np.int64), device="cpu")
