"""The port's native host library against its NumPy twins, on the CPU.

``hypergef_tpu_torch/csrc/hypergef_native.cpp`` is built at first use into
``build/native/`` (a digest-named library, written to a temporary name and
renamed into place), never into ``csrc/``; a failed build raises with the
compiler's message. Every entry is bit-equal to the port's NumPy path, and
the orders ``reorder`` and the planner take with ``use_native=True`` (the
default) equal the JAX package's NumPy orders.
"""

import os
from pathlib import Path

import numpy as np
import pytest
import scipy.io

from hypergef_tpu.sparse import planner as jplanner
from hypergef_tpu.sparse import reorder as jreorder
from hypergef_tpu.sparse.hypergraph import Hypergraph as JHypergraph

import hypergef_tpu_torch.data.synthetic as tsyn
from hypergef_tpu_torch.sparse import native, planner, reorder

REPO = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def skewed():
    return tsyn.powerlaw_hypergraph(300, 200, alpha=1.8, seed=7)


@pytest.fixture(scope="module")
def shuffled_sbm():
    hg = tsyn.community_hypergraph(3000, 1500, 24, 8, 0.05, 0)
    perm = np.random.default_rng(7).permutation(hg.num_nodes)
    return reorder.apply_vertex_order(hg, perm, sort_edges=False)[0]


def test_builds_into_build_not_csrc():
    lib = native.build()
    assert lib.parent == REPO / "build" / "native"
    assert lib.name == f"libhypergef_native_{native._digest()}.so"
    assert native.SOURCE == REPO / "hypergef_tpu_torch" / "csrc" / "hypergef_native.cpp"
    assert native.CXX_FLAGS == ("-O3", "-fPIC", "-std=c++17", "-fopenmp", "-shared")
    assert native.cxx_flags() in (native.CXX_FLAGS,
                                  ("-O3", "-fPIC", "-std=c++17", "-shared"))
    assert native.build() == lib  # built once, then reused
    assert not [f for f in os.listdir(lib.parent) if f.endswith(".so") and "tmp" in f]


def test_failed_build_raises_with_the_compiler_message(tmp_path, monkeypatch):
    bad = tmp_path / "bad.cpp"
    bad.write_text('extern "C" int hg_broken( { return 0; }\n')
    monkeypatch.setattr(native, "SOURCE", bad)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "out")
    native.cxx_flags.cache_clear()
    try:
        with pytest.raises(RuntimeError, match="native host library build failed") as err:
            native.build()
    finally:
        native.cxx_flags.cache_clear()
    assert "error" in str(err.value)
    assert os.listdir(tmp_path / "out") == []  # the temporary files are gone


def test_builds_without_openmp_where_g_plus_plus_has_none(tmp_path, monkeypatch):
    """A toolchain that refuses -fopenmp (no OpenMP runtime to link) builds
    the library without it; its entries give the same results."""
    real = native.subprocess.run

    def no_openmp(cmd, **kw):
        if native.OPENMP in cmd:
            return real(["false"], **kw)
        return real(cmd, **kw)

    monkeypatch.setattr(native.subprocess, "run", no_openmp)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "out")
    native.cxx_flags.cache_clear()
    try:
        assert native.OPENMP not in native.cxx_flags()
        lib = native.build()
    finally:
        native.cxx_flags.cache_clear()
    assert lib.parent == tmp_path / "out" and lib.is_file()
    assert sorted(os.listdir(tmp_path / "out")) == [lib.name]


def test_entries_match_the_source():
    src = native.SOURCE.read_text()
    for name, (argtypes, _) in native.ENTRIES.items():
        sig = src[src.index(f" {name}("):]
        sig = sig[:sig.index(")")]
        assert sig.count(",") + 1 == len(argtypes), name


def test_read_mtx_coo_matches_scipy(tmp_path, skewed):
    fn = str(tmp_path / "g.mtx")
    scipy.io.mmwrite(fn, skewed.to_scipy())
    n, e, r, c = native.read_mtx_coo(fn)
    coo = scipy.io.mmread(fn).tocoo()
    assert (n, e) == coo.shape
    np.testing.assert_array_equal(r, coo.row)
    np.testing.assert_array_equal(c, coo.col)


def test_read_mtx_symmetric_expansion(tmp_path):
    fn = str(tmp_path / "sym.mtx")
    with open(fn, "w") as f:
        f.write("%%MatrixMarket matrix coordinate pattern symmetric\n% comment\n"
                "3 3 3\n1 1\n2 1\n3 2\n")
    n, e, r, c = native.read_mtx_coo(fn)
    assert (n, e) == (3, 3)
    assert sorted(zip(r.tolist(), c.tolist())) == [(0, 0), (0, 1), (1, 0), (1, 2), (2, 1)]
    with pytest.raises(IOError):
        native.read_mtx_coo(str(tmp_path / "missing.mtx"))


def test_coo_to_csr():
    rng = np.random.default_rng(3)
    row = rng.integers(0, 50, size=400).astype(np.int32)
    col = rng.integers(0, 70, size=400).astype(np.int32)
    indptr, indices = native.coo_to_csr(row, col, 50)
    order = np.lexsort((col, row))
    np.testing.assert_array_equal(indptr, np.concatenate([[0], np.cumsum(
        np.bincount(row, minlength=50))]))
    np.testing.assert_array_equal(indices, col[order])
    with pytest.raises(ValueError):
        native.coo_to_csr(row, col, 10)


@pytest.mark.parametrize("ngs", [1, 4, 8, 32])
def test_build_ell_bit_equal(skewed, ngs):
    want = planner.build_ell(skewed.ht_indptr, skewed.ht_indices, ngs)
    got = native.build_ell_native(skewed.ht_indptr, skewed.ht_indices, ngs)
    for f in want._fields:
        a, b = getattr(got, f), getattr(want, f)
        if isinstance(a, np.ndarray):
            assert a.dtype == b.dtype, f
            np.testing.assert_array_equal(a, b, err_msg=f)
        else:
            assert a == b, f


@pytest.mark.parametrize("method", ["labelprop", "coarsen"])
@pytest.mark.parametrize("graph", ["skewed", "shuffled_sbm"])
def test_orders_bit_equal(request, graph, method):
    hg = request.getfixturevalue(graph)
    got = reorder.community_order(hg, method=method)  # use_native=True
    want = reorder.community_order(hg, method=method, use_native=False)
    assert got.dtype == want.dtype == np.int32
    np.testing.assert_array_equal(got, want)
    if method == "coarsen":
        np.testing.assert_array_equal(got, native.coarsen_order_native(hg))
    else:
        np.testing.assert_array_equal(got, native.community_order_native(hg))


def test_orders_equal_jax_numpy(shuffled_sbm):
    hg = shuffled_sbm
    jhg = JHypergraph(hg.num_nodes, hg.num_edges, hg.h_indptr, hg.h_indices,
                      hg.ht_indptr, hg.ht_indices, hg.name)
    np.testing.assert_array_equal(reorder.coarsen_order(hg),
                                  jreorder.coarsen_order(jhg, use_native=False))
    np.testing.assert_array_equal(reorder.community_order(hg),
                                  jreorder.community_order_numpy(jhg))
    a, rank = reorder.community_reorder(hg)
    b, rank_np = reorder.community_reorder(hg, use_native=False)
    np.testing.assert_array_equal(rank, rank_np)
    for f in ("h_indptr", "h_indices", "ht_indptr", "ht_indices"):
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f))


@pytest.mark.parametrize("max_width", [4, 8, 32])
def test_aligned_windows_bit_equal(shuffled_sbm, max_width):
    hg, _ = reorder.community_reorder(shuffled_sbm)
    for indptr, indices, n_in in ((hg.ht_indptr, hg.ht_indices, hg.num_nodes),
                                  (hg.h_indptr, hg.h_indices, hg.num_edges)):
        seg = np.repeat(np.arange(len(indptr) - 1, dtype=np.int64), np.diff(indptr))
        grp = seg // 128
        blk = np.asarray(indices, np.int64) // 128
        n_groups = -(-(len(indptr) - 1) // 128)
        cnt = np.bincount(grp, minlength=n_groups)
        nb = -(-n_in // 128)
        got = planner._group_windows_opt(grp, blk, cnt, nb, max_width, 128)
        want = planner._group_windows_opt(grp, blk, cnt, nb, max_width, 128, use_native=False)
        jwant = jplanner._group_windows_opt(grp, blk, cnt, nb, max_width, 128)
        for a, b, c in zip(got, want, jwant):
            assert a.dtype == b.dtype == np.int64
            np.testing.assert_array_equal(a, b)
            np.testing.assert_array_equal(a, c)


def test_aligned_plan_with_native_windows_equals_jax(shuffled_sbm):
    hg, _ = reorder.community_reorder(shuffled_sbm)
    jhg = JHypergraph(hg.num_nodes, hg.num_edges, hg.h_indptr, hg.h_indices,
                      hg.ht_indptr, hg.ht_indices, hg.name)
    got, want = planner.plan_aligned(hg), jplanner.plan_aligned(jhg)
    for st, jst in ((got.edge_stage, want.edge_stage), (got.vertex_stage, want.vertex_stage)):
        assert len(st.buckets) == len(jst.buckets)
        for b, jb in zip(st.buckets, jst.buckets):
            np.testing.assert_array_equal(b.win_block, np.asarray(jb.win_block))
            np.testing.assert_array_equal(b.b_dense, np.asarray(jb.b_dense))
