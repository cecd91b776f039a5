"""The port's host data layer against the JAX package's, on the CPU.

Same NumPy inputs (made from a seed) into ``hypergef_tpu`` and
``hypergef_tpu_torch``; every bar is bit-equality:

* ``powerlaw_hypergraph`` over seeds and Zipf exponents (the draw order
  matters: Zipf sizes, popularity, then ``rng.choice``);
* ``transforms.add_self_loops``, ``extract_v2e``; ``stats.gini``,
  ``graph_stats``;
* the MatrixMarket round trip, the native reader against scipy's;
* all 13 fixture datasets through ``load_dataset(..., cache=False)`` (CSR,
  features, labels), cornell at two noise levels; the ``.npz`` cache read
  by the other package, and the tracked ``zoo/processed.npz`` as it is.

Datasets load from a copy under ``tmp_path``, so nothing is written under
``tests/fixtures/``.
"""

import os
import shutil

import numpy as np
import pytest

import hypergef_tpu.data.synthetic as jsyn
from hypergef_tpu.data import datasets as jdatasets
from hypergef_tpu.data import transforms as jtransforms
from hypergef_tpu.sparse import mtx as jmtx
from hypergef_tpu.sparse import stats as jstats
from hypergef_tpu.sparse.hypergraph import Hypergraph as JHypergraph

import hypergef_tpu_torch.data.synthetic as tsyn
from hypergef_tpu_torch.data import datasets, transforms
from hypergef_tpu_torch.sparse import mtx, stats
from hypergef_tpu_torch.sparse.hypergraph import Hypergraph

FIXTURE_ROOT = os.path.join(os.path.dirname(__file__), "fixtures", "data")
CSR = ("h_indptr", "h_indices", "ht_indptr", "ht_indices")


def assert_same_graph(a, b):
    assert (a.num_nodes, a.num_edges, a.name) == (b.num_nodes, b.num_edges, b.name)
    for f in CSR:
        got, want = getattr(a, f), getattr(b, f)
        assert got.dtype == want.dtype, f
        np.testing.assert_array_equal(got, want, err_msg=f)


def assert_same_dataset(a, b):
    assert a.name == b.name
    assert_same_graph(a.hg, b.hg)
    for f in ("features", "labels"):
        got, want = getattr(a, f), getattr(b, f)
        assert got.dtype == want.dtype, f
        np.testing.assert_array_equal(got, want, err_msg=f)


@pytest.fixture(scope="module")
def fixture_root(tmp_path_factory):
    """A copy of the fixture datasets, raw files only (no cache)."""
    root = tmp_path_factory.mktemp("data")
    for name in jdatasets.EXISTING_DATASETS:
        shutil.copytree(os.path.join(FIXTURE_ROOT, name, "raw"), root / name / "raw")
        shutil.copy(os.path.join(FIXTURE_ROOT, name, "FIXTURE"), root / name / "FIXTURE")
    return str(root)


@pytest.mark.parametrize("alpha", [1.8, 2.0, 2.5])
@pytest.mark.parametrize("seed", [0, 1, 7])
def test_powerlaw_hypergraph_bit_equal(seed, alpha):
    assert_same_graph(tsyn.powerlaw_hypergraph(300, 200, alpha=alpha, seed=seed),
                      jsyn.powerlaw_hypergraph(300, 200, alpha=alpha, seed=seed))


def test_powerlaw_hypergraph_capped_sizes():
    got = tsyn.powerlaw_hypergraph(400, 300, alpha=1.5, max_edge_size=5, seed=3)
    assert_same_graph(got, jsyn.powerlaw_hypergraph(400, 300, alpha=1.5, max_edge_size=5,
                                                    seed=3))
    assert got.edge_sizes().max() <= 5


def _both(v, e, n, m):
    return (Hypergraph.from_coo(v, e, num_nodes=n, num_edges=m, name="g"),
            JHypergraph.from_coo(v, e, num_nodes=n, num_edges=m, name="g"))


@pytest.mark.parametrize("seed", [0, 4])
def test_add_self_loops_bit_equal(seed):
    rng = np.random.default_rng(seed)
    e = np.concatenate([np.repeat(np.arange(30), rng.integers(1, 5, size=30)),
                        np.arange(30, 36)])  # six singleton edges
    v = rng.integers(0, 50, size=e.shape[0])
    hg, jhg = _both(v, e, 50, 36)
    assert_same_graph(transforms.add_self_loops(hg), jtransforms.add_self_loops(jhg))


def test_extract_v2e_bit_equal():
    rng = np.random.default_rng(2)
    n = 40
    v = rng.integers(0, n, size=120)
    e = rng.integers(n, n + 25, size=120)
    ei = np.concatenate([np.stack([v, e]), np.stack([e, v])], axis=1)
    ei = ei[:, rng.permutation(ei.shape[1])]
    got = transforms.extract_v2e(ei, n)
    np.testing.assert_array_equal(got, jtransforms.extract_v2e(ei, n))
    assert (got[0] < n).all()


def test_stats_bit_equal():
    rng = np.random.default_rng(5)
    for x in (rng.zipf(2.0, size=500), np.zeros(7), np.ones(9), np.array([])):
        assert stats.gini(x) == jstats.gini(x)
    for seed in (0, 3):
        hg = tsyn.powerlaw_hypergraph(300, 200, seed=seed)
        jhg = jsyn.powerlaw_hypergraph(300, 200, seed=seed)
        for p in (10.0, 25.0):
            assert stats.graph_stats(hg, p) == jstats.graph_stats(jhg, p)


@pytest.mark.parametrize("use_native", [True, False])
def test_mtx_round_trip(tmp_path, use_native):
    hg = tsyn.powerlaw_hypergraph(300, 200, alpha=1.8, seed=7, name="g")
    jhg = jsyn.powerlaw_hypergraph(300, 200, alpha=1.8, seed=7, name="g")
    ours, theirs = str(tmp_path / "port.mtx"), str(tmp_path / "jax.mtx")
    mtx.write_mtx(ours, hg)
    jmtx.write_mtx(theirs, jhg)
    assert open(ours).read() == open(theirs).read()
    back = mtx.read_mtx(ours, name="g", use_native=use_native)
    assert_same_graph(back, hg)
    assert_same_graph(back, jmtx.read_mtx(theirs, name="g"))
    assert hg.store_mtx(str(tmp_path) + "/") == str(tmp_path / "g.mtx")


def test_mtx_symmetric_native_matches_scipy(tmp_path):
    fn = str(tmp_path / "sym.mtx")
    with open(fn, "w") as f:
        f.write("%%MatrixMarket matrix coordinate pattern symmetric\n% comment\n"
                "4 4 4\n1 1\n2 1\n3 2\n4 4\n")
    assert_same_graph(mtx.read_mtx(fn), mtx.read_mtx(fn, use_native=False))


@pytest.mark.parametrize("name", sorted(jdatasets.EXISTING_DATASETS))
def test_fixture_loads_bit_equal(fixture_root, name):
    got = datasets.load_dataset(name, root=fixture_root, cache=False)
    assert_same_dataset(got, jdatasets.load_dataset(name, root=fixture_root, cache=False))
    assert got.num_classes >= 2 and got.num_features == got.features.shape[1]
    assert not [f for f in os.listdir(os.path.join(fixture_root, name)) if f.endswith(".npz")]


@pytest.mark.parametrize("noise", [1.0, 0.25])
@pytest.mark.parametrize("name", ["walmart-trips", "house-committees"])
def test_cornell_noise_bit_equal(fixture_root, name, noise):
    got = datasets.load_dataset(name, root=fixture_root, feature_noise=noise, cache=False)
    assert_same_dataset(got, jdatasets.load_dataset(name, root=fixture_root,
                                                    feature_noise=noise, cache=False))


def test_cache_is_jax_format(tmp_path):
    """The port writes JAX's cache, JAX reads it; the cornell key keeps the
    noise, so two noise levels never share a file."""
    for name in ("zoo", "walmart-trips"):
        shutil.copytree(os.path.join(FIXTURE_ROOT, name, "raw"), tmp_path / name / "raw")
    ds = datasets.load_dataset("zoo", root=str(tmp_path))
    assert sorted(os.listdir(tmp_path / "zoo")) == ["processed.npz", "raw"]
    assert_same_dataset(ds, jdatasets.load_dataset("zoo", root=str(tmp_path)))
    assert_same_dataset(datasets.load_dataset("zoo", root=str(tmp_path)), ds)
    a = datasets.load_dataset("walmart-trips", root=str(tmp_path), feature_noise=1.0)
    b = datasets.load_dataset("walmart-trips", root=str(tmp_path), feature_noise=0.5)
    assert sorted(f for f in os.listdir(tmp_path / "walmart-trips") if f.endswith(".npz")) == [
        "processed_fn0.5.npz", "processed_fn1.npz"]
    assert not np.array_equal(a.features, b.features)
    assert_same_dataset(b, jdatasets.load_dataset("walmart-trips", root=str(tmp_path),
                                                  feature_noise=0.5))


def test_reads_the_tracked_zoo_cache():
    """The repository's ``zoo/processed.npz`` is read as it is (and not
    rewritten)."""
    path = os.path.join(FIXTURE_ROOT, "zoo", "processed.npz")
    before = os.stat(path).st_mtime_ns
    got = datasets.load_dataset("zoo", root=FIXTURE_ROOT)
    assert os.stat(path).st_mtime_ns == before
    z = np.load(path)
    np.testing.assert_array_equal(got.hg.h_indices, z["h_indices"])
    np.testing.assert_array_equal(got.features, z["features"])
    assert_same_dataset(got, jdatasets.load_dataset("zoo", root=FIXTURE_ROOT))


def test_missing_and_unknown(tmp_path):
    with pytest.raises(datasets.DatasetNotAvailable, match="download nothing"):
        datasets.load_dataset("pubmed", root=str(tmp_path))
    assert issubclass(datasets.DatasetNotAvailable, FileNotFoundError)
    with pytest.raises(ValueError, match="unknown dataset"):
        datasets.load_dataset("nope", root=str(tmp_path))
    assert datasets.EXISTING_DATASETS == jdatasets.EXISTING_DATASETS
