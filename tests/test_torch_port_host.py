"""The port's host layer against the JAX package's, bit for bit.

Same NumPy inputs into ``hypergef_tpu`` and ``hypergef_tpu_torch``; every
array must be equal exactly (tolerance 0): the host code is the same NumPy
arithmetic in both packages.
"""

import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import hypergef_tpu.data.synthetic as jsyn
from hypergef_tpu.sparse.hypergraph import Hypergraph as JHypergraph
from hypergef_tpu.sparse.planner import DenseIncidence as JDenseIncidence

import hypergef_tpu_torch.data.synthetic as tsyn
from hypergef_tpu_torch.sparse.hypergraph import Hypergraph as THypergraph
from hypergef_tpu_torch.sparse.planner import AggregationPlan, DenseIncidence

REPO = Path(__file__).resolve().parents[1]

HOST_FIELDS = ("h_indptr", "h_indices", "ht_indptr", "ht_indices", "degV", "degE", "degD")


@pytest.fixture(autouse=True)
def deterministic():
    prev = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    yield
    torch.use_deterministic_algorithms(prev)


def assert_same_host(jhg, thg):
    assert (thg.num_nodes, thg.num_edges, thg.nnz, thg.name) == (
        jhg.num_nodes, jhg.num_edges, jhg.nnz, jhg.name)
    for field in HOST_FIELDS:
        a, b = getattr(jhg, field), getattr(thg, field)
        assert a.dtype == b.dtype and a.shape == b.shape, field
        np.testing.assert_array_equal(b, a, err_msg=field)
    np.testing.assert_array_equal(thg.edge_sizes(), jhg.edge_sizes())
    np.testing.assert_array_equal(thg.vertex_degrees(), jhg.vertex_degrees())


def _coo(seed):
    """Duplicates, isolated vertices (ids ≥ 40) and empty edges (ids ≥ 25)."""
    rng = np.random.default_rng(seed)
    v = rng.integers(0, 40, size=200)
    e = rng.integers(0, 25, size=200)
    return v, e


@pytest.mark.parametrize("dedup", [True, False])
def test_from_coo_bit_equal(dedup):
    v, e = _coo(0)
    kw = dict(num_nodes=47, num_edges=31, name="coo", dedup=dedup)
    assert_same_host(JHypergraph.from_coo(v, e, **kw), THypergraph.from_coo(v, e, **kw))


@pytest.mark.parametrize("compact", [True, False])
def test_from_edge_index_bit_equal(compact):
    n = 30
    rng = np.random.default_rng(1)
    v = rng.integers(0, n, size=90)
    e = rng.choice([0, 2, 5, 9, 14], size=90) + n  # gappy hyperedge ids
    e[0] = n
    # the E→V half starts at the first column whose row 0 equals num_nodes
    order = np.argsort(e, kind="stable")
    ei = np.stack([np.concatenate([v, e[order]]), np.concatenate([e, v[order]])])
    kw = dict(num_nodes=n, name="ei", compact=compact)
    assert_same_host(JHypergraph.from_edge_index(ei, **kw), THypergraph.from_edge_index(ei, **kw))


def test_from_scipy_and_to_scipy_bit_equal():
    v, e = _coo(2)
    jhg = JHypergraph.from_coo(v, e, num_nodes=47, num_edges=31)
    thg = THypergraph.from_scipy(jhg.to_scipy())
    assert_same_host(JHypergraph.from_scipy(jhg.to_scipy()), thg)
    a, b = jhg.to_scipy(), thg.to_scipy()
    assert a.dtype == b.dtype and a.shape == b.shape
    np.testing.assert_array_equal(b.toarray(), a.toarray())


@pytest.mark.parametrize("device", ["cpu"])
def test_device_data_bit_equal(device):
    v, e = _coo(3)
    jhg = JHypergraph.from_coo(v, e, num_nodes=47, num_edges=31)
    thg = THypergraph.from_coo(v, e, num_nodes=47, num_edges=31)
    jd, td = jhg.device_data(), thg.device_data(device)
    assert td is thg.device_data(device)  # cached per device
    assert (td.num_nodes, td.num_edges) == (jd.num_nodes, jd.num_edges)
    for field in ("ht_vertex", "ht_segids", "ht_indptr", "h_edge", "h_segids", "h_indptr"):
        t = getattr(td, field)
        assert t.dtype == torch.int64 and t.device.type == device, field
        np.testing.assert_array_equal(t.numpy(), np.asarray(getattr(jd, field)), err_msg=field)
    for field, rows in (("degV", 47), ("degE", 31)):
        t = getattr(td, field)
        assert t.dtype == torch.float32 and tuple(t.shape) == (rows, 1), field
        np.testing.assert_array_equal(t.numpy(), np.asarray(getattr(jd, field)), err_msg=field)


@pytest.mark.parametrize(
    "n,e,avg,seed", [(120, 80, 5.0, 3), (301, 187, 5.0, 2), (50, 7, 20.0, 4), (16, 3, 40.0, 0)]
)
def test_random_hypergraph_bit_equal(n, e, avg, seed):
    assert_same_host(jsyn.random_hypergraph(n, e, avg_edge_size=avg, seed=seed),
                     tsyn.random_hypergraph(n, e, avg_edge_size=avg, seed=seed))


def test_homophilic_hypergraph_and_features_bit_equal():
    jhg, jy = jsyn.homophilic_hypergraph(300, 150, 4, avg_edge_size=5.0, seed=0)
    thg, ty = tsyn.homophilic_hypergraph(300, 150, 4, avg_edge_size=5.0, seed=0)
    assert_same_host(jhg, thg)
    np.testing.assert_array_equal(ty, jy)
    jx, jl = jsyn.random_features(300, 12, 4, seed=5)
    tx, tl = tsyn.random_features(300, 12, 4, seed=5)
    assert tx.dtype == jx.dtype and tl.dtype == jl.dtype
    np.testing.assert_array_equal(tx, jx)
    np.testing.assert_array_equal(tl, jl)


@pytest.mark.parametrize("dedup", [True, False])
def test_dense_incidence_bit_equal(dedup):
    v, e = _coo(4)
    kw = dict(num_nodes=47, num_edges=31, dedup=dedup)
    jd = JDenseIncidence.from_hypergraph(JHypergraph.from_coo(v, e, **kw))
    plan = AggregationPlan.dense_plan(THypergraph.from_coo(v, e, **kw), "cpu")
    td = plan.dense
    assert td.h.dtype == torch.int8 and (td.num_nodes, td.num_edges) == (47, 31)
    want = np.asarray(jd.h)
    assert want.dtype == np.int8
    np.testing.assert_array_equal(td.h.numpy(), want)
    if not dedup:
        assert want.max() > 1  # repeated incidences are counted


def test_dense_incidence_raises_past_127_like_jax():
    v = np.zeros(128, np.int64)
    kw = dict(num_nodes=2, num_edges=1, dedup=False)
    with pytest.raises(MemoryError, match="127"):
        JDenseIncidence.from_hypergraph(JHypergraph.from_coo(v, v, **kw))
    with pytest.raises(MemoryError, match="127"):
        DenseIncidence.from_hypergraph(THypergraph.from_coo(v, v, **kw), "cpu")


def test_port_imports_no_jax():
    code = (
        "import importlib, pkgutil, sys\n"
        "before = set(sys.modules)\n"
        "import hypergef_tpu_torch as p\n"
        "for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        "new = set(sys.modules) - before\n"
        "bad = sorted(k for k in new if k.split('.')[0] in ('jax', 'jaxlib', 'flax', 'hypergef_tpu'))\n"
        "assert not bad, bad\n"
        "print('ok')\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "ok"
