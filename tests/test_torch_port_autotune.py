"""The port's measured autotune (``sparse/autotune.py``) against the JAX
package's, on the CPU.

* The candidates are JAX's less its ``multihot`` forms, on graphs of every
  gate (small, community-sorted, unstructured past the dense gate).
* The tree plans ``_build_plan`` makes are bit-equal to JAX's.
* The sweep is sorted fastest first; its record round-trips through the
  cache and a second call makes no sweep.
* ``autotune_plan`` and ``Trainer(TrainConfig(tune=True))`` run the pick and
  match the dense oracle (3e-2, the bf16 routes' bar).
* A candidate's named refusal (``ValueError`` from its planner) is skipped;
  any other error (a ``RuntimeError``, as a broken kernel raises)
  propagates.
"""

import numpy as np
import pytest
import torch

from hypergef_tpu.sparse import autotune as jautotune
from hypergef_tpu.sparse.hypergraph import Hypergraph as JHypergraph

import hypergef_tpu_torch.data.synthetic as tsyn
from hypergef_tpu_torch.ops import fused, refops
from hypergef_tpu_torch.sparse import autotune
from hypergef_tpu_torch.sparse.reorder import community_reorder
from hypergef_tpu_torch.train.trainer import TrainConfig, Trainer

CPU = torch.device("cpu")


def _jax(hg):
    return JHypergraph(hg.num_nodes, hg.num_edges, hg.h_indptr, hg.h_indices, hg.ht_indptr,
                       hg.ht_indices, hg.name)


GRAPHS = {
    "small": lambda: tsyn.random_hypergraph(200, 120, avg_edge_size=4.0, seed=9),
    "sorted": lambda: community_reorder(tsyn.community_hypergraph(900, 700, 12, 5, 0.05, 7))[0],
    "past_dense_gate": lambda: tsyn.random_hypergraph(9000, 4000, avg_edge_size=3.0, seed=1),
}


@pytest.fixture(autouse=True)
def one_thread():
    """The port's CPU work on one thread: the suite runs six workers on the
    host's cores, and the multihot forms' many small ops stall on
    oversubscribed intra-op threads (minutes there, seconds alone)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def hg():
    return GRAPHS["small"]()


@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_candidates_are_jax_less_multihot(name):
    """The candidates are JAX's, its six multihot forms among them."""
    g = GRAPHS[name]()
    want = jautotune.default_candidates(_jax(g))
    assert sum(c[0] == "multihot" for c in want) == 6
    assert autotune.default_candidates(g) == want


def test_build_plan_trees_bit_equal(hg):
    jhg = _jax(hg)
    for backend, params in [("cumsum", {})] + [("tree", {"ngs": g}) for g in (2, 4, 8, 16, 32)]:
        got = autotune._build_plan(hg, backend, params, CPU)
        want = jautotune._build_plan(jhg, backend, params)
        for st, jst in ((got.edge_stage, want.edge_stage), (got.vertex_stage, want.vertex_stage)):
            assert len(st.levels) == len(jst.levels)
            for lv, jlv in zip(st.levels, jst.levels):
                np.testing.assert_array_equal(lv.gather_idx, np.asarray(jlv.gather_idx))
                np.testing.assert_array_equal(lv.mask, np.asarray(jlv.mask))
            np.testing.assert_array_equal(st.final_idx, np.asarray(jst.final_idx))
    for params in ({}, {"tile_rows": 128, "form": "multihot_precomp"}):
        got = autotune._build_plan(hg, "multihot", params, CPU)
        want = jautotune._build_plan(jhg, "multihot", params)
        for st, jst in ((got.edge_stage, want.edge_stage), (got.vertex_stage, want.vertex_stage)):
            assert st.form == jst.form and st.tile_rows == jst.tile_rows
            np.testing.assert_array_equal(st.gidx, np.asarray(jst.gidx))
            np.testing.assert_array_equal(st.mask, np.asarray(jst.mask))
    got = autotune._build_plan(hg, "bsr", {}, CPU)
    want = jautotune._build_plan(jhg, "bsr", {})
    np.testing.assert_array_equal(got.bsr.edge_stage.blocks, want.bsr.edge_stage.blocks)
    np.testing.assert_array_equal(got.bsr.vperm, want.bsr.vperm)


def test_sweep_sorted_and_cached(hg, tmp_path, monkeypatch):
    res = autotune.sweep(hg, feature_size=4, iters=8, device=CPU)
    assert [r.backend for r in res].count("tree") == 5
    assert len(res) == len(autotune.default_candidates(hg))
    assert all(r.per_iter_s >= 0 for r in res)
    assert res == sorted(res, key=lambda r: r.per_iter_s)
    best = autotune.autotune(hg, feature_size=4, iters=8, cache_dir=str(tmp_path), device=CPU)
    rec = autotune.load_cached(autotune.graph_key(hg, 4, CPU), str(tmp_path))
    assert rec["backend"] == best.backend and rec["device"] == "cpu"
    assert [r["backend"] for r in rec["all"]][0] == best.backend

    def no_sweep(*a, **k):
        raise AssertionError("a cached problem makes no sweep")

    monkeypatch.setattr(autotune, "sweep", no_sweep)
    again = autotune.autotune(hg, feature_size=4, iters=8, cache_dir=str(tmp_path), device=CPU)
    assert (again.backend, again.params) == (best.backend, best.params)


def test_graph_key(hg):
    k = autotune.graph_key(hg, 32, CPU)
    assert k == autotune.graph_key(hg, 32, CPU) and k.startswith("random-")
    assert autotune.graph_key(hg, 64, CPU) != k
    assert autotune.graph_key(tsyn.random_hypergraph(200, 120, 4.0, seed=10), 32, CPU) != k


@pytest.mark.parametrize("pick", ["tree", "dense", "aligned", "cumsum"])
def test_autotune_plan_matches_the_oracle(tmp_path, monkeypatch, pick):
    g = GRAPHS["sorted"]() if pick == "aligned" else GRAPHS["small"]()
    params = {"ngs": 8} if pick == "tree" else {}
    monkeypatch.setattr(autotune, "sweep",
                        lambda *a, **k: [autotune.TuneResult(pick, params, 1e-6)])
    plan = autotune.autotune_plan(g, feature_size=4, cache_dir=str(tmp_path), device=CPU)
    assert plan.preferred_backend == pick
    hgd = g.device_data(CPU)
    x = torch.as_tensor(np.random.default_rng(0).normal(size=(g.num_nodes, 4))
                        .astype(np.float32))
    got = fused.hgnn_aggregate(hgd, x, None, "sum", plan=plan, backend="auto")
    want = refops.hgnn_aggregate_ref(hgd, x, None, "sum")
    torch.testing.assert_close(got, want, rtol=3e-2, atol=3e-2)


def test_trainer_tune(tmp_path, monkeypatch, hg):
    monkeypatch.setenv("HYPERGEF_TORCH_TUNE_DIR", str(tmp_path / "tune"))
    y = np.random.default_rng(1).integers(0, 3, size=hg.num_nodes)
    x = np.random.default_rng(2).normal(size=(hg.num_nodes, 6)).astype(np.float32)
    tr = Trainer(TrainConfig(nhid=8, epochs=3, warmup=0, tune=True), hg, x, y, device="cpu")
    assert tr.plan.preferred_backend in {b for b, _ in autotune.default_candidates(hg)}
    assert np.isfinite(tr.fit(np.arange(100))["losses"]).all()
    rec = autotune.load_cached(autotune.graph_key(hg, 8, CPU))
    assert rec["backend"] == tr.plan.preferred_backend


def test_only_named_refusals_are_skipped(hg, monkeypatch):
    real = autotune._build_plan

    def planner_refuses(g, backend, params, device):
        if backend == "dense":
            raise ValueError("refused")
        if backend == "precomp":
            raise MemoryError("too large")
        return real(g, backend, params, device)

    monkeypatch.setattr(autotune, "_build_plan", planner_refuses)
    res = autotune.sweep(hg, feature_size=4, iters=8, device=CPU)
    assert {r.backend for r in res} == {
        b for b, _ in autotune.default_candidates(hg)} - {"dense", "precomp"}

    def kernel_breaks(g, backend, params, device):
        if backend == "tree" and params["ngs"] == 8:
            raise RuntimeError("CUDA error: an illegal memory access was encountered")
        return real(g, backend, params, device)

    monkeypatch.setattr(autotune, "_build_plan", kernel_breaks)
    with pytest.raises(RuntimeError, match="illegal memory access"):
        autotune.sweep(hg, feature_size=4, iters=8, device=CPU)

    def launch_breaks(*a, **k):
        raise RuntimeError("launch failed")

    monkeypatch.setattr(autotune, "_build_plan", real)
    monkeypatch.setattr(fused, "hgnn_aggregate", launch_breaks)
    with pytest.raises(RuntimeError, match="launch failed"):
        autotune.sweep(hg, feature_size=4, iters=8, device=CPU)
