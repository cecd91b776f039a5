"""The scale drivers of the port (``hypergef_tpu_torch/experiments/``:
clustered_e2e, scale_aligned, dense_shard_scale, scale_projection,
scale_serialized, minibatch_scale, weak_scaling, halo_overlap), their shared
generators and link model (``scale_common.py``) and the taint walk
(``utils/introspect.py``) against the JAX package's, on the CPU.

* Each generator gives the JAX driver's graph bit for bit.
* The ``V5E_ICI`` link terms and ``weak_scaling.analyze`` equal JAX's own
  expressions and function bit for bit at JAX's constants; the NVLink 4
  model takes a card's busiest send or receive.
* Each driver keeps its twin's tables, CSV header and flags (read from the
  JAX driver's source by ``ast``).
* Each driver runs end to end with ``--device cpu`` at small sizes (the
  JAX smoke settings of ``tests/test_experiments.py`` where it has them)
  and raises with ``--device cuda`` where there is no card.
* The taint walk finds the halo interior independent of the exchange: the
  interior V→E among the independent outputs, and every independent output
  unchanged when the received rows are perturbed.
"""

import ast
import importlib
import inspect
import math
import sys
import types
from pathlib import Path

import numpy as np
import pytest
import torch

from hypergef_tpu.data import synthetic as jsyn
from hypergef_tpu.sparse.reorder import apply_vertex_order as japply_vertex_order

from hypergef_tpu_torch.data.synthetic import community_hypergraph
from hypergef_tpu_torch.experiments import (
    clustered_e2e, dense_shard_scale, halo_overlap, minibatch_scale, scale_aligned,
    scale_common, scale_projection, scale_serialized, weak_scaling,
)
from hypergef_tpu_torch.sparse.hypergraph import Hypergraph

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO / "experiments"))

DRIVERS = {"clustered_e2e": clustered_e2e, "scale_aligned": scale_aligned,
           "dense_shard_scale": dense_shard_scale, "scale_projection": scale_projection,
           "scale_serialized": scale_serialized, "minibatch_scale": minibatch_scale,
           "weak_scaling": weak_scaling, "halo_overlap": halo_overlap}
# each driver's run on the CPU: the JAX smoke settings where they exist
# (tests/test_experiments.py:51-60, 128-140), else a small graph
CPU_RUNS = {
    "clustered_e2e": ["--nodes", "3000", "--edges", "1500", "--comm", "24", "--iters", "2",
                      "--epochs", "20"],
    "scale_aligned": ["--configs", "tiny", "--iters", "2"],
    "dense_shard_scale": ["--nodes", "3000", "--edges", "1500", "--comm", "24"],
    "scale_projection": ["--sizes", "4000:2000:10,8000:4000:20"],
    "scale_serialized": ["--nodes", "4000", "--edges", "2000", "--comm", "10", "--shards", "2",
                         "--iters", "2", "--epoch"],
    "minibatch_scale": ["--nodes", "20000", "--edges", "15000", "--batch-edges", "1024",
                        "--eval-nodes", "2000"],
    "weak_scaling": ["--shards", "1,2", "--nnz-per-shard", "5000", "--iters", "2"],
    "halo_overlap": ["--shards", "2", "--nnz-per-shard", "5000", "--iters", "2"],
}
TINY_ALIGNED = dict(n=4000, e=4000, comm=16, avg=4.3, noise=0.01, ref_us=12.484,
                    also_tree=True)



@pytest.fixture(autouse=True)
def one_thread():
    """The port's CPU work on one thread: the suite runs six workers on
    the host's cores, and the drivers' many small ops stall on
    oversubscribed intra-op threads (this file took minutes there, seconds
    alone)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

def _jax_driver(name):
    return importlib.import_module(f"experiments.{name}")


def _port_hg(jhg):
    return Hypergraph(num_nodes=jhg.num_nodes, num_edges=jhg.num_edges,
                      h_indptr=np.asarray(jhg.h_indptr), h_indices=np.asarray(jhg.h_indices),
                      ht_indptr=np.asarray(jhg.ht_indptr),
                      ht_indices=np.asarray(jhg.ht_indices), name=jhg.name)


def _same_csr(a, b):
    assert (a.num_nodes, a.num_edges) == (b.num_nodes, b.num_edges)
    for f in ("h_indptr", "h_indices", "ht_indptr", "ht_indices"):
        np.testing.assert_array_equal(np.asarray(getattr(a, f)), np.asarray(getattr(b, f)))


def _tree(module):
    return ast.parse(inspect.getsource(module))


def _func(module, name="main"):
    (fn,) = [n for n in _tree(module).body if isinstance(n, ast.FunctionDef) and n.name == name]
    return fn


def _jax_expr(module, target, fn="main"):
    """The source of the value assigned to ``target`` in a JAX driver's
    function."""
    for node in ast.walk(_func(module, fn)):
        if isinstance(node, ast.Assign) and any(
                isinstance(t, ast.Name) and t.id == target for t in node.targets):
            return ast.unparse(node.value)
    raise KeyError(target)


def _strings(module, fn="main"):
    return {n.value for n in ast.walk(_func(module, fn))
            if isinstance(n, ast.Constant) and isinstance(n.value, str)}


def _flags(module):
    """{flag: default} of every ``add_argument`` in a module's source."""
    out = {}
    for node in ast.walk(_tree(module)):
        if (isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute)
                and node.func.attr == "add_argument" and node.args
                and isinstance(node.args[0], ast.Constant)):
            kw = {k.arg: k.value for k in node.keywords}
            default = kw.get("default")
            try:
                default = ast.literal_eval(default) if default is not None else None
            except ValueError:
                default = ast.unparse(default)
            if isinstance(kw.get("action"), ast.Constant):
                default = kw["action"].value
            out[node.args[0].value] = default
    return out


# ------------------------------------------------------------------ graphs


@pytest.mark.parametrize("args", [(4000, 2000, 10, 10.0, 0.01, 0),
                                  (19717, 19717, 80, 4.3, 0.01, 0)])
def test_big_sbm_is_jax_draw_for_draw(args):
    _same_csr(scale_common.big_sbm(*args), _jax_driver("scale_aligned").big_sbm(*args))


def test_big_homophilic_and_features_are_jax_draw_for_draw():
    jdrv = _jax_driver("minibatch_scale")
    hg, y = scale_common.big_homophilic(3000, 2000, 8, 7.0, 0.05, seed=5)
    jhg, jy = jdrv.big_homophilic(3000, 2000, 8, 7.0, 0.05, seed=5)
    _same_csr(hg, jhg)
    np.testing.assert_array_equal(y, jy)
    np.testing.assert_array_equal(scale_common.class_features(y, 16, 4.0, seed=6),
                                  jdrv.class_features(jy, 16, 4.0, seed=6))


@pytest.mark.parametrize("n_edges", [500, 1000])
def test_clustered_hypergraph_is_jax_draw_for_draw(n_edges):
    _same_csr(scale_common.clustered_hypergraph(2 * n_edges, n_edges, 10.0, seed=0),
              _jax_driver("weak_scaling").clustered_hypergraph(2 * n_edges, n_edges, 10.0,
                                                               seed=0))


@pytest.mark.parametrize("args", [(3000, 1500, 24, 12, 0.02, 0), (6000, 3000, 24, 12, 0.02, 0)])
def test_community_hypergraph_is_clustered_bench_draw_for_draw(args):
    """clustered_e2e's and dense_shard_scale's generator
    (``clustered_bench.py:30``), and each driver's own pipeline after it."""
    jhg = _jax_driver("clustered_bench").community_hypergraph(*args)
    hg = community_hypergraph(*args)
    _same_csr(hg, jhg)
    _same_csr(scale_common.sorted_edges(hg),
              japply_vertex_order(jhg, np.arange(jhg.num_nodes), sort_edges=True)[0])
    perm = np.random.default_rng(7).permutation(jhg.num_nodes)
    _same_csr(dense_shard_scale.shuffled_sbm(*args[:3]),
              japply_vertex_order(jhg, perm, sort_edges=False)[0])


def test_clustered_e2e_problem_is_jax():
    """The graph, features, labels and split of ``clustered_e2e.py:43-56``:
    JAX's own lines run on JAX's graph."""
    from hypergef_tpu.train import rand_train_test_idx

    n, e, comm = 3000, 1500, 24
    jhg = _jax_driver("clustered_bench").community_hypergraph(n, e, comm, 12, 0.02, 0)
    jhg, _ = japply_vertex_order(jhg, np.arange(jhg.num_nodes), sort_edges=True)
    ns = {"np": np, "n": n, "comm": comm, "f": 32}
    src = inspect.getsource(_jax_driver("clustered_e2e").main).splitlines()
    start = [i for i, ln in enumerate(src) if "rng = np.random.default_rng(1)" in ln][0]
    exec("\n".join(ln.strip() for ln in src[start:start + 8] if ln.strip()
                   and not ln.strip().startswith("#") and "split" not in ln), ns)
    hg, x, y, split = clustered_e2e.problem(n, e, comm)
    _same_csr(hg, jhg)
    np.testing.assert_array_equal(x, ns["x"])
    np.testing.assert_array_equal(y, ns["y"])
    jsplit = rand_train_test_idx(ns["y"], seed=2)
    for k in ("train", "valid", "test"):
        np.testing.assert_array_equal(np.asarray(split[k]), np.asarray(jsplit[k]))


# -------------------------------------------------------------- link model


@pytest.fixture(scope="module")
def halo_points():
    """JAX's and the port's analyze on the weak-scaling smoke graphs."""
    jdrv = _jax_driver("weak_scaling")
    out = []
    for kind in weak_scaling.KINDS:
        for d in (2, 4):
            n_edges = 5000 * d // 10
            if kind == "random":
                jhg = jsyn.random_hypergraph(2 * n_edges, n_edges, avg_edge_size=10.0, seed=0,
                                             name=f"ws{d}")
            else:
                jhg = jdrv.clustered_hypergraph(2 * n_edges, n_edges, 10.0, seed=0)
            hg = weak_scaling.graph(kind, d, 5000)
            _same_csr(hg, jhg)
            out.append((kind, d, hg, jhg, jdrv.analyze(jhg, d, 32, 45.0, 16.0)))
    return out


def test_analyze_is_jax_bit_for_bit_at_v5e(halo_points):
    for kind, d, hg, _, (jplan, want) in halo_points:
        plan, got = weak_scaling.analyze(hg, d, 32, scale_common.V5E_ICI,
                                         scale_common.V5E_NS_PER_NNZ)
        assert got == want, (kind, d)  # every float, exactly
        np.testing.assert_array_equal(plan.send_mask, jplan.send_mask)
        np.testing.assert_array_equal(plan.halo_mask, jplan.halo_mask)


def test_v5e_terms_are_the_jax_drivers_expressions(halo_points):
    """Each V5E_ICI term against the JAX driver's own expression, evaluated
    on the same inputs (``dense_shard_scale.py:46-47``,
    ``scale_serialized.py:188-190``, ``scale_projection.py:127``,
    ``halo_overlap.py:95-96``)."""
    link = scale_common.V5E_ICI
    assert (link.gbps, link.pairwise) == (45.0, True)
    ring = _jax_driver("dense_shard_scale").ring_allreduce_us
    for nbytes, d in ((60_000 * 32 * 4, 2), (60_000 * 32 * 4, 8), (12345677, 3)):
        assert link.ring_allreduce_us(nbytes, d) == ring(nbytes, d)
    args = types.SimpleNamespace(shards=8, ici_gbps=45.0, feat=32)
    stats = {"halo_bytes_real": 123456789, "return_bytes_real": 987654321}
    want = eval(_jax_expr(_jax_driver("scale_serialized"), "t_ici"),
                {"stats": stats, "args": args})
    assert link.exchange_s(stats["halo_bytes_real"], stats["return_bytes_real"], 8) == want
    env = {"comm_frac": 0.08, "n_owned": 2_500_000, "feat": 32, "ici_gbps": 45.0}
    want = eval(_jax_expr(_jax_driver("scale_projection"), "t_a2a"), env)
    assert link.halo_a2a_s(0.08, 2_500_000, 32) == want
    jov = _jax_driver("halo_overlap")
    for _, _, _, _, (plan, _) in halo_points:
        halo_rows = plan.halo_mask.sum(axis=2)
        np.fill_diagonal(halo_rows, 0.0)
        env = {"halo_rows": halo_rows, "args": args, "float": float}
        max_link_b = eval(_jax_expr(jov, "max_link_b"), env)
        assert link.a2a_rows(halo_rows) * 32 * 4 == max_link_b
        env["max_link_b"] = max_link_b
        assert link.a2a_us(max_link_b) == eval(_jax_expr(jov, "t_a2a"), env)


def test_nvlink4_model_takes_the_busiest_card():
    link = scale_common.nvlink4_links()
    assert (link.name, link.gbps, link.pairwise) == ("nvlink4", 450.0, False)
    assert "MODELED nvlink4 450 GB/s" in link.label() and "unverified" in link.label()
    rows = np.array([[0.0, 5.0, 1.0], [2.0, 0.0, 7.0], [1.0, 1.0, 0.0]])
    # card 1 sends 9 rows; card 2 receives 8: the busiest card moves 9
    assert link.a2a_rows(rows) == 9.0
    assert link.a2a_rows(rows, rows.T) == 18.0
    assert scale_common.V5E_ICI.a2a_rows(rows) == 7.0
    assert link.ring_allreduce_us(450e9, 2) == 1e6
    assert scale_common.link_model("nvlink4", 900.0).gbps == 900.0
    assert scale_common.link_model("v5e") is scale_common.V5E_ICI
    assert scale_common.link_model("v5e", 90.0).gbps == 90.0
    with pytest.raises(ValueError, match="--links"):
        scale_common.link_model("pcie")


# ------------------------------------------------------- tables and flags


def test_tables_and_headers_equal_the_twins():
    sa, sp = _jax_driver("scale_aligned"), _jax_driver("scale_projection")
    assert scale_aligned.CONFIGS == sa.CONFIGS
    assert scale_projection.SHARD_SIZES == sp.SHARD_SIZES
    env = {k: ast.literal_eval(_jax_expr(sp, k)) for k in ("comm_frac", "n_owned", "shard_nnz")}
    assert (scale_projection.COMM_FRAC, scale_projection.N_OWNED,
            scale_projection.SHARD_NNZ) == (env["comm_frac"], env["n_owned"], env["shard_nnz"])
    (pair,) = [n for n in ast.walk(_func(sp)) if isinstance(n, ast.Assign)
               and isinstance(n.targets[0], ast.Tuple)
               and [t.id for t in n.targets[0].elts] == ["shards", "feat"]]
    assert ast.literal_eval(pair.value) == (scale_projection.SHARDS, scale_projection.FEAT)
    assert dense_shard_scale.F == _jax_driver("dense_shard_scale").F
    assert dense_shard_scale.HEADER + "\n" in _strings(_jax_driver("dense_shard_scale"))
    for name in ("clustered_e2e", "scale_aligned", "scale_projection", "scale_serialized",
                 "minibatch_scale", "weak_scaling", "halo_overlap"):
        assert DRIVERS[name].HEADER in _strings(_jax_driver(name)), name
    assert clustered_e2e.BACKENDS == ast.literal_eval(
        [ast.unparse(n.iter) for n in ast.walk(_func(_jax_driver("clustered_e2e")))
         if isinstance(n, ast.For)][0])


# flags whose default the port changes: the CSV to the working directory,
# the plan cache off unless asked for, the link rate and the ns figures the
# model's and the card's own unless given
CHANGED_DEFAULTS = {"--out", "--plan-cache", "--ici-gbps", "--ns-per-nnz"}


@pytest.mark.parametrize("name", sorted(DRIVERS))
def test_flags_keep_the_twins(name):
    from hypergef_tpu_torch.experiments import common

    jflags, flags = _flags(_jax_driver(name)), {**_flags(common), **_flags(DRIVERS[name])}
    if "add_link_flags(" in inspect.getsource(DRIVERS[name]):
        flags.update(_flags(scale_common))
    assert set(jflags) <= set(flags), set(jflags) - set(flags)
    for flag, default in jflags.items():
        if flag not in CHANGED_DEFAULTS:
            assert flags[flag] == default, flag
    assert flags["--device"] == "cuda"
    if "--ici-gbps" in jflags or name in ("scale_projection", "dense_shard_scale"):
        assert flags["--links"] == "nvlink4" and flags["--ici-gbps"] is None


# ------------------------------------------------------------ runs on the CPU


def _run(name, tmp_path, monkeypatch, extra=()):
    monkeypatch.chdir(tmp_path)
    if name == "scale_aligned":
        monkeypatch.setitem(scale_aligned.CONFIGS, "tiny", TINY_ALIGNED)
    out = tmp_path / f"{name}.csv"
    res = DRIVERS[name].main([*CPU_RUNS[name], "--device", "cpu", "--out", str(out), *extra])
    lines = out.read_text().splitlines()
    assert lines[0] == "# host clock, cpu"
    return res, lines


def test_clustered_e2e_cpu_run(tmp_path, monkeypatch):
    rows, lines = _run("clustered_e2e", tmp_path, monkeypatch)
    assert "aligned form=xla (plain band products)" in lines[2]
    assert lines[3] == clustered_e2e.HEADER
    assert [ln.split(",")[0] for ln in lines[4:]] == list(clustered_e2e.BACKENDS)
    for r in rows:
        assert r["test_acc"] > 100.0 / clustered_e2e.NCLASS and r["step"] == "eager", r


def test_scale_aligned_cpu_run(tmp_path, monkeypatch):
    rows, lines = _run("scale_aligned", tmp_path, monkeypatch)
    assert [r["backend"] for r in rows] == ["aligned", "tree"]
    for r in rows:
        e = r["error"]
        assert e["ok"] and e["rel_tol"] == (3e-2 if r["backend"] == "aligned" else 1e-3)
    aligned = [ln for ln in lines if ln.startswith("tiny,")][0]
    assert "spill=" in aligned and "form=xla" in aligned and "vs_ref3090=" in aligned


def test_dense_shard_scale_cpu_run(tmp_path, monkeypatch):
    rows, lines = _run("dense_shard_scale", tmp_path, monkeypatch)
    assert "MODELED nvlink4 450 GB/s" in lines[1]
    assert [r["devices"] for r in rows] == [1, 2, 8]
    assert all(r["error"]["ok"] for r in rows)
    assert [ln.split(",")[2] for ln in lines[3:]] == ["1", "2", "8"]
    for r in rows[1:]:
        assert r["psum_us"] == scale_common.nvlink4_links().ring_allreduce_us(
            3000 * dense_shard_scale.F * 4, r["devices"])


def test_scale_projection_cpu_run_at_v5e(tmp_path, monkeypatch):
    res, lines = _run("scale_projection", tmp_path, monkeypatch, ["--links", "v5e"])
    assert len(res["points"]) == 2 and all(p["error"]["ok"] for p in res["points"])
    assert res["t_a2a_s"] == scale_common.V5E_ICI.halo_a2a_s(0.08, 2_500_000, 32)
    measured = [ln for ln in lines if ln.startswith("shard_")]
    assert len(measured) == 4
    assert all("MEASURED on host clock, cpu" in ln and "v5e" not in ln for ln in measured)
    assert [ln.split(",")[0] for ln in lines[3:]][-5:] == [
        "fit_slope", "fit_intercept", "halo_a2a_per_layer", "projected_layer_100M",
        "projected_aggregate_ns_per_nnz"]
    assert "MODELED v5e_ici 45 GB/s" in [ln for ln in lines if ln.startswith("halo_a2a")][0]


def test_scale_serialized_cpu_run(tmp_path, monkeypatch):
    res, lines = _run("scale_serialized", tmp_path, monkeypatch)
    body = "\n".join(lines)
    assert "MEASURED(serialized)" in body
    assert "halo_buffer" in body and "ici_transfer" in body and "MODELED nvlink4" in body
    assert "v5e" not in body
    assert res["finite"] and res["error"]["ok"] and res["local_form"] == "aligned"
    assert abs(res["train_epoch_loss"] - math.log(8)) < 0.5
    assert res["t_link_s"] == scale_common.nvlink4_links().exchange_s(
        res["halo_bytes"], res["return_bytes"], 2)


def test_minibatch_scale_cpu_run(tmp_path, monkeypatch):
    res, lines = _run("minibatch_scale", tmp_path, monkeypatch)
    body = "\n".join(lines)
    assert "full_batch_step,ok,status," in body and res["full_batch"]["ok"]
    assert res["compile_count"] == 1 and res["step"] == "eager"
    assert res["valid_acc"] > 1.0 / 8
    assert [ln.split(",")[0] for ln in lines[3:]] == [
        "graph_nnz", "full_batch_step", "batches", "batches_per_s", "mean_loss_last10",
        "compile_count", "valid_acc", "chance"]


def test_weak_scaling_cpu_run(tmp_path, monkeypatch):
    rows, lines = _run("weak_scaling", tmp_path, monkeypatch)
    body = "\n".join(lines)
    assert "comm_frac" in weak_scaling.HEADER and "max_link_MB" in weak_scaling.HEADER
    assert "clustered,2," in body and "random,2," in body
    assert "MEASURED on host clock, cpu" in body
    for r in rows:
        assert all(e["ok"] for e in r["errors"].values())
        assert r["wall_s"] is None and (r["t_ici_us"] == 0.0) == (r["shards"] == 1)


def test_weak_scaling_given_ns_is_jax_at_v5e(tmp_path, monkeypatch, halo_points):
    """At ``--links v5e --ns-per-nnz 16`` every column but the aligned
    interior's (whose rate is the device's own) is JAX's, exactly."""
    rows, _ = _run("weak_scaling", tmp_path, monkeypatch,
                   ["--links", "v5e", "--ns-per-nnz", "16", "--shards", "2"])
    want = {(k, d): m for k, d, _, _, (_, m) in halo_points if d == 2}
    for r in rows:
        w = dict(want[(r["graph"], 2)])
        del w["t_compute_aligned_us"]
        assert {k: r[k] for k in w} == w


def test_weak_scaling_measures_in_a_gloo_world(tmp_path, monkeypatch):
    rows, lines = _run("weak_scaling", tmp_path, monkeypatch, ["--measure"])
    assert all(r["wall_s"] > 0 for r in rows)
    assert "structural validation only" in "\n".join(lines)


def test_halo_overlap_cpu_run(tmp_path, monkeypatch):
    rows, lines = _run("halo_overlap", tmp_path, monkeypatch)
    assert [(r["graph"], r["shards"]) for r in rows] == [("random", 2), ("clustered", 2)]
    for r in rows:
        assert r["chain_ok"] and r["chain"] and r["output_depends_on_collective"]
        assert r["n_collectives"] == 2 and r["independent_elems"] > 0
        assert r["downstream_elems"] > 0
    assert all(ln.endswith(",True") for ln in lines if ln.startswith(("random,", "clustered,")))


@pytest.mark.parametrize("name", sorted(DRIVERS))
def test_cuda_default_raises_without_a_card(name, tmp_path, monkeypatch):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    monkeypatch.chdir(tmp_path)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        DRIVERS[name].main(["--out", str(tmp_path / "x.csv")])
    assert not (tmp_path / "x.csv").exists()


# ---------------------------------------------------------- the taint walk


@pytest.fixture(scope="module")
def interior_shard():
    """Shard 0 of the clustered smoke graph's 2-shard halo plan (tree
    interior, as halo_overlap plans it), its owned block and a received
    block."""
    from hypergef_tpu_torch.parallel.halo import plan_halo

    hg = weak_scaling.graph("clustered", 2, 5000)
    plan = plan_halo(hg, 2)
    loc = plan.local(0, "cpu")
    rng = np.random.default_rng(3)
    x_blk = torch.as_tensor(rng.normal(size=(plan.n_own, 8)).astype(np.float32))
    halo_in = torch.as_tensor(rng.normal(size=(2, plan.b_cap_h, 8)).astype(np.float32))
    return plan, loc, x_blk, halo_in


def _walked(interior_shard, halo_in):
    from hypergef_tpu_torch.parallel.halo_aggr import shard_compute
    from hypergef_tpu_torch.utils.introspect import TaintWalk

    plan, loc, x_blk, _ = interior_shard
    walk = TaintWalk(sources=[halo_in], keep=True)
    with torch.no_grad(), walk:
        out = shard_compute(plan, loc, x_blk, halo_in)
    return walk, out


def test_taint_walk_finds_the_interior_independent(interior_shard):
    from hypergef_tpu_torch.parallel.exact import apply_stage

    plan, loc, x_blk, halo_in = interior_shard
    assert plan.interior_fraction() > 0.5
    walk, out = _walked(interior_shard, halo_in)
    rep = walk.report(out)
    assert rep["output_depends_on_collective"] and rep["independent_elems"] > 0
    assert rep["downstream_elems"] > 0
    with torch.no_grad():
        xe_int = apply_stage(x_blk, loc.int_tree)
    assert any(t.shape == xe_int.shape and torch.equal(t, xe_int) for t in walk.kept)


def test_independent_outputs_ignore_the_received_rows(interior_shard):
    """The second witness: perturb the received rows, and every output the
    walk called independent is bitwise the same, while the shard's partial
    rows change."""
    halo_in = interior_shard[3]
    walk_a, out_a = _walked(interior_shard, halo_in)
    walk_b, out_b = _walked(interior_shard, halo_in + 1.0)
    assert walk_a.independent_ops == walk_b.independent_ops > 0
    assert len(walk_a.kept) == len(walk_b.kept) > 0
    for a, b in zip(walk_a.kept, walk_b.kept):
        assert torch.equal(a, b)
    assert not torch.equal(out_a, out_b)


def test_walk_needs_a_collective():
    from hypergef_tpu_torch.utils.introspect import collective_overlap_report

    with pytest.raises(ValueError, match="no all_to_all"):
        collective_overlap_report(lambda x: x * 2, torch.ones(3))


@pytest.mark.parametrize("module", ["experiments/scale_common.py", "utils/introspect.py"])
def test_module_imports_nothing_of_jax(module):
    tree = ast.parse((REPO / "hypergef_tpu_torch" / module).read_text())
    names = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names.append("." * node.level + (node.module or ""))
    assert not [n for n in names if n.split(".")[0] in (
        "jax", "jaxlib", "hypergef_tpu", "experiments", "clustered_bench", "scale_aligned",
        "weak_scaling") or n.startswith(".")]
