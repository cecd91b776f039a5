"""The aligned floor model and the experiment drivers of the port
(``hypergef_tpu_torch/sparse/planner.py``, ``hypergef_tpu_torch/experiments/``)
against the JAX package's, on the CPU.

* ``aligned_stage_floor`` / ``aligned_plan_floor`` equal JAX's bit for bit
  at ``V5E_FLOOR_RATES`` on the bucketed and uniform plans of the same
  community-sorted graph, at feat 32 and 128 and feat_bytes 2 and 4; at
  ``card_floor_rates`` the components add up as JAX's test holds them.
* Each driver keeps its twin's tables and CSV header; its generators give
  the twin's graphs, and its picks and depths the twin's.
* Each driver runs end to end with ``--device cpu`` at the JAX drivers'
  own smoke settings (``tests/test_experiments.py``), and raises with
  ``--device cuda`` where there is no card.
* No module of the subpackage imports ``jax``, ``hypergef_tpu`` or the
  repo's ``experiments/``.
"""

import ast
import importlib.util
import inspect
import math
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from hypergef_tpu.data import synthetic as jsyn
from hypergef_tpu.sparse import planner as jplanner

from hypergef_tpu_torch.experiments import (
    auto_matrix, fig6, fig7_9, fig7_9_realistic, fig10, minibatch_bench, serve_bench,
)
from hypergef_tpu_torch.sparse import planner
from hypergef_tpu_torch.sparse.hypergraph import Hypergraph

REPO = Path(__file__).resolve().parents[1]
PORT_EXPERIMENTS = REPO / "hypergef_tpu_torch" / "experiments"
DRIVERS = {"fig7_9_realistic": fig7_9_realistic, "fig7_9": fig7_9, "auto_matrix": auto_matrix,
           "fig10": fig10, "fig6": fig6, "serve_bench": serve_bench,
           "minibatch_bench": minibatch_bench}
# each driver's smallest run on the CPU (the JAX drivers' smoke settings)
CPU_RUNS = {
    "fig7_9_realistic": ["--configs", "zoo", "--iters", "3"],
    "fig7_9": ["--configs", "cora", "--backends", "cumsum,tree", "--iters", "3"],
    "auto_matrix": ["--workloads", "cora"],
    "fig10": ["--config", "cora", "--ngs", "8,16", "--iters", "3"],
    "fig6": ["--datasets", "zoo", "--models", "HGNN,UniGIN,UniGCNII", "--hids", "8",
             "--quick"],
    "serve_bench": ["--workloads", "tiny", "--epochs", "10", "--calls", "8"],
    "minibatch_bench": ["--workloads", "tiny", "--epochs", "20", "--batch-edges", "64",
                        "--eval-every", "10"],
}
TINY = (600, 300, 3, 5.0, 8)  # tests/test_experiments.py's tiny workload



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

def _port_hg(jhg):
    return Hypergraph(num_nodes=jhg.num_nodes, num_edges=jhg.num_edges,
                      h_indptr=np.asarray(jhg.h_indptr), h_indices=np.asarray(jhg.h_indices),
                      ht_indptr=np.asarray(jhg.ht_indptr),
                      ht_indices=np.asarray(jhg.ht_indices), name=jhg.name)


def _same_csr(a, b):
    assert (a.num_nodes, a.num_edges) == (b.num_nodes, b.num_edges)
    for f in ("h_indptr", "h_indices", "ht_indptr", "ht_indices"):
        np.testing.assert_array_equal(np.asarray(getattr(a, f)), np.asarray(getattr(b, f)))


def _jax_driver(name):
    """A JAX driver imported in process, as tests/test_experiments.py does."""
    import importlib

    return importlib.import_module(f"experiments.{name}")


def _main_literals(module) -> dict:
    """The literal assignments of a JAX driver's ``main`` (its tables and
    header live there), by name."""
    tree = ast.parse(inspect.getsource(module))
    (main,) = [n for n in tree.body if isinstance(n, ast.FunctionDef) and n.name == "main"]
    out = {}
    for node in ast.walk(main):
        if isinstance(node, ast.Assign) and len(node.targets) == 1 and isinstance(
                node.targets[0], ast.Name):
            try:
                out[node.targets[0].id] = ast.literal_eval(node.value)
            except ValueError:
                pass
    return out


# ---------------------------------------------------------------- floor model


@pytest.fixture(scope="module")
def floor_plans():
    """The community-sorted graph of tests/test_aligned.py (``sorted_hg``)
    and each package's bucketed and uniform aligned plans of it."""
    sys.path.insert(0, str(REPO / "tests"))
    from test_aligned import _community_hg

    jhg = _community_hg(2000, 1600, 25, 5, 0.05, 3)
    hg = _port_hg(jhg)
    return {form: (jplanner.plan_aligned(jhg, form=form), planner.plan_aligned(hg, form=form))
            for form in ("bucketed", "uniform")}


@pytest.mark.parametrize("form", ["bucketed", "uniform"])
@pytest.mark.parametrize("feat", [32, 128])
@pytest.mark.parametrize("feat_bytes", [2, 4])
def test_floor_equals_jax_bit_for_bit(floor_plans, form, feat, feat_bytes):
    jplan, plan = floor_plans[form]
    want = jplanner.aligned_plan_floor(jplan, feat, feat_bytes)
    got = planner.aligned_plan_floor(plan, feat, feat_bytes)
    assert got == want  # every count and float, exactly
    assert planner.aligned_plan_floor(plan, feat, feat_bytes,
                                      rates=planner.V5E_FLOOR_RATES) == want
    for stage in ("edge_stage", "vertex_stage"):
        assert planner.aligned_stage_floor(getattr(plan, stage), feat, feat_bytes) == \
            jplanner.aligned_stage_floor(getattr(jplan, stage), feat, feat_bytes)


@pytest.mark.parametrize("form", ["bucketed", "uniform"])
def test_card_rate_floor_components(floor_plans, form):
    """test_aligned.py:246-249's component identity at the card's rates,
    the table sizes the plan's own, and the rates the data sheet's."""
    _, plan = floor_plans[form]
    for feat in (32, 128):
        rates = planner.card_floor_rates(feat)
        assert rates == (989e12 / (2 * feat), 3.35e12, 0.0)
        fl = planner.aligned_plan_floor(plan, feat, rates=rates)
        assert fl["floor_s"] > 0
        for name in ("edge_stage", "vertex_stage"):
            st, stage = fl[name], getattr(plan, name)
            assert st["floor_s"] == pytest.approx(
                max(st["t_mxu_elems_s"], st["t_hbm_bytes_s"]) + st["t_spill_gather_s"])
            assert st["t_spill_gather_s"] == 0.0
            want = (sum(int(b.b_dense.size) for b in stage.buckets)
                    if isinstance(stage, planner.AlignedStageB) else int(stage.b_dense.size))
            assert st["band_elems"] == want
        # the card's floor is below the v5e rates' (a faster memory, no
        # gather term)
        assert fl["floor_s"] < planner.aligned_plan_floor(plan, feat)["floor_s"]
    with pytest.raises(TypeError, match="not an aligned stage"):
        planner.aligned_stage_floor(planner.plan_tree(_port_hg(
            jsyn.random_hypergraph(50, 20, 3.0, seed=1))).edge_stage, 32)


# ------------------------------------------------------- tables and generators


@pytest.mark.parametrize("name", ["zoo", "cora"])
def test_clustered_at_dims_matches_jax(name):
    jdrv = _jax_driver("fig7_9_realistic")
    n, e, avg = jdrv.SHAPES[name]
    _same_csr(fig7_9_realistic.clustered_at_dims(name, n, e, avg, noise=0.02),
              jdrv.clustered_at_dims(name, n, e, avg, noise=0.02))


def _twin_tables(name):
    """(port's, JAX's) tables and header of a driver."""
    jdrv = _jax_driver(name)
    port = DRIVERS[name]
    if name == "fig7_9_realistic":
        return ({"SHAPES": port.SHAPES, "REF_MS_F32": port.REF_MS_F32, "header": port.HEADER},
                {"SHAPES": jdrv.SHAPES, "REF_MS_F32": jdrv.REF_MS_F32,
                 "header": _main_literals(jdrv)["header"]})
    if name == "fig7_9":
        lit = _main_literals(jdrv)
        return ({"SHAPES": port.SHAPES, "CLUSTERED": port.CLUSTERED,
                 "REF_MS_F32": port.REF_MS_F32},
                {"SHAPES": lit["shapes"], "CLUSTERED": lit["clustered"],
                 "REF_MS_F32": lit["ref_ms_f32"]})
    if name == "fig10":
        return {"SHAPES": port.SHAPES}, {"SHAPES": _main_literals(jdrv)["shapes"]}
    if name == "auto_matrix":
        lit = _main_literals(jdrv)
        return ({"header": port.HEADER, "F": port.F, "NEAR_BEST": port.NEAR_BEST},
                {"header": lit["rows"][0], "F": jdrv.F, "NEAR_BEST": 1.15})
    if name == "fig6":
        return {"SHAPES": port.SHAPES}, {"SHAPES": jdrv.SHAPES}
    return ({"WORKLOADS": port.WORKLOADS, "header": port.HEADER},
            {"WORKLOADS": jdrv.WORKLOADS, "header": _main_literals(jdrv)["header"]})


@pytest.mark.parametrize("name", sorted(DRIVERS))
def test_tables_and_header_equal_the_twins(name):
    port, jax_ = _twin_tables(name)
    assert port == jax_


def test_time_to_band_is_the_twins():
    jdrv = _jax_driver("minibatch_bench")
    dump = [ast.dump(ast.parse(inspect.getsource(m.time_to_band)))
            for m in (minibatch_bench, jdrv)]
    assert dump[0] == dump[1]


@pytest.mark.parametrize("name", ["cora", "20news"])
def test_auto_matrix_pick_is_the_jax_ladders(name):
    jgraphs = dict(g for g, _ in zip(_jax_driver("auto_matrix").workloads(), range(2)))
    hg = auto_matrix.workload(name)
    _same_csr(hg, jgraphs[name])
    pick = planner.plan_aggregation(hg, "cpu").preferred_backend
    assert pick == jplanner.plan_aggregation(jgraphs[name]).preferred_backend


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", REPO / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _jax_realistic(name):
    """JAX's fig7_9_realistic pipeline on a dataset: its generator, the
    raw-order shuffle, the coarsen reorder; the graph and the ladder's
    pick."""
    from hypergef_tpu.sparse.reorder import apply_vertex_order, community_reorder

    jdrv = _jax_driver("fig7_9_realistic")
    n, e, avg = jdrv.SHAPES[name]
    jhg = jdrv.clustered_at_dims(name, n, e, avg, noise=0.02)
    perm = np.random.default_rng(7).permutation(jhg.num_nodes)
    jhg, _ = apply_vertex_order(jhg, perm, sort_edges=False)
    jhg, _ = community_reorder(jhg, method="coarsen")
    return jhg, jplanner.plan_aggregation(jhg).preferred_backend


@pytest.mark.parametrize("name", ["zoo", "cora", "pubmed", "coauthor_dblp", "ModelNet40",
                                  "20newsW100", "Mushroom"])
def test_realistic_pick_is_the_jax_ladders(name):
    """The port's pipeline gives JAX's graph and JAX's pick; chip_smoke.py's
    phase 32 (a) and the card test hold the card's auto column to these
    picks (REALISTIC_PICKS)."""
    jhg, jpick = _jax_realistic(name)
    hg, _, _ = fig7_9_realistic.realistic_graph(name)
    _same_csr(hg, jhg)
    assert planner.plan_aggregation(hg, "cpu").preferred_backend == jpick
    mod = _chip_smoke()
    assert set(mod.REALISTIC_PICKS) == set(mod.DRIVER_REALISTIC) | {"zoo"}
    assert mod.REALISTIC_PICKS[name] == jpick


def test_fig7_9_graphs_are_the_twins():
    for name in ("cora", "zoo"):
        n, e, avg = fig7_9.SHAPES[name]
        _same_csr(fig7_9.graph(name), jsyn.random_hypergraph(n, e, avg_edge_size=avg, seed=0))


# ------------------------------------------------------------ runs on the CPU


def shallow_tuner(monkeypatch):
    """The measured tuner at a depth of 1 (one-call windows, one repeat):
    its CPU times are not what a test checks, only that it picks a route."""
    import functools

    from hypergef_tpu_torch.sparse import autotune
    from hypergef_tpu_torch.utils import timing

    monkeypatch.setattr(autotune, "autotune", functools.partial(autotune.autotune, iters=1))
    monkeypatch.setattr(timing, "per_iter_time",
                        functools.partial(timing.per_iter_time, repeats=1))


def _run(name, tmp_path, monkeypatch, extra=()):
    """``main`` of a driver at its CPU run, writing into ``tmp_path``
    (``common.time_call`` takes one short window on the CPU; the tuner
    runs at a depth of 1)."""
    monkeypatch.chdir(tmp_path)
    shallow_tuner(monkeypatch)
    out = tmp_path / f"{name}.csv"
    argv = [*CPU_RUNS[name], "--device", "cpu", "--out", str(out), *extra]
    if name in ("serve_bench", "minibatch_bench"):
        monkeypatch.setitem(DRIVERS[name].WORKLOADS, "tiny", TINY)
    if name == "serve_bench":
        argv += ["--artifact-dir", str(tmp_path / "art")]
    res = DRIVERS[name].main(argv)
    lines = out.read_text().splitlines()
    assert lines[0] == "# host clock, cpu"
    return res, lines


def test_fig7_9_realistic_runs_as_a_module(tmp_path):
    """``python -m`` on zoo: exit 0, the rows of JAX's smoke test."""
    out = tmp_path / "f.csv"
    env = dict(os.environ, PYTHONPATH=str(REPO))
    r = subprocess.run([sys.executable, "-m", "hypergef_tpu_torch.experiments.fig7_9_realistic",
                        *CPU_RUNS["fig7_9_realistic"], "--device", "cpu", "--out", str(out)],
                       env=env, cwd=tmp_path, capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-2000:]
    body = out.read_text()
    assert body.startswith("# host clock, cpu\n")
    assert "SUMMARY,zoo" in body and "xla" in body
    assert "reorder=" in body and "plan=" in body
    assert fig7_9_realistic.HEADER in body.splitlines()


def test_fig7_9_realistic_holds_routes_to_xla(tmp_path, monkeypatch):
    (res,), lines = _run("fig7_9_realistic", tmp_path, monkeypatch)
    jhg, jpick = _jax_realistic("zoo")
    _same_csr(res["hg"], jhg)
    assert res["auto"] == jpick
    assert set(res["errors"]) == set(res["times_us"]) >= {"xla", res["auto"]}
    for backend, e in res["errors"].items():
        assert e["max_abs_err"] <= e["rel_tol"] * e["max_abs_xla"] and e["ok"], backend
    rows = [ln for ln in lines if ln.startswith("zoo,")]
    assert [r.split(",")[2] for r in rows] == list(res["times_us"])


def test_fig7_9_cpu_run(tmp_path, monkeypatch):
    res, lines = _run("fig7_9", tmp_path, monkeypatch, ["--vs-ref"])
    body = "\n".join(lines)
    assert "cumsum" in body and "tree" in body
    assert set(res["cora"]) == {"cumsum", "tree"}
    assert any(ln.startswith("SUMMARY,cora,") for ln in lines)


def test_fig10_depth_is_jax_plan_tree_depth(tmp_path, monkeypatch):
    res, lines = _run("fig10", tmp_path, monkeypatch)
    jhg = jsyn.random_hypergraph(2708, 2708, avg_edge_size=4.0, seed=0, name="cora")
    for r, ngs in zip(res, (8, 16)):
        want = jplanner.plan_tree(jhg, ngs=ngs).depth()
        assert r["ngs"] == ngs and tuple(r["depth"]) == tuple(want)
        e = r["error"]
        assert e["rel_tol"] == 1e-3 and e["max_abs_err"] <= 1e-3 * e["max_abs_xla"]
    assert [ln.split(",depth=")[0] for ln in lines[1:]] == ["cora,ngs=8", "cora,ngs=16"]


def test_auto_matrix_cpu_run(tmp_path, monkeypatch):
    (res,), lines = _run("auto_matrix", tmp_path, monkeypatch)
    assert lines[1] == auto_matrix.HEADER
    cols = lines[2].split(",")
    assert cols[0] == "cora" and cols[2] == res["auto_pick"]
    assert res["best_fixed"] in res["times_us"] and cols[4] == res["best_fixed"]
    assert cols[-1] in ("True", "False")
    routes = set(auto_matrix.applicable_backends(res["plan"]))
    assert set(res["times_us"]) == set(res["errors"]) == routes
    for backend, e in res["errors"].items():
        assert e["rel_tol"] == (3e-2 if backend in ("precomp", "dense", "aligned") else 1e-3)
        assert e["max_abs_err"] <= e["rel_tol"] * e["max_abs_xla"], backend


def test_fig6_cpu_run_has_no_failed_row(tmp_path, monkeypatch, capsys):
    res, lines = _run("fig6", tmp_path, monkeypatch)
    assert "FAILED" not in capsys.readouterr().out
    assert [r["model"] for r in res] == ["HGNN", "UniGIN", "UniGCNII"]
    for r, ln in zip(res, lines[1:]):
        assert "failed" not in r and r["src"] == "synthetic"
        assert ln.startswith(f"auto,{r['model']},zoo(synthetic),nhid=8,")
        assert all(math.isfinite(float(v)) for v in ln.split(",")[-3:])


def test_serve_bench_cpu_run(tmp_path, monkeypatch):
    (res,), lines = _run("serve_bench", tmp_path, monkeypatch)
    assert lines[1] == serve_bench.HEADER
    cols = [ln for ln in lines if ln.startswith("tiny,")][0].split(",")
    assert float(cols[5]) > 0          # artifact_mb
    assert float(cols[8]) > 0          # warm_ms_median
    assert float(cols[12]) > 0         # dev_us_forward
    assert float(cols[-1]) < 1e-4      # parity_max_abs
    assert res["parity_max_abs"] < 1e-4


def test_minibatch_bench_cpu_run(tmp_path, monkeypatch):
    res, lines = _run("minibatch_bench", tmp_path, monkeypatch)
    assert lines[1] == minibatch_bench.HEADER
    body = "\n".join(lines)
    assert "tiny,full_batch," in body and "tiny,minibatch_be64," in body
    mb_row = [ln for ln in lines if "minibatch_be64" in ln][0]
    assert int(mb_row.split(",")[-1]) <= 3
    assert res[1]["step"] == "eager"


@pytest.mark.parametrize("fault", ["off_bar", "raises"])
@pytest.mark.parametrize("name", ["fig7_9_realistic", "fig7_9", "auto_matrix", "fig10"])
def test_a_faulty_route_ends_the_run(name, fault, tmp_path, monkeypatch):
    """A route whose output is off its bar against ``xla``, or that raises,
    is reported and ends the run ``SystemExit`` after the sweep (fig10,
    which catches nothing, raises at once): it is never dropped from the
    results silently."""
    from hypergef_tpu_torch.experiments import common

    faulty = "tree"
    route_call = common.route_call

    def broken(hgd, x, plan, backend):
        call = route_call(hgd, x, plan, backend)
        if backend != faulty:
            return call
        if fault == "raises":
            def fail():
                raise RuntimeError("broken route")
            return fail
        return lambda: call() + 1.0

    monkeypatch.setattr(common, "route_call", broken)
    if name == "fig7_9_realistic":
        # zoo's routes are xla, the pick and aligned: break the pick
        faulty = _jax_realistic("zoo")[1]
    if name == "fig10":
        want = (RuntimeError, "broken route") if fault == "raises" else (SystemExit, "ngs")
    else:
        want = (SystemExit, f"/{faulty}")
    with pytest.raises(want[0], match=want[1]):
        _run(name, tmp_path, monkeypatch)


@pytest.mark.parametrize("name", sorted(DRIVERS))
def test_cuda_default_raises_without_a_card(name, tmp_path, monkeypatch):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    monkeypatch.chdir(tmp_path)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        DRIVERS[name].main(["--out", str(tmp_path / "x.csv")])
    assert not (tmp_path / "x.csv").exists()


# -------------------------------------------------------------------- imports


@pytest.mark.parametrize("path", sorted(p.name for p in PORT_EXPERIMENTS.glob("*.py")))
def test_driver_imports_nothing_of_jax(path):
    tree = ast.parse((PORT_EXPERIMENTS / path).read_text())
    names = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names.append("." * node.level + (node.module or ""))
    bad = [n for n in names if n.split(".")[0] in (
        "jax", "jaxlib", "flax", "optax", "hypergef_tpu", "experiments", "clustered_bench")
        or n.startswith(".")]
    assert not bad, f"{path} imports {bad}"
    assert any(n.startswith("hypergef_tpu_torch") for n in names) or path == "__init__.py"
