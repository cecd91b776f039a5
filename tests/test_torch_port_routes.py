"""The ``ell``, ``bsr`` and ``multihot`` routes and their planners against the
JAX package's, on the CPU.

Same NumPy inputs into ``hypergef_tpu`` and ``hypergef_tpu_torch``, on a
small SBM graph (``experiments/clustered_bench.py``'s generator, hyperedges
sorted by median member) and a random one. Bars:

* the host tables of ``plan_bsr`` (RCM and community), ``build_tiled_tree``,
  ``plan_multihot`` (the precomp blocks and the per-stage downgrade),
  ``plan_tiles`` and the tiled ``plan_tree``: bit-equal;
* each route's HGNN sum, mean and max and UniGNN (with and without degree
  scaling), forward and the gradient of ⟨out, cot⟩ w.r.t. x: ``ell`` at
  1e-3·max|JAX| (f32 gathers and sums), ``bsr`` and the multihot forms at
  the bf16 bar 3e-2 (tests/test_fuzz_backends.py:46,54): both round x to
  bf16 before their products, with f32 results, and sum in other orders;
* the ``multihot`` form's bounded runs of tiles against the batched form,
  bitwise (the same products on the CPU);
* the routes' Trainer (no dropout) against the ``xla`` route's Trainer:
  the first five losses within rtol 1e-3 (``ell``) or 3e-2, and a
  ServingModel's answer equal to the Trainer's prediction;
* the plan cache round trip, bit for bit; the CLI's ``--backend`` on each
  name; ``clustered_bench --device cpu`` at a tiny size, with JAX's header.

JAX's references are built once a module and jitted. The tests run under
``torch.use_deterministic_algorithms(True)``.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from experiments.clustered_bench import community_hypergraph as jcommunity_hypergraph
import hypergef_tpu.data.synthetic as jsyn
from hypergef_tpu.ops import fused as jfused
from hypergef_tpu.sparse import bsr as jbsr
from hypergef_tpu.sparse import planner as jplanner
from hypergef_tpu.sparse.reorder import apply_vertex_order as japply_vertex_order

import hypergef_tpu_torch.data.synthetic as tsyn
from hypergef_tpu_torch.experiments.scale_common import sorted_edges
from hypergef_tpu_torch.ops import ell_gather, fused, segment_sum, tree
from hypergef_tpu_torch.serve import ServingModel
from hypergef_tpu_torch.sparse import bsr, plancache, planner
from hypergef_tpu_torch.train.trainer import TrainConfig, Trainer, default_plan, device_plans

SBM = (1200, 800, 10, 8, 0.05, 0)  # community_hypergraph's arguments
RANDOM = (900, 600, 6.0)
F = 6
TOLS = {"ell": 1e-3, "bsr": 3e-2, "bsr_community": 3e-2, "multihot": 3e-2,
        "multihot_batched": 3e-2, "multihot_precomp": 3e-2}


@pytest.fixture(autouse=True)
def deterministic():
    prev = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    yield
    torch.use_deterministic_algorithms(prev)


@pytest.fixture(autouse=True)
def one_thread():
    """The port's CPU work on one thread: the suite runs six workers on the
    host's cores, and the multihot forms' many small ops stall on
    oversubscribed intra-op threads (minutes there, seconds alone)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@functools.lru_cache(maxsize=None)
def _graphs(name="sbm"):
    if name == "sbm":
        jhg, _ = japply_vertex_order(jcommunity_hypergraph(*SBM),
                                     np.arange(SBM[0]), sort_edges=True)
        return jhg, sorted_edges(tsyn.community_hypergraph(*SBM))
    n, e, avg = RANDOM
    return (jsyn.random_hypergraph(n, e, avg_edge_size=avg, seed=1),
            tsyn.random_hypergraph(n, e, avg_edge_size=avg, seed=1))


def _eq(got, want):
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


def _same_tree(st, jst):
    assert len(st.levels) == len(jst.levels)
    for lv, jlv in zip(st.levels, jst.levels):
        _eq(lv.gather_idx, jlv.gather_idx)
        _eq(lv.mask, jlv.mask)
    for f in ("final_idx", "final_mask", "counts"):
        _eq(getattr(st, f), getattr(jst, f))
    assert (st.num_inputs, st.num_segments) == (jst.num_inputs, jst.num_segments)


def _same_stage(st, jst):
    """Tree or tiled host stages, bit for bit, nested combines included."""
    if isinstance(jst, (jplanner.TiledStage, planner.TiledStage)):
        assert isinstance(st, planner.TiledStage)
        for f in ("gidx", "mask", "counts"):
            _eq(getattr(st, f), getattr(jst, f))
        assert (st.tile_rows, st.num_inputs, st.num_segments, st.form) == (
            jst.tile_rows, jst.num_inputs, jst.num_segments, jst.form)
        assert st.fragmentation() == jst.fragmentation()
        return _same_stage(st.combine, jst.combine)
    assert isinstance(st, planner.TreeStage)
    _same_tree(st, jst)


def _same_bsr(p, jp):
    for st, jst in ((p.edge_stage, jp.edge_stage), (p.vertex_stage, jp.vertex_stage)):
        _eq(st.blocks, jst.blocks)
        _eq(st.bcol, jst.bcol)
        _same_tree(st.combine, jst.combine)
        assert (st.num_rows, st.num_cols, st.num_row_blocks, st.num_col_blocks) == (
            jst.num_rows, jst.num_cols, jst.num_row_blocks, jst.num_col_blocks)
    for f in ("vperm", "eperm"):
        assert (getattr(p, f) is None) == (getattr(jp, f) is None)
        if getattr(p, f) is not None:
            _eq(getattr(p, f), getattr(jp, f))
    assert p.fill_fraction() == jp.fill_fraction() and p.nbytes_bf16 == jp.nbytes_bf16


def _same_tiles(p, jp):
    for t, jt in ((p.edge_table, jp.edge_table), (p.vertex_table, jp.vertex_table)):
        for f in ("gather_idx", "mask", "seg_ids", "seg_ptr"):
            _eq(getattr(t, f), getattr(jt, f))
        assert (t.num_chunks, t.num_segments, t.ngs) == (jt.num_chunks, jt.num_segments, jt.ngs)


@pytest.mark.parametrize("graph", ["sbm", "random"])
@pytest.mark.parametrize("method", ["rcm", "community"])
def test_plan_bsr_bit_equal(graph, method):
    jhg, thg = _graphs(graph)
    _same_bsr(bsr.plan_bsr(thg, method=method), jbsr.plan_bsr(jhg, method=method))


def test_plan_bsr_budget_and_no_reorder():
    jhg, thg = _graphs("sbm")
    _same_bsr(bsr.plan_bsr(thg, reorder=False), jbsr.plan_bsr(jhg, reorder=False))
    for plan_bsr, hg in ((bsr.plan_bsr, thg), (jbsr.plan_bsr, jhg)):
        with pytest.raises(MemoryError, match="BSR blocks need"):
            plan_bsr(hg, max_bytes=200_000)


@pytest.mark.parametrize("tile_rows,ngs,combine_form", [
    (128, 8, "tree"), (256, 4, "multihot"), (512, 8, "multihot_precomp"), (100, 3, "tree")])
@pytest.mark.parametrize("side", ["edge", "vertex"])
def test_build_tiled_tree_bit_equal(tile_rows, ngs, combine_form, side):
    jhg, thg = _graphs("sbm")
    args = ((thg.ht_indptr, thg.ht_indices, thg.num_nodes) if side == "edge"
            else (thg.h_indptr, thg.h_indices, thg.num_edges))
    kw = dict(ngs=ngs, tile_rows=tile_rows, form="multihot", combine_form=combine_form,
              combine_tile_rows=64)
    _same_stage(planner.build_tiled_tree(*args, **kw), jplanner.build_tiled_tree(*args, **kw))
    with pytest.raises(MemoryError, match="padding blowup"):
        planner.build_tiled_tree(*args, **{**kw, "pad_limit": 10})
    with pytest.raises(MemoryError, match="padding blowup"):
        jplanner.build_tiled_tree(*args, **{**kw, "pad_limit": 10})


@pytest.mark.parametrize("form", planner.MULTIHOT_FORMS)
@pytest.mark.parametrize("graph", ["sbm", "random"])
def test_plan_multihot_bit_equal(form, graph):
    """The tables, and for the precomp form the host-built multihot blocks
    against JAX's device blocks (their 0/1/2 values are exact in bf16)."""
    jhg, thg = _graphs(graph)
    p, jp = planner.plan_multihot(thg, tile_rows=128, form=form), jplanner.plan_multihot(
        jhg, tile_rows=128, form=form)
    for st, jst, jdev in zip((p.edge_stage, p.vertex_stage), (jp.edge_stage, jp.vertex_stage),
                             jp.device()):
        _same_stage(st, jst)
        devs = p.device("cpu")
        if form == "multihot_precomp":
            want = np.asarray(jdev.m_dense.astype(jnp.float32))
            _eq(planner.multihot_blocks(st), want)
            dev = devs[0] if st is p.edge_stage else devs[1]
            _eq(dev.m_dense.float().numpy(), want)
            _eq(planner.multihot_blocks(st.combine),
                np.asarray(jdev.combine.m_dense.astype(jnp.float32)))


def test_multihot_precomp_downgrades_per_stage():
    """Above the byte budget a precomp stage takes the compare form in both
    packages, its nested combine keeping its own."""
    jhg, thg = _graphs("sbm")
    sizes = {}
    for name, st in (("edge", planner.plan_multihot(thg, 128, form="multihot_precomp")
                      .edge_stage),
                     ("vertex", planner.plan_multihot(thg, 128, form="multihot_precomp")
                      .vertex_stage)):
        sizes[name] = st.gidx.shape[0] * st.gidx.shape[1] * st.tile_rows * 2
    limit = (min(sizes.values()) + max(sizes.values())) // 2
    assert min(sizes.values()) < limit < max(sizes.values())
    p = planner.plan_multihot(thg, 128, form="multihot_precomp", precomp_limit_bytes=limit)
    jp = jplanner.plan_multihot(jhg, 128, form="multihot_precomp", precomp_limit_bytes=limit)
    forms = [st.form for st in (p.edge_stage, p.vertex_stage)]
    assert sorted(forms) == ["multihot", "multihot_precomp"]
    assert p.edge_stage.combine.form == p.vertex_stage.combine.form == "multihot_precomp"
    _same_stage(p.edge_stage, jp.edge_stage)
    _same_stage(p.vertex_stage, jp.vertex_stage)


@pytest.mark.parametrize("graph", ["sbm", "random"])
def test_plan_tiles_bit_equal(graph):
    jhg, thg = _graphs(graph)
    p, jp = planner.plan_tiles(thg), jplanner.plan_tiles(jhg)
    _same_tiles(p, jp)
    assert p.padding_waste() == jp.padding_waste()
    edge, vertex = p.device("cpu")
    assert isinstance(edge.gather, ell_gather.GatherTable)
    assert isinstance(vertex.chunks, segment_sum.SegmentTable)
    np.testing.assert_array_equal(edge.counts.numpy(), np.diff(thg.ht_indptr))


# ---------------------------------------------------------------------- routes
def _jax_plan(route):
    jhg, _ = _graphs("sbm")
    tr = jplanner.plan_tree(jhg)
    if route == "ell":
        return jplanner.plan_aggregation(jhg, with_tile=True)
    if route.startswith("bsr"):
        method = "community" if route == "bsr_community" else "rcm"
        return jplanner.AggregationPlan(tree=tr, bsr=jbsr.plan_bsr(jhg, method=method))
    return jplanner.AggregationPlan(
        tree=tr, multihot=jplanner.plan_multihot(jhg, tile_rows=128, form=route))


@functools.lru_cache(maxsize=None)
def _port_plan(route):
    _, thg = _graphs("sbm")
    tr = planner.plan_tree(thg)
    if route == "ell":
        return planner.plan_aggregation(thg, "cpu", with_tile=True)
    if route.startswith("bsr"):
        method = "community" if route == "bsr_community" else "rcm"
        return planner.AggregationPlan(tree=tr, bsr=bsr.plan_bsr(thg, method=method))
    return planner.AggregationPlan(
        tree=tr, multihot=planner.plan_multihot(thg, tile_rows=128, form=route))


def _backend(route):
    return route.split("_")[0]


def _inputs():
    rng = np.random.default_rng(5)
    n, e = SBM[0], SBM[1]
    return (rng.normal(size=(n, F)).astype(np.float32),
            rng.normal(size=(n, F)).astype(np.float32),
            rng.uniform(0.5, 1.5, (e, 1)).astype(np.float32))


@pytest.fixture(scope="module")
def jax_refs():
    """JAX's output and x gradient of every route case, jitted, built once."""
    jhg, _ = _graphs("sbm")
    hgd = jhg.device_data()
    x, cot, w = _inputs()
    out = {}
    for route in TOLS:
        plan, b = _jax_plan(route), _backend(route)
        for kind in ("sum", "mean", "max", "uni", "uni_deg"):
            def f(xv, plan=plan, b=b, kind=kind):
                if kind.startswith("uni"):
                    y = jfused.unignn_aggregate(hgd, xv, kind == "uni_deg", plan=plan, backend=b)
                else:
                    y = jfused.hgnn_aggregate(hgd, xv, jnp.asarray(w), kind, plan=plan,
                                              backend=b)
                return jnp.sum(y * cot), y
            (_, y), dx = jax.jit(jax.value_and_grad(f, has_aux=True))(jnp.asarray(x))
            out[route, kind] = (np.asarray(y), np.asarray(dx))
    return out


def _close(got, want, rel):
    np.testing.assert_allclose(got, want, rtol=rel, atol=rel * float(np.abs(want).max()))


@pytest.mark.parametrize("kind", ["sum", "mean", "max", "uni", "uni_deg"])
@pytest.mark.parametrize("route", list(TOLS))
def test_route_and_gradient_match_jax(route, kind, jax_refs):
    _, thg = _graphs("sbm")
    x, cot, w = _inputs()
    hgd, xt = thg.device_data("cpu"), torch.as_tensor(x).requires_grad_(True)
    before = (ell_gather.launches, segment_sum.launches)
    if kind.startswith("uni"):
        out = fused.unignn_aggregate(hgd, xt, kind == "uni_deg", plan=_port_plan(route),
                                     backend=_backend(route))
    else:
        out = fused.hgnn_aggregate(hgd, xt, torch.as_tensor(w), kind, plan=_port_plan(route),
                                   backend=_backend(route))
    (out * torch.as_tensor(cot)).sum().backward()
    assert (ell_gather.launches, segment_sum.launches) == before  # plain twins on the CPU
    want, want_dx = jax_refs[route, kind]
    _close(out.detach().numpy(), want, TOLS[route])
    _close(xt.grad.numpy(), want_dx, TOLS[route])


def test_multihot_runs_of_tiles_equal_the_batched_form(monkeypatch):
    """The ``multihot`` form in runs of two tiles equals ``multihot_batched``
    bit for bit, and the tiled gather form of ``plan_tree`` equals the
    untiled tree at the f32 bar."""
    _, thg = _graphs("sbm")
    x = torch.as_tensor(_inputs()[0])
    st = planner.plan_multihot(thg, tile_rows=128).device("cpu")[0]
    monkeypatch.setattr(tree, "MULTIHOT_CHUNK_ELEMS", 2 * st.gidx.shape[1] * st.tile_rows)
    batched = dataclasses.replace(st, form="multihot_batched")
    assert torch.equal(tree._apply_any(x, st), tree._apply_any(x, batched))
    tiled = planner.plan_tree(thg, tiled_threshold=100, tile_rows=256)
    assert isinstance(tiled.device("cpu")[0].gather0, ell_gather.GatherTable)
    hgd = thg.device_data("cpu")
    _close(fused.hgnn_aggregate(hgd, x, plan=tiled, backend="tree").numpy(),
           fused.hgnn_aggregate(hgd, x, backend="xla").numpy(), 1e-3)


def test_nested_multihot_combine_matches_jax():
    """A compare-form multihot stage nested as the combine (``combine=
    "multihot"``) against JAX's, through the route."""
    jhg, thg = _graphs("random")
    x = np.random.default_rng(3).normal(size=(thg.num_nodes, F)).astype(np.float32)
    jp = jplanner.plan_multihot(jhg, tile_rows=128, combine="multihot")
    p = planner.plan_multihot(thg, tile_rows=128, combine="multihot")
    assert isinstance(p.edge_stage.combine, planner.TiledStage)
    _same_stage(p.edge_stage, jp.edge_stage)
    want = jfused.hgnn_aggregate(jhg.device_data(), jnp.asarray(x), plan=jp, backend="multihot")
    got = fused.hgnn_aggregate(thg.device_data("cpu"), torch.as_tensor(x), plan=p,
                               backend="multihot")
    _close(got.numpy(), np.asarray(want), 3e-2)


def test_missing_plans_raise_and_name_the_plan():
    _, thg = _graphs("sbm")
    hgd, x = thg.device_data("cpu"), torch.as_tensor(_inputs()[0])
    empty = planner.AggregationPlan(tree=planner.plan_tree(thg))
    for backend, builder in (("ell", "plan_tiles"), ("bsr", "plan_bsr"),
                             ("multihot", "plan_multihot")):
        with pytest.raises(ValueError, match=builder):
            fused.hgnn_aggregate(hgd, x, plan=empty, backend=backend)
        with pytest.raises(ValueError, match=builder):
            fused.unignn_aggregate(hgd, x, plan=empty, backend=backend)
    # max over a raw tiled plan: JAX falls back to its oracle, the port raises
    with pytest.raises(ValueError, match="record table"):
        fused.hgnn_aggregate(hgd, x, None, "max", plan=_port_plan("multihot").multihot,
                             backend="multihot")


def test_plan_cache_round_trip(tmp_path):
    """Every new plan class through the cache: tables bit-equal, the same
    output; the ladder's flags are part of the key."""
    _, thg = _graphs("sbm")
    plan = planner.AggregationPlan(
        tree=planner.plan_tree(thg), tile=planner.plan_tiles(thg),
        bsr=bsr.plan_bsr(thg), multihot=planner.plan_multihot(thg, 128,
                                                                form="multihot_precomp"))
    path = plancache.save_plan(plan, str(tmp_path / "p.npz"))
    back = plancache.load_plan(path, "cpu")
    _same_tiles(back.tile, plan.tile)
    _same_bsr(back.bsr, plan.bsr)
    _same_stage(back.multihot.edge_stage, plan.multihot.edge_stage)
    x = torch.as_tensor(_inputs()[0])
    hgd = thg.device_data("cpu")
    for b in ("ell", "bsr", "multihot"):
        assert torch.equal(fused.hgnn_aggregate(hgd, x, plan=back, backend=b),
                           fused.hgnn_aggregate(hgd, x, plan=plan, backend=b)), b
    keys = {plancache.plan_key(thg, "cpu", **{flag: True})
            for flag in ("with_tile", "with_bsr", "with_multihot")}
    assert len(keys | {plancache.plan_key(thg, "cpu")}) == 4
    got = plancache.cached_plan_aggregation(thg, cache_dir=str(tmp_path), device="cpu",
                                            with_tile=True)
    again = plancache.cached_plan_aggregation(thg, cache_dir=str(tmp_path), device="cpu",
                                              with_tile=True)
    assert got.tile is not None and again is not got
    _same_tiles(again.tile, got.tile)


@pytest.mark.parametrize("backend", ["ell", "bsr", "multihot"])
def test_trainer_and_server_on_the_route(backend):
    """``Trainer`` with no plan builds :func:`default_plan`, puts its tables
    on the device at construction and trains as the ``xla`` route does; a
    ``ServingModel`` with no plan answers as its trainer predicts."""
    _, thg = _graphs("sbm")
    rng = np.random.default_rng(7)
    x = rng.normal(size=(thg.num_nodes, 8)).astype(np.float32)
    y = rng.integers(0, 3, thg.num_nodes).astype(np.int64)
    idx = np.arange(0, thg.num_nodes, 2)
    field = {"ell": "tile"}.get(backend, backend)
    plan = default_plan(backend, thg, "cpu")
    assert getattr(plan, field) is not None and plan.tree is not None
    losses = {}
    for b in (backend, "xla"):
        cfg = TrainConfig(backend=b, nhid=8, dropout=0.0, input_drop=0.0, epochs=5, warmup=0)
        tr = Trainer(cfg, thg, x, y, device="cpu")
        losses[b] = tr.fit(idx)["losses"]
        if b == backend:
            sub = getattr(tr.plan, field)
            assert any(p is sub for p in device_plans(tr.plan)) and torch.device("cpu") in sub._device
            server = ServingModel(cfg, thg, 8, 3, "cpu", params=tr.model.state_dict())
            assert torch.equal(server.predict(torch.as_tensor(x)), tr.predict())
    np.testing.assert_allclose(losses[backend], losses["xla"],
                               rtol=1e-3 if backend == "ell" else 3e-2)


@pytest.mark.parametrize("backend", ["ell", "bsr", "multihot"])
def test_cli_backend_runs_the_route(backend, capsys):
    """``--backend`` takes each of the three names and trains on that route."""
    from hypergef_tpu_torch.train import cli

    res = cli.main(["--synthetic", "random", "--backend", backend, "--n", "200", "--e", "120",
                    "--feat", "8", "--classes", "3", "--nhid", "8", "--epochs", "4",
                    "--platform", "cpu"])
    assert res["route"] == backend and np.isfinite(res["final_loss"])
    assert f"backend {backend} (route {backend})" in capsys.readouterr().out


def test_clustered_bench_cpu_run(tmp_path):
    """The driver end to end on the CPU at a tiny size: JAX's header and
    comment row, every candidate of JAX's list timed and within its bar of
    ``xla``, and a summary a graph naming the ladder's pick."""
    import pathlib

    from hypergef_tpu_torch.experiments import clustered_bench

    out = tmp_path / "c.csv"
    rows = clustered_bench.main(["--device", "cpu", "--n", "1200", "--e", "800", "--comm", "10",
                                 "--feat", "4", "--iters", "1", "--out", str(out)])
    lines = out.read_text().splitlines()
    jax_src = (pathlib.Path(__file__).resolve().parents[1] / "experiments"
               / "clustered_bench.py").read_text()
    assert lines[0] == "# host clock, cpu" and lines[1].startswith("# clustered backend shootout")
    assert lines[2] == clustered_bench.HEADER and f'"{clustered_bench.HEADER}"' in jax_src
    timed = [r for r in rows if "summary" not in r]
    assert all(r["ok"] for r in timed)
    for g in ("sbm", "random"):
        mine = [r for r in timed if r["graph"] == g]
        assert [r["backend"] for r in mine][:3] == ["cumsum", "tree", "bsr"]
        assert sum(r["backend"] == "multihot" for r in mine) == 6
        assert all(r["device_mb"] > 0 and r["plan_s"] >= 0 for r in mine)
    picks = {r["graph"]: r["ladder_pick"] for r in rows if "summary" in r}
    assert set(picks) == {"sbm", "random"}
