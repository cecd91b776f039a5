"""The port's tree plans, gather kernel twin and tree routes against JAX.

Same NumPy inputs into ``hypergef_tpu`` and ``hypergef_tpu_torch``, JAX on
the CPU with its Pallas gather kernel in interpret mode, as
tests/test_pallas_sparse.py runs it. Tolerances:

* host tables (ELL chunks, reduction trees, ``choose_ngs``): exact, the
  same NumPy code in both packages;
* the gather (``ell_gather_sum_plain`` vs JAX's two kernel variants):
  rtol = atol = 1e-6, f32 sums of at most ``ngs`` terms;
* the ``tree`` and ``pallas_sparse`` routes and their gradients: 1e-3,
  the f32 gather tolerance of tests/test_fuzz_backends.py:46.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import hypergef_tpu.data.synthetic as jsyn
from hypergef_tpu.ops import fused as jfused
from hypergef_tpu.ops.pallas_sparse import ell_gather_sum as jell_gather_sum
from hypergef_tpu.sparse import planner as jplanner

import hypergef_tpu_torch.data.synthetic as tsyn
from hypergef_tpu_torch.ops import ell_gather, fused, tree
from hypergef_tpu_torch.sparse import planner
from hypergef_tpu_torch.sparse.hypergraph import Hypergraph as THypergraph
from hypergef_tpu_torch.sparse.planner import AggregationPlan

F32_TOL = dict(rtol=1e-3, atol=1e-3)


@pytest.fixture(autouse=True)
def deterministic():
    prev = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    yield
    torch.use_deterministic_algorithms(prev)


@functools.lru_cache(maxsize=None)
def _graphs(case):
    """The graphs of tests/test_pallas_sparse.py:33-36: (JAX, port)."""
    if case == "random":
        return (jsyn.random_hypergraph(120, 80, avg_edge_size=4.0, seed=600),
                tsyn.random_hypergraph(120, 80, avg_edge_size=4.0, seed=600))
    # the powerlaw generator is not ported: the port takes the same CSR
    jhg = jsyn.powerlaw_hypergraph(150, 100, alpha=1.6, seed=601)
    thg = THypergraph(jhg.num_nodes, jhg.num_edges, jhg.h_indptr, jhg.h_indices,
                      jhg.ht_indptr, jhg.ht_indices, name=jhg.name)
    return jhg, thg


GRAPHS = ("random", "powerlaw")


def _assert_same_stage(jst, tst):
    assert (tst.num_inputs, tst.num_segments) == (jst.num_inputs, jst.num_segments)
    assert len(tst.levels) == len(jst.levels)
    for jl, tl in zip(jst.levels, tst.levels):
        for a, b in zip(jl, tl):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
    for name in ("final_idx", "final_mask", "counts"):
        a, b = getattr(jst, name), getattr(tst, name)
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("graph", GRAPHS)
@pytest.mark.parametrize("ngs,pad", [(1, 1), (4, 8), (8, 1), (16, 8)])
def test_build_ell_is_bit_equal(graph, ngs, pad):
    jhg, _ = _graphs(graph)
    for indptr, indices in ((jhg.ht_indptr, jhg.ht_indices), (jhg.h_indptr, jhg.h_indices)):
        want = jplanner.build_ell(indptr, indices, ngs, pad_chunks_to=pad)
        got = planner.build_ell(indptr, indices, ngs, pad_chunks_to=pad)
        for field in want._fields:
            a, b = getattr(want, field), getattr(got, field)
            if isinstance(a, np.ndarray):
                assert a.dtype == b.dtype, field
                np.testing.assert_array_equal(a, b, err_msg=field)
            else:
                assert a == b, field


@pytest.mark.parametrize("graph", GRAPHS)
def test_choose_ngs_and_build_tree_are_bit_equal(graph):
    jhg, thg = _graphs(graph)
    for lens in (jhg.edge_sizes(), jhg.vertex_degrees()):
        assert planner.choose_ngs(lens) == jplanner.choose_ngs(lens)
        assert (planner.choose_ngs(lens, min_ngs=4, max_ngs=64, step=4)
                == jplanner.choose_ngs(lens, min_ngs=4, max_ngs=64, step=4))
    for ngs, fan in ((2, 2), (4, 8), (8, 3)):
        _assert_same_stage(
            jplanner.build_tree(jhg.ht_indptr, jhg.ht_indices, jhg.num_nodes, ngs, fan),
            planner.build_tree(thg.ht_indptr, thg.ht_indices, thg.num_nodes, ngs, fan))
        _assert_same_stage(
            jplanner.build_tree(jhg.h_indptr, jhg.h_indices, jhg.num_edges, ngs, fan),
            planner.build_tree(thg.h_indptr, thg.h_indices, thg.num_edges, ngs, fan))


@pytest.mark.parametrize("graph", GRAPHS)
def test_plan_tree_and_plan_pallas_sparse_are_bit_equal(graph):
    jhg, thg = _graphs(graph)
    for jplan, tplan, form in (
        (jplanner.plan_tree(jhg), planner.plan_tree(thg), "xla"),
        (jplanner.plan_pallas_sparse(jhg, impl="vmem"),
         planner.plan_pallas_sparse(thg, impl="vmem"), "pallas_vmem"),
    ):
        assert (tplan.num_nodes, tplan.num_edges, tplan.form) == (
            jplan.num_nodes, jplan.num_edges, form)
        assert tplan.depth() == jplan.depth()
        _assert_same_stage(jplan.edge_stage, tplan.edge_stage)
        _assert_same_stage(jplan.vertex_stage, tplan.vertex_stage)


@pytest.mark.parametrize("form", ["xla", "pallas_auto"])
def test_device_stages_hold_the_host_tables(form):
    _, thg = _graphs("powerlaw")
    plan = planner.plan_tree(thg) if form == "xla" else planner.plan_pallas_sparse(thg)
    stages = plan.device("cpu")
    assert plan.device(torch.device("cpu")) is stages  # built once per device
    for host, dev in zip((plan.edge_stage, plan.vertex_stage), stages):
        assert len(dev.levels) == len(host.levels)
        for (g, m), lvl in zip(dev.levels, host.levels):
            assert g.dtype == torch.int64 and m.dtype == torch.float32
            np.testing.assert_array_equal(g.numpy(), lvl.gather_idx)
            np.testing.assert_array_equal(m.numpy(), lvl.mask)
        np.testing.assert_array_equal(dev.final_idx.numpy(), host.final_idx)
        np.testing.assert_array_equal(dev.final_mask.numpy()[:, 0], host.final_mask)
        if form == "xla":
            assert dev.gather0 is None
        else:
            assert dev.gather0.gidx.dtype == torch.int32
            np.testing.assert_array_equal(dev.gather0.gidx.numpy(), host.levels[0].gather_idx)
            assert dev.gather0.num_inputs == host.num_inputs


def test_plan_forms_and_tiling_are_checked():
    _, thg = _graphs("random")
    with pytest.raises(ValueError, match="form"):
        planner.plan_pallas_sparse(thg, impl="no_such_impl")
    # tiled level 0 (once refused here): the tables JAX builds, bit for bit
    jhg, _ = _graphs("random")
    tiled = planner.plan_tree(thg, tiled_threshold=10, tile_rows=64)
    jtiled = jplanner.plan_tree(jhg, tiled_threshold=10, tile_rows=64)
    for st, jst in ((tiled.edge_stage, jtiled.edge_stage),
                    (tiled.vertex_stage, jtiled.vertex_stage)):
        assert isinstance(st, planner.TiledStage) and st.form == jst.form == "gather"
        np.testing.assert_array_equal(st.gidx, np.asarray(jst.gidx))
        np.testing.assert_array_equal(st.mask, np.asarray(jst.mask))
        np.testing.assert_array_equal(st.combine.final_idx, np.asarray(jst.combine.final_idx))


@pytest.mark.parametrize("impl", ["vmem", "dma"])
def test_gather_plain_matches_jax_kernel(impl):
    """At tests/test_pallas_sparse.py:21's shapes (C not a multiple of the
    kernel's 256-chunk block)."""
    rng = np.random.default_rng(0)
    n, c, ngs, f = 300, 700, 8, 16
    x = rng.normal(size=(n, f)).astype(np.float32)
    gidx = rng.integers(0, n, size=(c, ngs)).astype(np.int32)
    mask = (rng.random((c, ngs)) > 0.2).astype(np.float32)
    want = np.asarray(jell_gather_sum(jnp.asarray(x), jnp.asarray(gidx), jnp.asarray(mask),
                                      impl=impl, interpret=True))
    xt = torch.as_tensor(x)
    got = ell_gather.ell_gather_sum_plain(xt, torch.as_tensor(gidx).long(), torch.as_tensor(mask))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)
    table = ell_gather.GatherTable(gidx=torch.as_tensor(gidx),
                                   gidx_long=torch.as_tensor(gidx).long(),
                                   mask=torch.as_tensor(mask), num_inputs=n)
    before = ell_gather.launches
    assert torch.equal(ell_gather.ell_gather_sum(xt, table), got)
    assert ell_gather.launches == before  # CPU tensors take the plain version


def test_gather_table_is_checked_once():
    g = torch.tensor([[0, 1], [2, 0]], dtype=torch.int32)
    m = torch.ones((2, 2))
    ell_gather.GatherTable(gidx=g, gidx_long=g.long(), mask=m, num_inputs=3)
    with pytest.raises(ValueError, match=r"\[0, 2\)"):
        ell_gather.GatherTable(gidx=g, gidx_long=g.long(), mask=m, num_inputs=2)
    with pytest.raises(TypeError):
        ell_gather.GatherTable(gidx=g.long(), gidx_long=g.long(), mask=m, num_inputs=3)
    with pytest.raises(ValueError, match="shape"):
        ell_gather.GatherTable(gidx=g, gidx_long=g.long(), mask=m[:1], num_inputs=3)
    table = ell_gather.GatherTable(gidx=g, gidx_long=g.long(), mask=m, num_inputs=3)
    with pytest.raises(RuntimeError, match="autograd"):
        ell_gather.ell_gather_sum(torch.ones((3, 2), requires_grad=True), table)


@functools.lru_cache(maxsize=None)
def _jax_route(graph, aggr, with_wdiag):
    """JAX's pallas_sparse route: output and the gradients w.r.t. x and
    wdiag of ⟨out, cot⟩."""
    jhg, _ = _graphs(graph)
    x, w, cot = _inputs(graph)
    plan = jplanner.plan_pallas_sparse(jhg, impl="vmem")
    hgd = jhg.device_data()

    def f(xv, wv):
        out = jfused.hgnn_aggregate(hgd, xv, wv if with_wdiag else None, aggr, plan=plan,
                                    backend="pallas_sparse")
        return jnp.sum(out * cot), out

    (_, out), (dx, dw) = jax.value_and_grad(f, argnums=(0, 1), has_aux=True)(
        jnp.asarray(x), jnp.asarray(w))
    return np.asarray(out), np.asarray(dx), np.asarray(dw)


def _inputs(graph):
    jhg, _ = _graphs(graph)
    rng = np.random.default_rng(7)
    x = rng.normal(size=(jhg.num_nodes, 5)).astype(np.float32)
    w = rng.uniform(0.5, 1.5, (jhg.num_edges, 1)).astype(np.float32)
    cot = rng.normal(size=(jhg.num_nodes, 5)).astype(np.float32)
    return x, w, cot


@pytest.mark.parametrize("graph", GRAPHS)
@pytest.mark.parametrize("route", ["tree", "pallas_sparse"])
@pytest.mark.parametrize("aggr", ["sum", "mean"])
@pytest.mark.parametrize("with_wdiag", [False, True])
def test_tree_routes_and_gradients_match_jax(graph, route, aggr, with_wdiag):
    _, thg = _graphs(graph)
    x, w, cot = _inputs(graph)
    want_out, want_dx, want_dw = _jax_route(graph, aggr, with_wdiag)
    plan = (AggregationPlan(tree=planner.plan_tree(thg)) if route == "tree"
            else AggregationPlan(pallas_sparse=planner.plan_pallas_sparse(thg)))
    xt = torch.as_tensor(x).requires_grad_(True)
    wt = torch.as_tensor(w).requires_grad_(True)
    before = ell_gather.launches
    out = fused.hgnn_aggregate(thg.device_data("cpu"), xt, wt if with_wdiag else None, aggr,
                               plan=plan, backend=route)
    (out * torch.as_tensor(cot)).sum().backward()
    assert ell_gather.launches == before
    np.testing.assert_allclose(out.detach().numpy(), want_out, **F32_TOL)
    np.testing.assert_allclose(xt.grad.numpy(), want_dx, **F32_TOL)
    if with_wdiag:
        np.testing.assert_allclose(wt.grad.numpy(), want_dw, **F32_TOL)


def test_tree_matvec_saves_no_input_and_its_adjoint_is_the_swap():
    """The backward needs only the stages: nothing is packed for it, and
    ⟨M x, y⟩ = ⟨x, Mᵀ y⟩ with Mᵀ the other stage."""
    _, thg = _graphs("powerlaw")
    e_stage, v_stage = planner.plan_pallas_sparse(thg).device("cpu")
    rng = np.random.default_rng(3)
    x = torch.as_tensor(rng.normal(size=(thg.num_nodes, 3)).astype(np.float32))
    y = torch.as_tensor(rng.normal(size=(thg.num_edges, 3)).astype(np.float32))
    packed = []
    xr = x.clone().requires_grad_(True)
    with torch.autograd.graph.saved_tensors_hooks(lambda t: packed.append(t) or t, lambda t: t):
        mx = tree.tree_matvec(xr, e_stage, v_stage)
    assert packed == []
    (mx * y).sum().backward()
    np.testing.assert_allclose(xr.grad.numpy(), tree.tree_matvec(y, v_stage, e_stage).numpy(),
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(float((mx.detach() * y).sum()),
                               float((x * tree.tree_matvec(y, v_stage, e_stage)).sum()),
                               rtol=1e-4)


def test_tree_routes_need_a_tree_plan():
    _, thg = _graphs("random")
    hgd, x = thg.device_data("cpu"), torch.zeros((thg.num_nodes, 2))
    for route in ("tree", "pallas_sparse"):
        with pytest.raises(ValueError, match="TreePlan"):
            fused.hgnn_aggregate(hgd, x, plan=AggregationPlan.dense_plan(thg, "cpu"),
                                 backend=route)
    # a TreePlan passed directly serves either route
    out = fused.hgnn_aggregate(hgd, x, plan=planner.plan_tree(thg), backend="tree")
    assert tuple(out.shape) == (thg.num_nodes, 2)
