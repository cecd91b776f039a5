"""The port's max first aggregation against the JAX package's, on the CPU.

Same NumPy inputs into ``hypergef_tpu`` and ``hypergef_tpu_torch``; JAX
runs on the CPU, its masked-argmax and arg-sum Pallas kernels in interpret
mode as tests/test_aligned.py runs them. Graphs: the SBM graph of
tests/test_torch_port_aligned.py (2000 × 1600, shuffled, then reordered)
and small random graphs for the tree routes. Tolerances:

* values and int32 ids of the segment max, the tree argmax and the aligned
  masked argmax: bitwise (a max is one of its inputs; both packages break
  ties the same way), with random and with tie-heavy inputs (integers in
  [-2, 2]);
* the masked arg-sum and the segment max's gradient: rtol = atol = 1e-6
  (the same few f32 terms summed in another order);
* the six routes' outputs and gradients: 1e-3, the f32 tolerance of
  tests/test_fuzz_backends.py:46 (JAX's max backward sums by prefix
  differences, whose error grows with nnz; small at these sizes);
* Trainer and ServingModel against JAX's: the bars of
  tests/test_torch_port_train.py.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import hypergef_tpu.data.synthetic as jsyn
from hypergef_tpu.models.zoo import build_model as jbuild_model
from hypergef_tpu.ops import aligned_max as jaligned_max
from hypergef_tpu.ops import fused as jfused
from hypergef_tpu.ops import maxops as jmaxops
from hypergef_tpu.ops import refops as jrefops
from hypergef_tpu.ops import segments as jsegments
from hypergef_tpu.sparse import planner as jplanner
from hypergef_tpu.train import splits as jsplits
from hypergef_tpu.train.trainer import TrainConfig as JTrainConfig
from hypergef_tpu.train.trainer import Trainer as JTrainer

import hypergef_tpu_torch.data.synthetic as tsyn
from hypergef_tpu_torch.models.convert import params_from_flax
from hypergef_tpu_torch.ops import aligned_band, aligned_max, fused, maxops, refops, segments
from hypergef_tpu_torch.serve import ServingModel
from hypergef_tpu_torch.sparse import planner
from hypergef_tpu_torch.sparse.planner import AggregationPlan
from hypergef_tpu_torch.train.trainer import TrainConfig, Trainer, default_plan
from test_torch_port_aligned import _graphs, _layout_plans
from test_torch_port_cuda import aligned_plan

N, E = 2000, 1600
EXACT = dict(rtol=1e-6, atol=1e-6)
F32_TOL = dict(rtol=1e-3, atol=1e-3)
NFEAT, NCLASS = 12, 4

# (n, e, avg_edge_size, seed): small random graphs for the tree routes and
# the segment max, the last with empty edges
RANDOM = {"small": (120, 80, 5.0, 3), "odd": (301, 187, 5.0, 2), "giant_edges": (50, 7, 20.0, 4),
          "empty_edges": (40, 60, 1.5, 1)}


@pytest.fixture(autouse=True)
def deterministic():
    prev = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    yield
    torch.use_deterministic_algorithms(prev)


@functools.lru_cache(maxsize=None)
def _random(name):
    n, e, avg, seed = RANDOM[name]
    return (jsyn.random_hypergraph(n, e, avg_edge_size=avg, seed=seed),
            tsyn.random_hypergraph(n, e, avg_edge_size=avg, seed=seed))


def _x(rows, f, seed, ties=False):
    rng = np.random.default_rng(seed)
    a = rng.integers(-2, 3, size=(rows, f)) if ties else rng.normal(size=(rows, f))
    return a.astype(np.float32)


# ---- segment sums and the record-table oracle ---------------------------


@pytest.mark.parametrize("nnz,segs,f", [(0, 3, 2), (1000, 97, 5), (20000, 311, 3)])
def test_segment_sum_sorted_is_direct(nnz, segs, f):
    """Each segment summed on its own: float64 sums within 1e-5 (f32 sums of
    up to about 100 terms), empty segments 0, repeats bitwise. JAX's
    prefix-difference form (where it takes the input) within 1e-4: its error
    grows with the running prefix (2.1e-5 at nnz 20000 here)."""
    rng = np.random.default_rng(nnz)
    cuts = np.sort(rng.integers(0, nnz + 1, size=segs - 1))
    indptr = np.concatenate([[0], cuts, [nnz]]).astype(np.int64)
    vals = rng.normal(size=(nnz, f)).astype(np.float32)
    got = segments.segment_sum_sorted(torch.as_tensor(vals), torch.as_tensor(indptr))
    want = np.stack([vals[a:b].astype(np.float64).sum(0) for a, b in zip(indptr[:-1], indptr[1:])])
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    assert (got.numpy()[np.diff(indptr) == 0] == 0).all()
    if nnz:  # JAX's prefix form takes no empty array
        jwant = jsegments.segment_sum_sorted(jnp.asarray(vals),
                                             jnp.asarray(indptr.astype(np.int32)))
        np.testing.assert_allclose(got.numpy(), np.asarray(jwant), rtol=1e-4, atol=1e-4)
    again = segments.segment_sum_sorted(torch.as_tensor(vals), torch.as_tensor(indptr))
    assert torch.equal(got, again)


@pytest.mark.parametrize("graph", list(RANDOM))
@pytest.mark.parametrize("ties", [False, True])
def test_segment_max_gather_matches_jax(graph, ties):
    """Forward bitwise; the record-routed gradient against ``jax.vjp``."""
    jhg, thg = _random(graph)
    jd, td = jhg.device_data(), thg.device_data("cpu")
    x = _x(thg.num_nodes, 6, seed=len(graph), ties=ties)
    cot = _x(thg.num_edges, 6, seed=7)
    want, vjp = jax.vjp(lambda v: jrefops.segment_max_gather(v, jd.ht_vertex, jd.ht_segids,
                                                             jhg.num_edges), jnp.asarray(x))
    (want_dx,) = vjp(jnp.asarray(cot))
    xt = torch.as_tensor(x).requires_grad_(True)
    got = refops.segment_max_gather(xt, td.ht_vertex, td.ht_segids, thg.num_edges)
    got.backward(torch.as_tensor(cot))
    assert torch.equal(got.detach(), torch.as_tensor(np.array(want)))
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(want_dx), **EXACT)


@pytest.mark.parametrize("graph", ["small", "giant_edges", "sbm"])
@pytest.mark.parametrize("ties", [False, True])
def test_tree_max_with_arg_matches_jax(graph, ties):
    jhg, thg = _graphs("sorted") if graph == "sbm" else _random(graph)
    jst, tst = jplanner.plan_tree(jhg).device()[0], planner.plan_tree(thg).device("cpu")[0]
    x = _x(thg.num_nodes, 5, seed=3, ties=ties)
    want_y, want_arg = jmaxops.tree_max_with_arg(jnp.asarray(x), jst)
    y, arg = maxops.tree_max_with_arg(torch.as_tensor(x), tst)
    assert torch.equal(y, torch.as_tensor(np.asarray(want_y)))
    assert arg.dtype == torch.int32 and np.asarray(want_arg).dtype == np.int32
    np.testing.assert_array_equal(arg.numpy(), np.asarray(want_arg))


# ---- the masked argmax and arg-sum ---------------------------------------


@pytest.mark.parametrize("layout", ["bucketed", "split", "uniform", "group64"])
@pytest.mark.parametrize("stage", [0, 1], ids=["edge", "vertex"])
@pytest.mark.parametrize("ties", [False, True])
def test_aligned_max_with_arg_is_bitwise_jax(layout, stage, ties):
    """The twin, on the plain and on the kernel form's CPU stages, against
    JAX's interpret-mode masked-argmax kernel: values and int32 ids."""
    jplan, tplan = _layout_plans(layout)
    jst = jplan.device()[stage]
    x = _x(jst.num_inputs, 5, seed=stage, ties=ties)
    want_y, want_arg = (np.asarray(a) for a in jaligned_max.aligned_max_with_arg(
        jnp.asarray(x), jst))
    before = aligned_max.argmax_launches
    for plan in (tplan, dataclasses.replace(tplan, form="pallas_auto")):
        y, arg = aligned_max.aligned_max_with_arg(torch.as_tensor(x), plan.device("cpu")[stage])
        assert arg.dtype == torch.int32 and tuple(y.shape) == want_y.shape
        assert torch.equal(y, torch.as_tensor(want_y))
        assert torch.equal(arg, torch.as_tensor(want_arg))
    assert aligned_max.argmax_launches == before  # the twin on CPU tensors


def _tables(table):
    """Per group of a BandTable: its source ids (window slots, then spill
    slots) and its [G, slots] live mask, read from the directory alone."""
    g_rows, b_rows, n = table.group_rows, table.block_rows, table.num_inputs
    for g, (bo, wo, w, so, ro, sw) in enumerate(table.groups.tolist()):
        ids = torch.cat([torch.arange(b * b_rows, (b + 1) * b_rows)
                         for b in table.win[wo:wo + w].tolist()]
                        + [table.src[ro:ro + sw].long()])
        live = torch.cat([table.band[bo:bo + g_rows * w * b_rows].view(g_rows, w * b_rows),
                          table.spill[so:so + g_rows * sw].view(g_rows, sw)], dim=1) != 0
        yield g, ids, live & (ids < n)[None, :]


def _emulate_argmax(x, table):
    """What the argmax kernel computes, read from its BandTable alone."""
    n, f = x.shape
    s, g_rows = table.num_segments, table.group_rows
    val = x.new_zeros((table.num_groups * g_rows, f))
    arg = torch.full((table.num_groups * g_rows, f), -1, dtype=torch.int64)
    xz = torch.cat([x, x.new_zeros((1, f))])
    for g, ids, live in _tables(table):
        cand = torch.where(live[:, :, None], xz[ids.clamp(max=n)][None], maxops.NEG)
        best = cand.amax(dim=1)  # [G, F]
        hit = live[:, :, None] & (cand == best[:, None, :])
        first = torch.where(hit, ids[None, :, None], 2**31 - 1).amin(dim=1)
        alive = first < 2**31 - 1
        val[g * g_rows:(g + 1) * g_rows] = torch.where(alive, best, 0.0)
        arg[g * g_rows:(g + 1) * g_rows] = torch.where(alive, first, -1)
    return val[:s], arg[:s].to(torch.int32)


def _emulate_argsum(g_in, arg, table):
    """What the arg-sum kernel computes, read from its BandTable alone: each
    row's f32 sum in slot order (window, then spill), from +0 (a running
    sum in NumPy, whose ``cumsum`` adds strictly in order)."""
    n, f = g_in.shape
    g_rows = table.group_rows
    out = g_in.new_zeros((table.num_groups * g_rows, f))
    gz = torch.cat([g_in, g_in.new_zeros((1, f))])
    az = torch.cat([arg.long(), torch.full((1, f), -1)])
    for g, ids, live in _tables(table):
        rows = torch.arange(g * g_rows, (g + 1) * g_rows)
        src = ids.clamp(max=n)
        hit = live[:, :, None] & (az[src][None] == rows[:, None, None])
        terms = torch.where(hit, gz[src][None], 0.0).numpy()  # [G, slots, F]
        terms = np.concatenate([np.zeros((g_rows, 1, f), np.float32), terms], axis=1)
        out[g * g_rows:(g + 1) * g_rows] = torch.as_tensor(
            np.cumsum(terms, axis=1, dtype=np.float32)[:, -1])
    return out[: table.num_segments]


@pytest.mark.parametrize("case", ["bucketed", "split", "uniform", "group64", "block64", "counts",
                                  "past_n", "empty"])
def test_kernel_tables_hold_the_max_stage(case):
    """The directory and flat tables the two kernels read give the twins'
    results, for every layout the card tests run: argmax bitwise (random
    and tie-heavy), arg-sum (uniform transpose stages) within 1e-6."""
    plan = dataclasses.replace(aligned_plan(case), form="pallas_auto")
    e_st, v_st = plan.device("cpu")
    for st in (e_st, v_st):
        for ties in (False, True):
            x = torch.as_tensor(_x(st.num_inputs, 5, seed=1, ties=ties))
            want_val, want_arg = aligned_max.aligned_max_plain(x, st)
            got_val, got_arg = _emulate_argmax(x, st.band)
            assert torch.equal(got_val, want_val) and torch.equal(got_arg, want_arg)
    if isinstance(v_st, planner.AlignedStageDev):
        _, arg = aligned_max.aligned_max_plain(torch.as_tensor(_x(e_st.num_inputs, 5, seed=2)),
                                               e_st)
        g = torch.as_tensor(_x(v_st.num_inputs, 5, seed=3))
        torch.testing.assert_close(_emulate_argsum(g, arg, v_st.band),
                                   aligned_max.aligned_argsum_plain(g, arg, v_st), **EXACT)


def _uniform_stages():
    jplan, tplan = _layout_plans("uniform")
    return jplan.device(), tplan


@pytest.mark.parametrize("layout", ["bucketed", "uniform"])
@pytest.mark.parametrize("form", ["xla", "pallas_auto"])
def test_v2e_max_aligned_grad_matches_jax(layout, form):
    jhg, thg = _graphs("sorted")
    jplan, tplan = _layout_plans(layout)
    jd, td = jhg.device_data(), thg.device_data("cpu")
    x, cot = _x(N, 5, seed=4), _x(E, 5, seed=5)

    def loss(v):
        y = jaligned_max.v2e_max_aligned(v, jplan.device()[0], jd.h_edge, jd.h_segids,
                                         jd.h_indptr)
        return jnp.sum(y * cot), y

    (_, want), want_dx = jax.value_and_grad(loss, has_aux=True)(jnp.asarray(x))
    st = dataclasses.replace(tplan, form=form).device("cpu")[0]
    xt = torch.as_tensor(x).requires_grad_(True)
    y = aligned_max.v2e_max_aligned(xt, st, td.record)
    (y * torch.as_tensor(cot)).sum().backward()
    assert torch.equal(y.detach(), torch.as_tensor(np.asarray(want)))
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(want_dx), **F32_TOL)


@pytest.mark.parametrize("form", ["xla", "pallas_auto"])
def test_aligned_max_matvec_grad_matches_jax(form):
    """The backward over the uniform transpose stage (JAX's arg-sum kernel,
    interpret mode) against ``jax.grad``, and against the CSR-routed
    backward of ``v2e_max_aligned`` on the same stage."""
    (jfe, jfv), tplan = _uniform_stages()
    x, cot = _x(N, 5, seed=6), _x(E, 5, seed=7)
    want_dx = jax.grad(lambda v: jnp.sum(jaligned_max.aligned_max_matvec(v, jfe, jfv) * cot))(
        jnp.asarray(x))
    fe, fv = dataclasses.replace(tplan, form=form).device("cpu")
    xt = torch.as_tensor(x).requires_grad_(True)
    (aligned_max.aligned_max_matvec(xt, fe, fv) * torch.as_tensor(cot)).sum().backward()
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(want_dx), **F32_TOL)
    td = _graphs("sorted")[1].device_data("cpu")
    xc = torch.as_tensor(x).requires_grad_(True)
    (aligned_max.v2e_max_aligned(xc, fe, td.record)
     * torch.as_tensor(cot)).sum().backward()
    torch.testing.assert_close(xt.grad, xc.grad, **EXACT)


def test_aligned_max_matvec_needs_a_uniform_transpose_stage():
    jplan, tplan = _layout_plans("bucketed")
    x, cot = _x(N, 3, seed=8), _x(E, 3, seed=9)
    jfe, jfv = jplan.device()
    with pytest.raises(TypeError, match="uniform"):
        jax.grad(lambda v: jnp.sum(jaligned_max.aligned_max_matvec(v, jfe, jfv) * cot))(
            jnp.asarray(x))
    fe, fv = tplan.device("cpu")
    xt = torch.as_tensor(x).requires_grad_(True)
    y = aligned_max.aligned_max_matvec(xt, fe, fv)  # the forward needs no transpose
    with pytest.raises(TypeError, match="uniform"):
        (y * torch.as_tensor(cot)).sum().backward()


# ---- the routes ------------------------------------------------------------


def _route_plans(route):
    """(graph name, JAX plan, port plan) of a max route. The aligned kernel
    case is JAX's raw aligned TreePlan (the masked-argmax kernel) against
    the port's AggregationPlan(aligned=kernel form); the aligned tree case
    is AggregationPlan(tree, aligned) on both sides."""
    if route.startswith("aligned"):
        jhg, thg = _graphs("sorted")
        jal, tal = _layout_plans("bucketed")
        if route == "aligned_kernel":
            kernel = dataclasses.replace(tal, form="pallas_auto")
            return "sbm", jal, AggregationPlan(aligned=kernel)
        jplan = jplanner.AggregationPlan(tree=jplanner.plan_tree(jhg), aligned=jal)
        return "sbm", jplan, AggregationPlan(tree=planner.plan_tree(thg), aligned=tal)
    jhg, thg = _random("odd")
    if route == "xla":
        return "odd", None, None
    if route in ("dense", "pallas"):
        return "odd", jplanner.plan_aggregation(jhg), default_plan(route, thg, "cpu", "max")
    jtree, ttree = jplanner.plan_tree(jhg), planner.plan_tree(thg)
    if route == "tree":
        return "odd", jplanner.AggregationPlan(tree=jtree), default_plan("tree", thg, "cpu", "max")
    jps = jplanner.plan_pallas_sparse(jhg, impl="vmem")
    return "odd", jplanner.AggregationPlan(tree=jtree, pallas_sparse=jps), AggregationPlan(
        tree=ttree, pallas_sparse=planner.plan_pallas_sparse(thg))


MAX_ROUTES = ["xla", "dense", "pallas", "tree", "pallas_sparse", "aligned_kernel", "aligned_tree"]


@pytest.mark.parametrize("route", MAX_ROUTES)
@pytest.mark.parametrize("with_wdiag", [False, True])
def test_max_route_matches_jax(route, with_wdiag):
    """``hgnn_aggregate(..., "max")`` and its gradients w.r.t. x and wdiag
    against JAX's on the same route, with no kernel launch on the CPU."""
    graph, jplan, tplan = _route_plans(route)
    jhg, thg = _graphs("sorted") if graph == "sbm" else _random(graph)
    backend = "aligned" if route.startswith("aligned") else route
    n, e = thg.num_nodes, thg.num_edges
    x, cot = _x(n, 5, seed=10), _x(n, 5, seed=11)
    w = np.random.default_rng(12).uniform(0.5, 1.5, (e, 1)).astype(np.float32)
    jd = jhg.device_data()

    def f(xv, wv):
        out = jfused.hgnn_aggregate(jd, xv, wv if with_wdiag else None, "max", plan=jplan,
                                    backend=backend)
        return jnp.sum(out * cot), out

    (_, want), (want_dx, want_dw) = jax.value_and_grad(f, argnums=(0, 1), has_aux=True)(
        jnp.asarray(x), jnp.asarray(w))
    xt = torch.as_tensor(x).requires_grad_(True)
    wt = torch.as_tensor(w).requires_grad_(True)
    counts = (aligned_max.argmax_launches, aligned_band.launches)
    out = fused.hgnn_aggregate(thg.device_data("cpu"), xt, wt if with_wdiag else None, "max",
                               plan=tplan, backend=backend)
    (out * torch.as_tensor(cot)).sum().backward()
    assert (aligned_max.argmax_launches, aligned_band.launches) == counts
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want), **F32_TOL)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(want_dx), **F32_TOL)
    if with_wdiag:
        np.testing.assert_allclose(wt.grad.numpy(), np.asarray(want_dw), **F32_TOL)


def test_max_without_a_record_table_raises():
    """Where JAX falls back to the nnz oracle (a plan with no stage plan),
    the port raises and names the plan to pass."""
    jhg, thg = _random("small")
    x = torch.as_tensor(_x(thg.num_nodes, 4, seed=1))
    hgd = thg.device_data("cpu")
    jd = jhg.device_data()
    dense_only = jplanner.AggregationPlan(tree=None,
                                          dense=jplanner.DenseIncidence.from_hypergraph(jhg))
    np.testing.assert_allclose(
        np.asarray(jfused.hgnn_aggregate(jd, jnp.asarray(x.numpy()), None, "max",
                                         plan=dense_only, backend="dense")),
        np.asarray(jrefops.hgnn_aggregate_ref(jd, jnp.asarray(x.numpy()), None, "max")),
        **F32_TOL)  # JAX: the oracle
    for backend in ("dense", "pallas"):
        with pytest.raises(ValueError, match="tree=plan_tree"):
            fused.hgnn_aggregate(hgd, x, None, "max", plan=AggregationPlan.dense_plan(thg, "cpu"),
                                 backend=backend)
    assert default_plan("pallas", thg, "cpu", "max").tree is not None
    assert default_plan("dense", thg, "cpu", "sum").tree is None


# ---- training and serving ----------------------------------------------------


def _problem():
    jhg, thg = _graphs("sorted")
    x, y = jsyn.random_features(N, NFEAT, NCLASS, seed=4)
    return jhg, thg, x, y, jsplits.rand_train_test_idx(y, seed=2)


@pytest.mark.parametrize("form", ["xla", "pallas_auto"])
def test_trainer_max_matches_jax_trainer_on_aligned(form):
    """JAX's Trainer on AggregationPlan(tree, aligned) (tree argmax V→E),
    the port's on its aligned plan (the masked argmax V→E), from the same
    weights, dropout off, 40 epochs."""
    jhg, thg, x, y, split = _problem()
    jcfg = JTrainConfig(model="HGNN", nhid=8, nlayer=2, first_aggr="max", dropout=0.0,
                        input_drop=0.0, epochs=40, warmup=0, seed=0, backend="aligned")
    jplan = jplanner.AggregationPlan(tree=jplanner.plan_tree(jhg),
                                     aligned=jplanner.plan_aligned(jhg))
    jtr = JTrainer(jcfg, jhg, x, y, nclass=NCLASS, plan=jplan)
    params = params_from_flax(jtr.params)
    want = [jtr.fit(split["train"], epochs=1, warmup=0)["final_loss"] for _ in range(40)]
    want_pred = np.asarray(jtr._forward(jtr.params, jtr.x)).argmax(1)

    cfg = TrainConfig(**dataclasses.asdict(jcfg))
    plan = None if form == "xla" else AggregationPlan(
        aligned=dataclasses.replace(planner.plan_aligned(thg), form=form))
    before = (aligned_max.argmax_launches, aligned_max.argsum_launches, aligned_band.launches)
    tr = Trainer(cfg, thg, x, y, nclass=NCLASS, plan=plan, device="cpu", params=params)
    assert tr.plan.aligned.form == form and tr.plan.tree is None
    res = tr.fit(split["train"])
    assert (aligned_max.argmax_launches, aligned_max.argsum_launches,
            aligned_band.launches) == before
    np.testing.assert_allclose(res["losses"][:10], want[:10], rtol=1e-3)
    assert (tr.predict().argmax(1).numpy() == want_pred).mean() >= 0.98


def test_serving_max_matches_jax_on_aligned():
    jhg, thg, x, _, _ = _problem()
    jmodel = jbuild_model("HGNN", NFEAT, 16, NCLASS, nlayer=2, first_aggr="max",
                          backend="aligned")
    jhgd = jhg.device_data()
    jplan = jplanner.plan_aligned(jhg)  # raw aligned TreePlan: the masked-argmax kernel
    params = jmodel.init({"params": jax.random.key(0)}, jnp.asarray(x), jhgd, jplan)["params"]
    want = np.asarray(jmodel.apply({"params": params}, jnp.asarray(x), jhgd, jplan))
    cfg = TrainConfig(model="HGNN", nhid=16, nlayer=2, first_aggr="max", backend="aligned")
    server = ServingModel(cfg, thg, NFEAT, NCLASS, "cpu", params=params_from_flax(params))
    got = server.predict(x).numpy()
    np.testing.assert_allclose(got, want, **F32_TOL)
    assert (got.argmax(1) == want.argmax(1)).mean() >= 0.98
