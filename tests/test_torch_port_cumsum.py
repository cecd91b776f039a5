"""The port's ``cumsum`` route against the JAX package's, on the CPU.

Same NumPy inputs (made from seeds) into ``hypergef_tpu`` and
``hypergef_tpu_torch``. JAX's cumsum takes a prefix sum of the gathered
rows and differences it at the segment boundaries; the port sums each
segment directly. Both are f32 sums of the same terms, so outputs and
``jax.vjp`` gradients are held at 1e-3 of the largest value, the JAX
tests' bar for f32 gather routes (tests/test_fuzz_backends.py:46). Max
first aggregation runs the tree's argmax V→E and cumsum's E→V in both
packages (``fused.py:257-258``).
"""

import functools
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import hypergef_tpu.data.synthetic as jsyn
from hypergef_tpu.ops import fused as jfused
from hypergef_tpu.ops import segments as jsegments
from hypergef_tpu.sparse import planner as jplanner
from hypergef_tpu.train.trainer import TrainConfig as JTrainConfig
from hypergef_tpu.train.trainer import Trainer as JTrainer

import hypergef_tpu_torch.data.synthetic as tsyn
from hypergef_tpu_torch.models.convert import params_from_flax
from hypergef_tpu_torch.ops import fused, segment_sum, segments
from hypergef_tpu_torch.sparse import planner
from hypergef_tpu_torch.train.trainer import TrainConfig, Trainer

TOL = 1e-3
# (n, e, avg_edge_size, seed): a random graph, and one with hyperedges of
# many sizes and empty ones
GRAPHS = {"random": (400, 300, 5.0, 2), "skewed": (300, 500, 2.0, 5)}


@pytest.fixture(autouse=True)
def deterministic():
    prev = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    yield
    torch.use_deterministic_algorithms(prev)


@functools.lru_cache(maxsize=None)
def _graphs(name):
    n, e, avg, seed = GRAPHS[name]
    return (jsyn.random_hypergraph(n, e, avg_edge_size=avg, seed=seed),
            tsyn.random_hypergraph(n, e, avg_edge_size=avg, seed=seed))


def _inputs(name, f=6):
    n, e, _, seed = GRAPHS[name]
    rng = np.random.default_rng(seed + 20)
    return (rng.normal(size=(n, f)).astype(np.float32),
            rng.uniform(0.5, 1.5, (e, 1)).astype(np.float32),
            rng.normal(size=(n, f)).astype(np.float32))


def _close(got, want):
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL * float(np.abs(want).max()))


@pytest.mark.parametrize("name", list(GRAPHS))
@pytest.mark.parametrize("aggr", ["sum", "mean", "max"])
@pytest.mark.parametrize("with_wdiag", [False, True])
def test_hgnn_cumsum_and_gradients_match_jax(name, aggr, with_wdiag):
    jhg, thg = _graphs(name)
    x, w, cot = _inputs(name)
    jplan = jplanner.plan_aggregation(jhg) if aggr == "max" else None
    tplan = planner.AggregationPlan(tree=planner.plan_tree(thg)) if aggr == "max" else None

    def f(xv, wv):
        out = jfused.hgnn_aggregate(jhg.device_data(), xv, wv if with_wdiag else None, aggr,
                                    plan=jplan, backend="cumsum")
        return jnp.sum(out * cot), out

    (_, want), (want_dx, want_dw) = jax.value_and_grad(f, argnums=(0, 1), has_aux=True)(
        jnp.asarray(x), jnp.asarray(w))
    xt, wt = torch.as_tensor(x).requires_grad_(True), torch.as_tensor(w).requires_grad_(True)
    before = segment_sum.launches
    out = fused.hgnn_aggregate(thg.device_data("cpu"), xt, wt if with_wdiag else None, aggr,
                               plan=tplan, backend="cumsum")
    (out * torch.as_tensor(cot)).sum().backward()
    assert segment_sum.launches == before  # the plain version on the CPU
    _close(out.detach().numpy(), np.asarray(want))
    _close(xt.grad.numpy(), np.asarray(want_dx))
    if with_wdiag:
        _close(wt.grad.numpy(), np.asarray(want_dw))


@pytest.mark.parametrize("name", list(GRAPHS))
@pytest.mark.parametrize("use_deg", [False, True])
def test_unignn_cumsum_and_gradient_match_jax(name, use_deg):
    jhg, thg = _graphs(name)
    x, _, cot = _inputs(name)
    out, vjp = jax.vjp(lambda xv: jfused.unignn_aggregate(jhg.device_data(), xv, use_deg,
                                                          backend="cumsum"), jnp.asarray(x))
    (want_dx,) = vjp(jnp.asarray(cot))
    xt = torch.as_tensor(x).requires_grad_(True)
    got = fused.unignn_aggregate(thg.device_data("cpu"), xt, use_deg, backend="cumsum")
    got.backward(torch.as_tensor(cot))
    _close(got.detach().numpy(), np.asarray(out))
    _close(xt.grad.numpy(), np.asarray(want_dx))


def test_segment_functions_match_jax():
    """``segment_mean_sorted``, ``gather_segment_sum_sorted`` and
    ``incidence_gather_sum`` (and its adjoint) against JAX's."""
    jhg, thg = _graphs("skewed")
    x, _, _ = _inputs("skewed", f=5)
    rng = np.random.default_rng(3)
    vals = rng.normal(size=(thg.nnz, 5)).astype(np.float32)
    ip, ipj = torch.as_tensor(thg.ht_indptr), jnp.asarray(jhg.ht_indptr)
    _close(segments.segment_mean_sorted(torch.as_tensor(vals), ip).numpy(),
           np.asarray(jsegments.segment_mean_sorted(jnp.asarray(vals), ipj)))
    g = torch.as_tensor(thg.ht_indices.astype(np.int64))
    _close(segments.gather_segment_sum_sorted(torch.as_tensor(x), g, ip).numpy(),
           np.asarray(jsegments.gather_segment_sum_sorted(jnp.asarray(x),
                                                          jnp.asarray(jhg.ht_indices), ipj)))
    jd, td = jhg.device_data(), thg.device_data("cpu")
    cot = rng.normal(size=(thg.num_edges, 5)).astype(np.float32)
    out, vjp = jax.vjp(lambda a: jsegments.incidence_gather_sum(
        a, jd.ht_vertex, jd.ht_indptr, jd.h_edge, jd.h_indptr), jnp.asarray(x))
    (want_dx,) = vjp(jnp.asarray(cot))
    xt = torch.as_tensor(x).requires_grad_(True)
    got = segments.incidence_gather_sum(xt, td.v2e, td.e2v)
    got.backward(torch.as_tensor(cot))
    _close(got.detach().numpy(), np.asarray(out))
    _close(xt.grad.numpy(), np.asarray(want_dx))


def test_segment_tables_hold_both_csrs_and_refuse_bad_ones():
    _, thg = _graphs("skewed")
    td = thg.device_data("cpu")
    assert td.v2e.gather.dtype == td.v2e.indptr.dtype == torch.int32
    assert (td.v2e.num_segments, td.v2e.num_inputs, td.v2e.nnz) == (
        thg.num_edges, thg.num_nodes, thg.nnz)
    assert (td.e2v.num_segments, td.e2v.num_inputs) == (thg.num_nodes, thg.num_edges)
    # the tables keep the graph's int64 tensors and add only int32 copies
    assert td.e2v.gather_long is td.h_edge and td.e2v.indptr_long is td.h_indptr
    assert td.v2e.gather_long is td.ht_vertex and td.v2e.indptr_long is td.ht_indptr
    assert td.v2e is td.v2e
    build = segment_sum.SegmentTable.build
    with pytest.raises(ValueError, match="non-decreasing"):
        build([0, 3, 2], [0, 1, 2], 5, "cpu")
    with pytest.raises(ValueError, match=r"\[0, 5\)"):
        build([0, 2, 3], [0, 1, 5], 5, "cpu")
    with pytest.raises(ValueError, match="gather must be"):
        build([0, 2, 3], [0, 1], 5, "cpu")
    with pytest.raises(ValueError, match="identity"):
        build([0, 2, 6], None, 5, "cpu")
    # the identity gather: segment sums of the rows themselves; empty ones give 0
    t = build([0, 2, 2, 5], None, 6, "cpu")
    x = torch.arange(12, dtype=torch.float32).reshape(6, 2)
    want = torch.tensor([[2.0, 4.0], [0.0, 0.0], [18.0, 21.0]])
    assert torch.equal(segment_sum.gather_segment_sum(x, t), want)
    with pytest.raises(RuntimeError, match="incidence_gather_sum"):
        segment_sum.gather_segment_sum(x.requires_grad_(True), t)


def test_nnz_guard_sends_cumsum_to_tree(monkeypatch):
    """Above the guard (lowered in both packages) cumsum runs the tree when
    the plan has one, as JAX's does, and warns once when it has none."""
    jhg, thg = _graphs("random")
    x, _, _ = _inputs("random")
    monkeypatch.setattr(jfused, "_CUMSUM_NNZ_GUARD", 100)
    monkeypatch.setattr(fused, "CUMSUM_NNZ_GUARD", 100)
    monkeypatch.setattr(fused, "_warned_cumsum", False)
    jplan, tplan = jplanner.plan_aggregation(jhg), planner.AggregationPlan(tree=planner.plan_tree(thg))
    assert fused.resolve_backend("cumsum", tplan, thg.nnz) == "tree"
    hgd = thg.device_data("cpu")
    xt = torch.as_tensor(x)
    got = fused.hgnn_aggregate(hgd, xt, plan=tplan, backend="cumsum")
    assert torch.equal(got, fused.hgnn_aggregate(hgd, xt, plan=tplan, backend="tree"))
    want = jfused.hgnn_aggregate(jhg.device_data(), jnp.asarray(x), plan=jplan, backend="cumsum")
    np.testing.assert_array_equal(
        np.asarray(want),
        np.asarray(jfused.hgnn_aggregate(jhg.device_data(), jnp.asarray(x), plan=jplan,
                                         backend="tree")))
    _close(got.numpy(), np.asarray(want))
    with pytest.warns(UserWarning, match="cumsum at nnz"):
        fused.hgnn_aggregate(hgd, xt, backend="cumsum")
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        fused.hgnn_aggregate(hgd, xt, backend="cumsum")  # once only
    monkeypatch.setattr(fused, "CUMSUM_NNZ_GUARD", thg.nnz)
    assert fused.resolve_backend("cumsum", tplan, thg.nnz) == "cumsum"


@pytest.mark.parametrize("model,first_aggr", [("HGNN", "sum"), ("HGNN", "max"),
                                              ("UniGCNII", "sum")])
def test_trainer_on_cumsum_matches_jax_trainer(model, first_aggr):
    """JAX's Trainer on cumsum (no plan: max falls back to its oracle),
    the port's with its default plan (the tree for max), from the same
    weights, no dropout: 10 epochs within rtol 1e-3."""
    jhg, thg = _graphs("random")
    x, y = jsyn.random_features(jhg.num_nodes, 8, 3, seed=7)
    idx = np.arange(0, jhg.num_nodes, 2)
    kw = dict(model=model, nhid=8, first_aggr=first_aggr, dropout=0.0, input_drop=0.0,
              epochs=10, warmup=0, backend="cumsum")
    jtr = JTrainer(JTrainConfig(**kw), jhg, x, y, nclass=3)
    params = params_from_flax(jtr.params)
    want = [jtr.fit(idx, epochs=1, warmup=0)["final_loss"] for _ in range(10)]
    tr = Trainer(TrainConfig(**kw), thg, x, y, nclass=3, device="cpu", params=params)
    assert (tr.plan is None) == (first_aggr != "max")
    np.testing.assert_allclose(tr.fit(idx)["losses"], want, rtol=1e-3)
