"""The port's aggregation routes against the JAX package's, on the CPU.

Same NumPy inputs into both packages. Tolerances are the JAX tests' own
(tests/test_fuzz_backends.py:46,54):

* 1e-3 for the f32 segment-sum ``xla`` route;
* 3e-2 for the bf16 routes (``dense``, and ``pallas``, whose CPU form is
  the CUDA kernel's plain version), against the JAX Pallas kernel in
  interpret mode, the JAX dense route and the NumPy dense oracle.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import hypergef_tpu.data.synthetic as jsyn
from hypergef_tpu.ops import fused as jfused
from hypergef_tpu.ops import pallas_kernels as jpk
from hypergef_tpu.ops import refops as jrefops
from hypergef_tpu.sparse import planner as jplanner
from hypergef_tpu.sparse.planner import plan_aggregation

import hypergef_tpu_torch.data.synthetic as tsyn
from hypergef_tpu_torch.ops import fused, fused_dense
from hypergef_tpu_torch.sparse.planner import AggregationPlan
from hypergef_tpu_torch.sparse.planner import plan_aggregation as plan_port

from conftest import dense_hgnn_oracle

F32_TOL = dict(rtol=1e-3, atol=1e-3)
BF16_TOL = dict(rtol=3e-2, atol=3e-2)

# (n, e, avg_edge_size, seed, f): the graphs of tests/test_pallas.py:20-53
# (small_hg is random_hypergraph(120, 80, 5.0, seed=3)) plus a few giant edges
GRAPHS = {
    "small_f8": (120, 80, 5.0, 3, 8),
    "small_f4": (120, 80, 5.0, 3, 4),
    "odd_301x187x17": (301, 187, 5.0, 2, 17),
    "giant_edges": (50, 7, 20.0, 4, 5),
}


@pytest.fixture(autouse=True)
def deterministic():
    prev = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    yield
    torch.use_deterministic_algorithms(prev)


def _problem(name, with_wdiag):
    n, e, avg, seed, f = GRAPHS[name]
    jhg = jsyn.random_hypergraph(n, e, avg_edge_size=avg, seed=seed)
    thg = tsyn.random_hypergraph(n, e, avg_edge_size=avg, seed=seed)
    rng = np.random.default_rng(seed + 10)
    x = rng.normal(size=(n, f)).astype(np.float32)
    w = rng.uniform(0.5, 1.5, (e, 1)).astype(np.float32) if with_wdiag else None
    return jhg, thg, x, w


def _port(thg, x, w, aggr, backend):
    plan = AggregationPlan.dense_plan(thg, "cpu")
    wt = None if w is None else torch.as_tensor(w)
    out = fused.hgnn_aggregate(thg.device_data("cpu"), torch.as_tensor(x), wt, aggr,
                               plan=plan, backend=backend)
    assert out.dtype == torch.float32 and tuple(out.shape) == x.shape
    return out.numpy()


CASES = [(g, aggr, wd) for g in GRAPHS for aggr in ("sum", "mean") for wd in (False, True)]


@pytest.mark.parametrize("graph,aggr,with_wdiag", CASES)
def test_xla_route_matches_jax_refops(graph, aggr, with_wdiag):
    jhg, thg, x, w = _problem(graph, with_wdiag)
    want = jrefops.hgnn_aggregate_ref(
        jhg.device_data(), jnp.asarray(x), None if w is None else jnp.asarray(w), aggr)
    np.testing.assert_allclose(_port(thg, x, w, aggr, "xla"), np.asarray(want), **F32_TOL)


@pytest.mark.parametrize("graph,aggr,with_wdiag", CASES)
def test_pallas_plain_matches_jax_pallas_interpret(graph, aggr, with_wdiag):
    jhg, thg, x, w = _problem(graph, with_wdiag)
    want = jpk.hgnn_aggregate_pallas(
        jhg.device_data(), jnp.asarray(x), None if w is None else jnp.asarray(w), aggr,
        plan_aggregation(jhg), interpret=True)
    before = fused_dense.launches
    got = _port(thg, x, w, aggr, "pallas")
    assert fused_dense.launches == before  # CPU tensors take the plain version
    np.testing.assert_allclose(got, np.asarray(want), **BF16_TOL)
    np.testing.assert_allclose(got, dense_hgnn_oracle(jhg, x, w, aggr), **BF16_TOL)


@pytest.mark.parametrize("graph,aggr", [(g, a) for g in GRAPHS for a in ("sum", "mean")])
def test_dense_route_matches_jax_dense(graph, aggr):
    jhg, thg, x, w = _problem(graph, True)
    want = jfused.hgnn_aggregate(jhg.device_data(), jnp.asarray(x), jnp.asarray(w), aggr,
                                 plan=plan_aggregation(jhg), backend="dense")
    np.testing.assert_allclose(_port(thg, x, w, aggr, "dense"), np.asarray(want), **BF16_TOL)


def test_plain_path_keeps_gradients():
    """On CPU tensors the pallas route is differentiable plain torch: its
    dx matches the xla route's exact adjoint at the bf16 tolerance."""
    _, thg, x, w = _problem("small_f4", True)
    hgd, plan = thg.device_data("cpu"), AggregationPlan.dense_plan(thg, "cpu")
    grads = []
    for backend in ("pallas", "xla"):
        xt = torch.as_tensor(x).requires_grad_(True)
        out = fused.hgnn_aggregate(hgd, xt, torch.as_tensor(w), "sum", plan, backend)
        (out ** 2).sum().backward()
        grads.append(xt.grad.numpy())
    np.testing.assert_allclose(grads[0], grads[1], rtol=5e-2, atol=5e-2)


@pytest.mark.parametrize("backend", ["auto", "cumsum", "ell", "bsr", "precomp", "multihot", None])
def test_unported_routes_raise(backend):
    """The JAX route names beyond the first seven, all ported: ``auto``,
    ``cumsum``, ``precomp`` and None run on the ladder's plan and agree with
    the xla route (``precomp`` at the bf16 bar); ``ell``, ``bsr`` and
    ``multihot`` run on their plans and agree with JAX's route on the same
    plans (``ell`` at the f32 bar, the other two at the bf16 bar)."""
    jhg, thg, x, _ = _problem("small_f4", False)
    hgd, xt = thg.device_data("cpu"), torch.as_tensor(x)
    if backend in ("ell", "bsr", "multihot"):
        from hypergef_tpu.sparse import bsr as jbsr

        from hypergef_tpu_torch.sparse import bsr, planner

        plan = AggregationPlan(tree=planner.plan_tree(thg), tile=planner.plan_tiles(thg),
                               bsr=bsr.plan_bsr(thg), multihot=planner.plan_multihot(thg))
        jplan = jplanner.AggregationPlan(
            tree=jplanner.plan_tree(jhg), tile=jplanner.plan_tiles(jhg),
            bsr=jbsr.plan_bsr(jhg), multihot=jplanner.plan_multihot(jhg))
        got = fused.hgnn_aggregate(hgd, xt, None, "sum", plan=plan, backend=backend).numpy()
        want = jfused.hgnn_aggregate(jhg.device_data(), jnp.asarray(x), None, "sum",
                                     plan=jplan, backend=backend)
        np.testing.assert_allclose(got, np.asarray(want),
                                   **(F32_TOL if backend == "ell" else BF16_TOL))
        return
    plan = plan_port(thg, "cpu")
    got = fused.hgnn_aggregate(hgd, xt, None, "sum", plan=plan, backend=backend).numpy()
    want = fused.hgnn_aggregate(hgd, xt, None, "sum", backend="xla").numpy()
    np.testing.assert_allclose(got, want, **(BF16_TOL if backend in ("auto", "precomp")
                                             else F32_TOL))


@pytest.mark.parametrize("backend", fused.ROUTES)
def test_max_first_aggr_raises(backend):
    """Max needs a stage plan that carries the record table: with the int8
    table alone every plan route raises (JAX would fall back to the nnz
    oracle) and names the plan to pass; the xla route takes max and raises
    on a reduction it does not know. Nothing launches."""
    _, thg, x, _ = _problem("small_f4", False)
    plan = AggregationPlan.dense_plan(thg, "cpu")
    before = fused_dense.launches
    if backend == "xla":
        with pytest.raises(ValueError, match="unknown first_aggr"):
            fused.hgnn_aggregate(thg.device_data("cpu"), torch.as_tensor(x), None, "min",
                                 plan=plan, backend=backend)
    else:
        with pytest.raises(ValueError, match="record table"):
            fused.hgnn_aggregate(thg.device_data("cpu"), torch.as_tensor(x), None, "max",
                                 plan=plan, backend=backend)
    assert fused_dense.launches == before


def test_route_argument_errors():
    _, thg, x, _ = _problem("small_f4", False)
    hgd, xt = thg.device_data("cpu"), torch.as_tensor(x)
    with pytest.raises(ValueError, match="backend must be"):
        fused.hgnn_aggregate(hgd, xt, backend="no_such_route")
    with pytest.raises(ValueError, match="requires a plan"):
        fused.hgnn_aggregate(hgd, xt, backend="pallas")
    for backend in ("pallas", "dense"):
        with pytest.raises(ValueError, match="DenseIncidence"):
            fused.hgnn_aggregate(hgd, xt, plan=AggregationPlan(), backend=backend)


def _fd_operands(name):
    n, e, avg, seed, f = GRAPHS[name]
    thg = tsyn.random_hypergraph(n, e, avg_edge_size=avg, seed=seed)
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, f)).astype(np.float32)
    se = rng.uniform(0.1, 1.0, (e, 1)).astype(np.float32)
    sv = rng.uniform(0.1, 1.0, (n, 1)).astype(np.float32)
    g = rng.normal(size=(n, f)).astype(np.float32)
    h = AggregationPlan.dense_plan(thg, "cpu").dense.h
    return thg, h, x, se, sv, g


@pytest.mark.parametrize("graph", ["small_f8", "odd_301x187x17", "giant_edges"])
def test_plain_gradient_is_jax_vjp(graph):
    """On CPU tensors the op's gradient is JAX's ``_fd_bwd``
    (pallas_kernels.py:153-177), which rounds ``g·scale_v`` to bf16 and runs
    the op again, and not autograd of the f32 plain form. Autograd of the
    plain form is off by 2.5e-3 to 6.1e-3 of max|grad| in dx and d scale_e
    at these shapes; ``_fd_bwd``'s formula is within 2.3e-7 (f32 summation
    order only). The bar, 1e-4 of max|grad|, lies between the two."""
    thg, h, x, se, sv, g = _fd_operands(graph)
    hb = jnp.asarray(thg.to_scipy().toarray(), jnp.bfloat16)
    _, vjp = jax.vjp(lambda a, b, c: jpk._fused_dense_op(hb, a, b, c, True),
                     jnp.asarray(x), jnp.asarray(se), jnp.asarray(sv))
    want = [np.asarray(t) for t in vjp(jnp.asarray(g))]
    ts = [torch.tensor(a, requires_grad=True) for a in (x, se, sv)]
    before = fused_dense.launches
    fused_dense.fused_dense_two_stage(h, *ts).backward(torch.as_tensor(g))
    assert fused_dense.launches == before
    for name, t, w in zip(("dx", "d_scale_e", "d_scale_v"), ts, want):
        np.testing.assert_allclose(t.grad.numpy(), w, rtol=0, atol=1e-4 * np.abs(w).max(),
                                   err_msg=name)


def test_kernel_node_backward_is_fd_bwd(monkeypatch):
    """The autograd node's backward is ``_fd_bwd``'s formula on the op
    itself: ``dx = op(h, g·Sv, Se, 1)``, ``d Se = Σ_f (Hᵀx)⊙(Hᵀ(g·Sv))``,
    ``d Sv = Σ_f op(h, x, Se, 1)⊙g``, and nothing for ``h``; a gradient
    nobody asks for is not computed."""
    _, h, x, se, sv, g = _fd_operands("small_f8")
    xt, set_, svt, gt = (torch.as_tensor(a) for a in (x, se, sv, g))
    ts = [t.clone().requires_grad_(True) for t in (xt, set_, svt)]
    fused_dense.fused_dense_two_stage(h, *ts).backward(gt)
    for t, want in zip(ts, fused_dense.fused_dense_backward_plain(h, xt, set_, svt, gt)):
        assert torch.equal(t.grad, want)
    calls = []
    for name in ("_two_stage", "_v2e"):
        real = getattr(fused_dense, name)
        monkeypatch.setattr(fused_dense, name,
                            lambda *a, _real=real, _name=name: calls.append(_name) or _real(*a))
    only_x = xt.clone().requires_grad_(True)
    out = fused_dense.fused_dense_two_stage(h, only_x, set_, svt)
    assert out.grad_fn.__class__.__name__ == "_FusedDenseTwoStageBackward"
    torch.autograd.grad(out, only_x, gt)
    assert calls == ["_two_stage", "_two_stage"]  # the forward, then dx alone


def test_kernel_wrapper_rejects_mixed_devices_on_cpu():
    _, thg, x, _ = _problem("small_f4", False)
    hgd = thg.device_data("cpu")
    h = AggregationPlan.dense_plan(thg, "cpu").dense.h
    with pytest.raises(ValueError, match="on the CPU"):
        fused_dense.fused_dense_two_stage(h.to("meta"), torch.as_tensor(x), hgd.degE, hgd.degV)
