"""The port's routing ladder, ``precomp`` and default route against the JAX
package's, on the CPU.

Same NumPy inputs into ``hypergef_tpu`` and ``hypergef_tpu_torch``. Bars:

* ``plan_aggregation``: the same ``preferred_backend`` and the same plans
  built (``dense``, ``precomp``, ``aligned``, ``bitstream``, ``tree``);
* ``DensePrecomp.a``: within one bf16 ulp of JAX's (both sum the same f32
  products, in another order, then round to bf16);
* the ``precomp`` route: outputs and x gradients within 3e-2 (the bf16 bar,
  tests/test_fuzz_backends.py:54). Both round x to bf16 and multiply by the
  bf16 A with an f32 result; both round the gradient to bf16 after the
  transposed product (JAX: the transpose of ``x.astype(bf16)``); the port
  also rounds the cotangent to bf16 before that product, JAX does not;
* ``Trainer(TrainConfig(), ...)`` with no backend against JAX's Trainer:
  losses of the first 10 no-dropout epochs within rtol 1e-3 on a graph
  the ladder sends to ``cumsum`` and 3e-2 on one it sends to ``precomp``.
"""

import dataclasses
import functools
import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import hypergef_tpu.data.synthetic as jsyn
from experiments.clustered_bench import community_hypergraph as jcommunity_hypergraph
from hypergef_tpu.ops import fused as jfused
from hypergef_tpu.sparse import planner as jplanner
from hypergef_tpu.train.trainer import TrainConfig as JTrainConfig
from hypergef_tpu.train.trainer import Trainer as JTrainer

import hypergef_tpu_torch.data.synthetic as tsyn
from hypergef_tpu_torch.models.convert import params_from_flax
from hypergef_tpu_torch.ops import fused
from hypergef_tpu_torch.serve import ServingModel
from hypergef_tpu_torch.sparse import planner
from hypergef_tpu_torch.train.trainer import TrainConfig, Trainer, device_plans

REPO = Path(__file__).resolve().parents[1]
FIELDS = ("dense", "precomp", "aligned", "bitstream", "tree", "tile", "bsr", "multihot")

# (n, e, avg_edge_size): the graphs of tests/test_auto_ladder.py and of
# chip_smoke.py's ladder phase that are cheap to plan on the CPU
LADDER_GRAPHS = {
    "cora": (2708, 2708, 4.0),
    "20news": (16242, 100, 654.5),
    "large_sparse": (60_000, 30_000, 8.0),
    "dense_stream": (16_000, 4_000, 10.0),
    "high_ratio": (30_000, 8_000, 3.0),
    "small_hg": (120, 80, 5.0),
    "pubmed_real": (19717, 7963, 10.8),
    "coauthor_dblp": (41302, 22363, 4.5),
}


@pytest.fixture(autouse=True)
def default_backends():
    """Tests that set the process-global default route put it back."""
    jprev, prev = jfused.get_default_backend(), fused.get_default_backend()
    yield
    jfused.set_default_backend(jprev)
    fused.set_default_backend(prev)


@functools.lru_cache(maxsize=None)
def _random(n, e, avg, seed=0):
    return (jsyn.random_hypergraph(n, e, avg_edge_size=avg, seed=seed),
            tsyn.random_hypergraph(n, e, avg_edge_size=avg, seed=seed))


def _same_plans(jplan, tplan):
    assert tplan.preferred_backend == jplan.preferred_backend
    for name in FIELDS:
        assert (getattr(tplan, name) is None) == (getattr(jplan, name) is None), name


@pytest.mark.parametrize("name", list(LADDER_GRAPHS))
def test_ladder_picks_the_route_jax_picks(name):
    jhg, thg = _random(*LADDER_GRAPHS[name], seed=3 if name == "small_hg" else 0)
    _same_plans(jplanner.plan_aggregation(jhg), planner.plan_aggregation(thg, "cpu"))


def test_chip_smoke_ladder_constants_are_jax_picks():
    """chip_smoke.py's phase 21 holds the card's picks against constants
    (the card has no JAX); those of its random graphs are JAX's picks here."""
    spec = importlib.util.spec_from_file_location("chip_smoke", REPO / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    assert set(mod.LADDER_PICKS) == set(mod.LADDER_GRAPHS) | {"sbm60k", "stream100k"}
    assert (mod.LADDER_PICKS["sbm60k"], mod.LADDER_PICKS["stream100k"]) == ("aligned", "bitstream")
    for name, g in mod.LADDER_GRAPHS.items():
        assert LADDER_GRAPHS[name] == (g["n"], g["e"], g["avg"])
        jhg, _ = _random(g["n"], g["e"], g["avg"])
        assert jplanner.plan_aggregation(jhg).preferred_backend == mod.LADDER_PICKS[name], name


def test_community_sorted_graph_takes_aligned():
    """Past the dense and precomp gates (closed by argument: the graph is
    small), a graph numbered by community takes ``aligned`` and a random one
    ``cumsum``, in both packages; the port's plan stays in the plain form on
    the CPU."""
    sbm = (600, 480, 12, 5, 0.02, 3)
    gates = dict(dense_threshold=0, with_precomp=False)
    jplan = jplanner.plan_aggregation(jcommunity_hypergraph(*sbm), **gates)
    tplan = planner.plan_aggregation(tsyn.community_hypergraph(*sbm), "cpu", **gates)
    _same_plans(jplan, tplan)
    assert tplan.preferred_backend == "aligned" and tplan.aligned.form == "xla"
    jhg, thg = _random(6000, 5000, 3.0)
    _same_plans(jplanner.plan_aggregation(jhg, **gates),
                planner.plan_aggregation(thg, "cpu", **gates))
    assert planner.plan_aggregation(thg, "cpu", **gates).preferred_backend == "cumsum"


@pytest.mark.parametrize("stream_cap,want", [(None, "dense"), (1_000_000, "bitstream")])
def test_stream_branches_at_small_size(monkeypatch, stream_cap, want):
    """The dense-stream and bitstream branches, reached on a 3000×1000 graph
    by lowering the same caps in both packages."""
    if stream_cap is not None:
        for mod in (jplanner, planner):
            monkeypatch.setattr(mod, "DENSE_STREAM_MAX_ENTRIES", stream_cap)
            monkeypatch.setattr(mod, "BITSTREAM_MAX_ENTRIES", 8 * stream_cap)
    jhg, thg = _random(3000, 1000, 10.0)
    args = dict(dense_threshold=1, with_precomp=False)
    jplan, tplan = jplanner.plan_aggregation(jhg, **args), planner.plan_aggregation(thg, "cpu", **args)
    _same_plans(jplan, tplan)
    assert tplan.preferred_backend == want


def test_left_out_plan_forms_raise():
    """The plan forms once refused here: with each flag the port builds the
    plans JAX builds, their tables bit-equal. ``with_bsr`` is reached past
    the dense gate (closed by argument)."""
    jhg, thg = _random(120, 80, 5.0, seed=3)
    for flag in ("with_tile", "with_bsr", "with_multihot"):
        gates = dict(dense_threshold=0, with_precomp=False) if flag == "with_bsr" else {}
        jplan = jplanner.plan_aggregation(jhg, **gates, **{flag: True})
        tplan = planner.plan_aggregation(thg, "cpu", **gates, **{flag: True})
        _same_plans(jplan, tplan)
        sub = {"with_tile": "tile", "with_bsr": "bsr", "with_multihot": "multihot"}[flag]
        assert getattr(tplan, sub) is not None
    for a, b in ((tplan.multihot.edge_stage, jplan.multihot.edge_stage),
                 (tplan.multihot.vertex_stage, jplan.multihot.vertex_stage)):
        np.testing.assert_array_equal(a.gidx, b.gidx)
        np.testing.assert_array_equal(a.mask, b.mask)
    tile = planner.plan_aggregation(thg, "cpu", with_tile=True).tile
    jtile = jplanner.plan_aggregation(jhg, with_tile=True).tile
    for t, jt in ((tile.edge_table, jtile.edge_table), (tile.vertex_table, jtile.vertex_table)):
        np.testing.assert_array_equal(t.gather_idx, jt.gather_idx)
        np.testing.assert_array_equal(t.seg_ids, jt.seg_ids)
    bplan = planner.plan_aggregation(thg, "cpu", dense_threshold=0, with_precomp=False,
                                     with_bsr=True)
    jbplan = jplanner.plan_aggregation(jhg, dense_threshold=0, with_precomp=False,
                                       with_bsr=True)
    np.testing.assert_array_equal(bplan.bsr.edge_stage.blocks, jbplan.bsr.edge_stage.blocks)


@pytest.mark.parametrize("shape", [(700, 500, 4.0), (2708, 2708, 4.0)])
def test_precomp_matrix_is_within_one_bf16_ulp_of_jax(shape):
    jhg, thg = _random(*shape)
    want = np.asarray(jplanner.DensePrecomp.from_hypergraph(jhg).a)
    got = planner.DensePrecomp.from_hypergraph(thg, "cpu").a
    assert got.dtype == torch.bfloat16 and tuple(got.shape) == (shape[0], shape[0])
    # A ≥ 0, so neighbouring bf16 values have neighbouring bit patterns
    bits = got.view(torch.int16).numpy().astype(np.int32)
    want_bits = torch.as_tensor(want.astype(np.float32)).to(torch.bfloat16).view(torch.int16)
    assert np.abs(bits - want_bits.numpy().astype(np.int32)).max() <= 1


def _bf16_close(got, want):
    np.testing.assert_allclose(got, want, rtol=3e-2, atol=3e-2 * float(np.abs(want).max()))


@pytest.mark.parametrize("model", ["HGNN", "UniGNN"])
def test_precomp_route_and_gradient_match_jax(model):
    jhg, thg = _random(700, 500, 4.0)
    jplan, tplan = jplanner.plan_aggregation(jhg), planner.plan_aggregation(thg, "cpu")
    assert tplan.preferred_backend == jplan.preferred_backend == "precomp"
    rng = np.random.default_rng(4)
    x = rng.normal(size=(700, 6)).astype(np.float32)
    cot = rng.normal(size=(700, 6)).astype(np.float32)

    def jf(xv):
        if model == "HGNN":
            return jfused.hgnn_aggregate(jhg.device_data(), xv, plan=jplan, backend="precomp")
        return jfused.unignn_aggregate(jhg.device_data(), xv, True, plan=jplan, backend="precomp")

    out, vjp = jax.vjp(jf, jnp.asarray(x))
    (want_dx,) = vjp(jnp.asarray(cot))
    xt = torch.as_tensor(x).requires_grad_(True)
    hgd = thg.device_data("cpu")
    got = (fused.hgnn_aggregate(hgd, xt, plan=tplan, backend="precomp") if model == "HGNN"
           else fused.unignn_aggregate(hgd, xt, True, plan=tplan, backend="precomp"))
    got.backward(torch.as_tensor(cot))
    assert got.dtype == torch.float32
    _bf16_close(got.detach().numpy(), np.asarray(out))
    _bf16_close(xt.grad.numpy(), np.asarray(want_dx))


def test_precomp_falls_through_as_jax_does():
    """With wdiag, or mean, precomp runs ``dense`` (the plan has the table);
    without the table it runs ``tree``."""
    _, thg = _random(700, 500, 4.0)
    plan = planner.plan_aggregation(thg, "cpu")
    hgd = thg.device_data("cpu")
    x = torch.as_tensor(np.random.default_rng(1).normal(size=(700, 5)).astype(np.float32))
    w = torch.full((500, 1), 0.5)
    for kw in (dict(wdiag=w), dict(first_aggr="mean")):
        want = fused.hgnn_aggregate(hgd, x, plan=plan, backend="dense", **kw)
        assert torch.equal(fused.hgnn_aggregate(hgd, x, plan=plan, backend="precomp", **kw), want)
    no_dense = dataclasses.replace(plan, dense=None)
    want = fused.hgnn_aggregate(hgd, x, w, plan=no_dense, backend="tree")
    assert torch.equal(fused.hgnn_aggregate(hgd, x, w, plan=no_dense, backend="precomp"), want)
    assert torch.equal(fused.unignn_aggregate(hgd, x, False, plan=plan, backend="precomp"),
                       fused.unignn_aggregate(hgd, x, False, plan=plan, backend="dense"))


def test_backend_none_runs_the_default_route():
    _, thg = _random(300, 200, 4.0)
    hgd = thg.device_data("cpu")
    x = torch.as_tensor(np.random.default_rng(2).normal(size=(300, 4)).astype(np.float32))
    assert fused.get_default_backend() == "cumsum"
    assert torch.equal(fused.hgnn_aggregate(hgd, x), fused.hgnn_aggregate(hgd, x, backend="cumsum"))
    assert fused.resolve_backend(None, None) == "cumsum"
    assert fused.resolve_backend("auto", None) == "cumsum"
    fused.set_default_backend("xla")
    assert torch.equal(fused.hgnn_aggregate(hgd, x), fused.hgnn_aggregate(hgd, x, backend="xla"))
    with pytest.raises(ValueError, match="backend must be"):
        fused.set_default_backend("no_such_route")


# ---- training and serving with the defaults ------------------------------

NFEAT, NCLASS = 10, 3
# (n, e, avg_edge_size, seed): graphs JAX's ladder sends to cumsum (N² past
# the precomp cap, N·E past the dense gate, N·E ≥ 2000·nnz) and to precomp
DEFAULT_GRAPHS = {"cumsum": ((9000, 4000, 3.0, 1), 1e-3), "precomp": ((400, 300, 4.0, 1), 3e-2)}


@pytest.mark.parametrize("route", list(DEFAULT_GRAPHS))
def test_trainer_defaults_match_jax_trainer(route):
    (n, e, avg, seed), rtol = DEFAULT_GRAPHS[route]
    jhg, thg = _random(n, e, avg, seed)
    x, y = jsyn.random_features(n, NFEAT, NCLASS, seed=seed + 1)
    idx = np.arange(0, n, 2)
    jcfg = JTrainConfig(model="HGNN", nhid=8, dropout=0.0, input_drop=0.0, epochs=10, warmup=0)
    assert jcfg.backend == "auto"
    jtr = JTrainer(jcfg, jhg, x, y, nclass=NCLASS)
    assert jtr.plan.preferred_backend == route
    params = params_from_flax(jtr.params)
    want = [jtr.fit(idx, epochs=1, warmup=0)["final_loss"] for _ in range(10)]
    cfg = TrainConfig(nhid=8, dropout=0.0, input_drop=0.0, epochs=10, warmup=0)
    tr = Trainer(cfg, thg, x, y, nclass=NCLASS, device="cpu", params=params)
    assert tr.plan.preferred_backend == route
    assert route != "precomp" or tr.plan.precomp in device_plans(tr.plan)
    got = tr.fit(idx)["losses"]
    np.testing.assert_allclose(got, want, rtol=rtol)


def test_server_runs_with_no_backend_and_no_plan():
    _, thg = _random(*DEFAULT_GRAPHS["cumsum"][0])
    x, _ = tsyn.random_features(thg.num_nodes, NFEAT, NCLASS, seed=2)
    server = ServingModel(TrainConfig(nhid=8), thg, NFEAT, NCLASS, "cpu")
    assert server.plan.preferred_backend == "cumsum"
    ref = ServingModel(TrainConfig(nhid=8, backend="xla"), thg, NFEAT, NCLASS, "cpu",
                       params=server.model.state_dict())
    np.testing.assert_allclose(server.predict(x).numpy(), ref.predict(x).numpy(), rtol=1e-4,
                               atol=1e-4)
