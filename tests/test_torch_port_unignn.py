"""The port's UniGNN aggregation and models against the JAX package's, on the CPU.

Same NumPy inputs into ``hypergef_tpu`` and ``hypergef_tpu_torch``; JAX runs
on the CPU with its Pallas kernels in interpret mode. The graph is a small
SBM graph (``experiments/clustered_bench.py``'s recipe, vertices numbered by
community), so every route, ``aligned`` included, takes it. Tolerances:

* ``unignn_aggregate`` and its gradient: 1e-3 for the f32 gather routes
  (``xla``, ``tree``, ``pallas_sparse``, ``aligned``) and 3e-2 for the bf16
  ``dense`` and ``pallas`` routes (tests/test_fuzz_backends.py:46,54);
  ``bitstream`` rounds x to bf16 as JAX's does, so it is held at 1e-5·max
  (exact products, f32 sums in another order);
* UniGIN and UniGCNII forward against flax ``apply`` through
  ``params_from_flax``: 1e-3 on ``xla``, 1e-3 on ``bitstream`` (the layers'
  f32 projections may round a value to a neighbouring bf16 before the
  aggregation, a 2^-8 step of one term);
* Trainer and ServingModel against JAX's: the bars of
  tests/test_torch_port_train.py (losses of the first 10 epochs within rtol
  1e-3, predictions agreeing on ≥ 98% of the nodes).
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import hypergef_tpu.data.synthetic as jsyn
from experiments.clustered_bench import community_hypergraph as jcommunity_hypergraph
from hypergef_tpu import serve as jserve
from hypergef_tpu.models.zoo import build_model as jbuild_model
from hypergef_tpu.ops import bitstream as jbits
from hypergef_tpu.ops import fused as jfused
from hypergef_tpu.sparse import planner as jplanner
from hypergef_tpu.train import splits as jsplits
from hypergef_tpu.train.trainer import TrainConfig as JTrainConfig
from hypergef_tpu.train.trainer import Trainer as JTrainer

import hypergef_tpu_torch.data.synthetic as tsyn
from hypergef_tpu_torch.models.convert import params_from_flax
from hypergef_tpu_torch.models.zoo import UniGCNII, UniGIN, build_model
from hypergef_tpu_torch.ops import aligned_band, bitstream, ell_gather, fused, fused_dense
from hypergef_tpu_torch.serve import ServingModel
from hypergef_tpu_torch.sparse import planner
from hypergef_tpu_torch.sparse.planner import AggregationPlan
from hypergef_tpu_torch.train.trainer import TrainConfig, Trainer

N, E = 600, 480
SBM = (N, E, 12, 5, 0.02, 3)  # community_hypergraph's arguments
NFEAT, NCLASS = 12, 4
TOLS = {"f32": 1e-3, "bf16": 3e-2, "bits": 1e-5}
# route (with the aligned plan's form) -> tolerance class
ROUTES = {"xla": "f32", "dense": "bf16", "pallas": "bf16", "tree": "f32",
          "pallas_sparse": "f32", "aligned": "f32", "aligned_kernel_form": "f32",
          "bitstream": "bits"}


@pytest.fixture(autouse=True)
def deterministic():
    prev = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    yield
    torch.use_deterministic_algorithms(prev)


@functools.lru_cache(maxsize=None)
def _graphs():
    return jcommunity_hypergraph(*SBM), tsyn.community_hypergraph(*SBM)


def _launches():
    return tuple(m.launches for m in (fused_dense, ell_gather, aligned_band, bitstream))


def _close(got, want, rel):
    np.testing.assert_allclose(got, want, rtol=rel, atol=rel * float(np.abs(want).max()))


@functools.lru_cache(maxsize=None)
def _jax_plan(route):
    jhg, _ = _graphs()
    if route == "xla":
        return None
    if route == "tree":
        return jplanner.AggregationPlan(tree=jplanner.plan_tree(jhg))
    if route == "pallas_sparse":
        return jplanner.plan_pallas_sparse(jhg, impl="vmem")
    if route == "aligned":
        return jplanner.plan_aligned(jhg)
    plan = jplanner.plan_aggregation(jhg)  # dense and pallas: the int8 table
    if route == "bitstream":
        plan.bitstream = jbits.BitIncidence.from_hypergraph(jhg)
    return plan


def _port_plan(route):
    _, thg = _graphs()
    if route == "xla":
        return None
    if route in ("dense", "pallas"):
        return AggregationPlan.dense_plan(thg, "cpu")
    if route == "tree":
        return AggregationPlan(tree=planner.plan_tree(thg))
    if route == "pallas_sparse":
        return AggregationPlan(pallas_sparse=planner.plan_pallas_sparse(thg))
    if route == "aligned":
        return AggregationPlan(aligned=planner.plan_aligned(thg))
    if route == "aligned_kernel_form":
        return AggregationPlan(
            aligned=dataclasses.replace(planner.plan_aligned(thg), form="pallas_auto"))
    return AggregationPlan(bitstream=bitstream.BitIncidence.from_hypergraph(thg))


def _inputs():
    rng = np.random.default_rng(11)
    return (rng.normal(size=(N, 6)).astype(np.float32),
            rng.normal(size=(N, 6)).astype(np.float32))


@functools.lru_cache(maxsize=None)
def _jax_route(route, use_deg):
    """JAX's output and the gradient w.r.t. x of ⟨out, cot⟩."""
    jhg, _ = _graphs()
    x, cot = _inputs()
    hgd, plan = jhg.device_data(), _jax_plan(route)

    def f(xv):
        out = jfused.unignn_aggregate(hgd, xv, use_deg, plan=plan, backend=route)
        return jnp.sum(out * cot), out

    (_, out), dx = jax.value_and_grad(f, has_aux=True)(jnp.asarray(x))
    return np.asarray(out), np.asarray(dx)


@pytest.mark.parametrize("route", list(ROUTES))
@pytest.mark.parametrize("use_deg", [False, True])
def test_unignn_aggregate_and_gradient_match_jax(route, use_deg):
    _, thg = _graphs()
    x, cot = _inputs()
    jroute = "aligned" if route == "aligned_kernel_form" else route
    want_out, want_dx = _jax_route(jroute, use_deg)
    xt = torch.as_tensor(x).requires_grad_(True)
    before = _launches()
    out = fused.unignn_aggregate(thg.device_data("cpu"), xt, use_deg, plan=_port_plan(route),
                                 backend=jroute)
    (out * torch.as_tensor(cot)).sum().backward()
    assert _launches() == before  # plain twins on the CPU
    assert out.dtype == torch.float32 and tuple(out.shape) == x.shape
    tol = TOLS[ROUTES[route]]
    _close(out.detach().numpy(), want_out, tol)
    _close(xt.grad.numpy(), want_dx, tol)


def test_unignn_aggregate_refusals():
    _, thg = _graphs()
    hgd, x = thg.device_data("cpu"), torch.as_tensor(_inputs()[0])
    # the three routes once refused here run, and agree with JAX's on the
    # same plans (ell at the f32 bar, bsr and multihot at the bf16 bar)
    from hypergef_tpu.sparse import bsr as jbsr

    from hypergef_tpu_torch.sparse import bsr

    jhg, thg = _graphs()
    plan = AggregationPlan(tree=planner.plan_tree(thg), tile=planner.plan_tiles(thg),
                           bsr=bsr.plan_bsr(thg), multihot=planner.plan_multihot(thg))
    jplan = jplanner.AggregationPlan(
        tree=jplanner.plan_tree(jhg), tile=jplanner.plan_tiles(jhg), bsr=jbsr.plan_bsr(jhg),
        multihot=jplanner.plan_multihot(jhg))
    for backend, tol in (("ell", TOLS["f32"]), ("bsr", TOLS["bf16"]),
                         ("multihot", TOLS["bf16"])):
        for use_deg in (False, True):
            want = jfused.unignn_aggregate(jhg.device_data(), jnp.asarray(_inputs()[0]),
                                           use_deg, plan=jplan, backend=backend)
            _close(fused.unignn_aggregate(hgd, x, use_deg, plan=plan, backend=backend).numpy(),
                   np.asarray(want), tol)
    # None takes the default route, cumsum, which needs no plan
    assert torch.equal(fused.unignn_aggregate(hgd, x),
                       fused.unignn_aggregate(hgd, x, backend="cumsum"))
    with pytest.raises(ValueError, match="backend must be"):
        fused.unignn_aggregate(hgd, x, backend="no_such_route")
    with pytest.raises(ValueError, match="requires a plan"):
        fused.unignn_aggregate(hgd, x, backend="bitstream")
    with pytest.raises(ValueError, match="BitIncidence"):
        fused.unignn_aggregate(hgd, x, plan=_port_plan("tree"), backend="bitstream")
    with pytest.raises(ValueError, match="TreePlan"):
        fused.unignn_aggregate(hgd, x, plan=_port_plan("bitstream"), backend="tree")


# ---- the models ----------------------------------------------------------


MODELS = {"UniGIN": ("UniGIN", "relu"), "UniGCNII": ("UniGCNII", "relu"),
          "UniGCNII_prelu": ("UniGCNII", "prelu")}


def _perturbed(params, seed):
    """Init params with ε, the biases and the PReLU slope moved off their
    initial 0 / 0 / 0.01, so the conversion of each is seen."""
    rng = np.random.default_rng(seed)

    def move(path, a):
        key = jax.tree_util.keystr(path)
        if "eps" in key or "negative_slope" in key:
            return jnp.asarray(rng.uniform(0.1, 0.4, a.shape), a.dtype)
        if "bias" in key:
            return jnp.asarray(rng.normal(0.0, 0.1, a.shape), a.dtype)
        return a

    return jax.tree_util.tree_map_with_path(move, params)


@pytest.mark.parametrize("name", list(MODELS))
@pytest.mark.parametrize("route", ["xla", "bitstream"])
def test_models_match_flax_apply(name, route):
    jhg, thg = _graphs()
    model, activation = MODELS[name]
    x = _inputs()[0]
    jmodel = jbuild_model(model, x.shape[1], 16, NCLASS, nlayer=2, activation=activation,
                          backend=route)
    jhgd, jplan = jhg.device_data(), _jax_plan(route)
    params = jmodel.init({"params": jax.random.key(3)}, jnp.asarray(x), jhgd, jplan)["params"]
    params = _perturbed(params, seed=5)
    want = np.asarray(jmodel.apply({"params": params}, jnp.asarray(x), jhgd, jplan))

    sd = params_from_flax(params)
    net = build_model(model, x.shape[1], 16, NCLASS, thg.num_edges, activation=activation,
                      backend=route, device="cpu")
    assert set(sd) == set(net.state_dict())
    net.load_state_dict(sd)
    net.eval()
    with torch.no_grad():
        got = net(torch.as_tensor(x), thg.device_data("cpu"), _port_plan(route)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-3, atol=1e-3)


def test_model_structure_matches_flax():
    """The parameter names and shapes of each family, and the arguments
    ``build_model`` passes it (``zoo.py:130-179``)."""
    gin = build_model("UniGIN", NFEAT, 8, NCLASS, E, nlayer=3, nhead=2, dropout=0.3,
                      input_drop=0.2, device="cpu")
    assert isinstance(gin, UniGIN) and (gin.dropout_rate, gin.input_drop_rate) == (0.3, 0.2)
    assert [tuple(c.linear.weight.shape) for c in gin.convs] == [(16, NFEAT), (16, 16),
                                                                (NCLASS, 16)]
    assert all(not c.eps.any() for c in gin.convs)
    ii = build_model("UniGCNII", NFEAT, 8, NCLASS, E, nlayer=3, nhead=2, dropout=0.3,
                     activation="prelu", device="cpu")
    assert isinstance(ii, UniGCNII) and ii.dropout_rate == 0.3 and ii.alpha == 0.1
    np.testing.assert_allclose(ii.betas, [np.log(0.5 / (i + 1) + 1) for i in range(3)])
    assert set(ii.state_dict()) == {"prelu.weight", "lin_in.weight", "lin_in.bias",
                                    "lin_out.weight", "lin_out.bias",
                                    "convs.0.W.weight", "convs.1.W.weight", "convs.2.W.weight"}
    assert float(ii.prelu.weight.detach()) == pytest.approx(0.01) and not ii.lin_in.bias.any()
    with pytest.raises(ValueError, match="unknown model"):
        build_model("GAT", NFEAT, 8, NCLASS, E, device="cpu")
    with pytest.raises(ValueError, match="unknown param group"):
        params_from_flax({"GATConv_0": {}})


# ---- training and serving -----------------------------------------------


@functools.lru_cache(maxsize=None)
def _problem():
    jhg, thg = _graphs()
    x, y = jsyn.random_features(N, NFEAT, NCLASS, seed=4)
    return jhg, thg, x, y, jsplits.rand_train_test_idx(y, seed=2)


@pytest.mark.parametrize("model,activation,route", [("UniGIN", "relu", "tree"),
                                                    ("UniGCNII", "prelu", "dense")])
def test_trainer_matches_jax_trainer(model, activation, route):
    """JAX's Trainer and the port's (on its default plan) from the same
    weights, dropout off, 40 epochs."""
    jhg, thg, x, y, split = _problem()
    jcfg = JTrainConfig(model=model, nhid=8, nlayer=2, activation=activation, dropout=0.0,
                        input_drop=0.0, epochs=40, warmup=0, seed=0, backend=route)
    jtr = JTrainer(jcfg, jhg, x, y, nclass=NCLASS, plan=_jax_plan(route))
    params = params_from_flax(jtr.params)
    want = [jtr.fit(split["train"], epochs=1, warmup=0)["final_loss"] for _ in range(40)]
    want_pred = np.asarray(jtr._forward(jtr.params, jtr.x)).argmax(1)

    tr = Trainer(TrainConfig(**dataclasses.asdict(jcfg)), thg, x, y, nclass=NCLASS,
                 device="cpu", params=params)
    res = tr.fit(split["train"])
    np.testing.assert_allclose(res["losses"][:10], want[:10], rtol=1e-3)
    assert (tr.predict().argmax(1).numpy() == want_pred).mean() >= 0.98


@pytest.mark.parametrize("model,route", [("UniGIN", "bitstream"), ("UniGCNII", "xla")])
def test_serving_matches_jax_serving(model, route, tmp_path):
    """JAX's exported serving artifact (``serve.export_trainer``, loaded by
    its ``ServingModel``) against the port's ServingModel on the same
    weights, which builds its own plan."""
    jhg, thg, x, y, _ = _problem()
    jcfg = JTrainConfig(model=model, nhid=16, nlayer=2, backend=route, seed=0)
    jtr = JTrainer(jcfg, jhg, x, y, nclass=NCLASS, plan=_jax_plan(route))
    jserve.export_trainer(jtr, str(tmp_path / "model.hgsrv"))
    want = np.asarray(jserve.ServingModel.load(str(tmp_path / "model.hgsrv")).predict(x))

    server = ServingModel(TrainConfig(**dataclasses.asdict(jcfg)), thg, NFEAT, NCLASS, "cpu",
                          params=params_from_flax(jtr.params))
    if route == "bitstream":
        assert server.plan.bitstream._device  # the packs put on the device when built
    got = server.predict(x).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-3, atol=1e-3)
    assert (got.argmax(1) == want.argmax(1)).mean() >= 0.98
