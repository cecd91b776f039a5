"""The whole slice: JAX HGNN on the Pallas route against the port's server.

The JAX model's ``init`` params go through ``params_from_flax`` into the
port's ``ServingModel`` on the CPU, where the ``pallas`` route runs the
kernel's plain version; the JAX side runs the Pallas kernel in interpret
mode (graphs stay under 1000×500 so its VMEM guard keeps it on Pallas).
Log-probs must match within atol 3e-2 (the bf16 bar of
tests/test_fuzz_backends.py:54) and argmax agree on ≥98% of the nodes (the
bar of tests/test_torch_parity.py:135).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import hypergef_tpu.data.synthetic as jsyn
from hypergef_tpu.models.zoo import HGNN as JHGNN
from hypergef_tpu.models.zoo import build_model as jbuild_model
from hypergef_tpu.ops import pallas_kernels as jpk
from hypergef_tpu.sparse.planner import plan_aggregation
from hypergef_tpu.train.trainer import TrainConfig as JTrainConfig

import hypergef_tpu_torch.data.synthetic as tsyn
from hypergef_tpu_torch.models.convert import params_from_flax
from hypergef_tpu_torch.models.zoo import HGNN, build_model
from hypergef_tpu_torch.ops import fused_dense
from hypergef_tpu_torch.serve import ServingModel
from hypergef_tpu_torch.sparse.planner import AggregationPlan
from hypergef_tpu_torch.train.trainer import TrainConfig

NFEAT, NCLASS = 12, 4


@pytest.fixture(autouse=True)
def deterministic():
    prev = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    yield
    torch.use_deterministic_algorithms(prev)


def _graphs(n, e, seed):
    jhg, y = jsyn.homophilic_hypergraph(n, e, NCLASS, avg_edge_size=6.0, seed=seed)
    thg, _ = tsyn.homophilic_hypergraph(n, e, NCLASS, avg_edge_size=6.0, seed=seed)
    x, _ = jsyn.random_features(n, NFEAT, NCLASS, seed=seed + 1)
    return jhg, thg, x


@pytest.mark.parametrize(
    "n,e,nhid,nlayer,first_aggr",
    [(1000, 500, 32, 2, "sum"), (400, 250, 8, 3, "mean")],
)
def test_serving_matches_jax_hgnn_pallas(n, e, nhid, nlayer, first_aggr):
    # the JAX dispatcher leaves Pallas for its dense route past the VMEM
    # budget; these shapes stay inside it
    assert jpk._vmem_bytes(n, e, max(nhid, NFEAT)) <= jpk.VMEM_TOTAL_BUDGET
    jhg, thg, x = _graphs(n, e, seed=n)
    jmodel = jbuild_model("HGNN", NFEAT, nhid, NCLASS, nlayer=nlayer,
                          first_aggr=first_aggr, backend="pallas")
    jhgd, jplan = jhg.device_data(), plan_aggregation(jhg)
    params = jmodel.init({"params": jax.random.key(0)}, jnp.asarray(x), jhgd, jplan)["params"]
    want = np.asarray(jmodel.apply({"params": params}, jnp.asarray(x), jhgd, jplan))

    cfg = TrainConfig(model="HGNN", nhid=nhid, nlayer=nlayer, first_aggr=first_aggr,
                      backend="pallas")
    server = ServingModel(cfg, thg, NFEAT, NCLASS, "cpu", params=params_from_flax(params))
    before = fused_dense.launches
    got = server.predict(x)
    assert fused_dense.launches == before
    assert got.dtype == torch.float32 and tuple(got.shape) == (n, NCLASS)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=3e-2)
    assert (got.numpy().argmax(1) == want.argmax(1)).mean() >= 0.98
    np.testing.assert_array_equal(server.predict_labels(x), got.numpy().argmax(1))


def test_params_from_flax_maps_wdiag():
    """A learnable Wdiag travels with the kernel weights."""
    jhg, thg, x = _graphs(300, 150, seed=3)
    jmodel = JHGNN(nhid=8, nclass=NCLASS, learn_wdiag=True, backend="xla")
    jhgd = jhg.device_data()
    params = jmodel.init({"params": jax.random.key(1)}, jnp.asarray(x), jhgd)["params"]
    rng = np.random.default_rng(4)
    params = jax.tree_util.tree_map_with_path(
        lambda path, a: jnp.asarray(rng.uniform(0.5, 1.5, a.shape), a.dtype)
        if "wdiag" in jax.tree_util.keystr(path) else a, params)
    want = np.asarray(jmodel.apply({"params": params}, jnp.asarray(x), jhgd))

    sd = params_from_flax(params)
    assert set(sd) == {"convs.0.linear.weight", "convs.0.wdiag",
                       "convs.1.linear.weight", "convs.1.wdiag"}
    model = HGNN(NFEAT, 8, NCLASS, thg.num_edges, learn_wdiag=True, backend="xla")
    model.load_state_dict(sd)
    model.eval()
    with torch.no_grad():
        got = model(torch.as_tensor(x), thg.device_data("cpu")).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-3, atol=1e-3)  # f32 route


def test_serving_meta_and_shape_check():
    _, thg, x = _graphs(200, 100, seed=5)
    cfg = TrainConfig(nhid=8, backend="xla")
    server = ServingModel(cfg, thg, NFEAT, NCLASS, "cpu")
    jax_fields = {"model", "nhid", "nlayer", "nhead", "first_aggr", "nclass", "input_shape",
                  "input_dtype", "output_shape", "graph", "num_nodes", "num_edges", "nnz",
                  "platforms", "hypergef_version", "payload_bytes"}
    assert set(server.meta) == jax_fields
    assert server.meta["input_shape"] == [200, NFEAT]
    assert server.meta["output_shape"] == [200, NCLASS]
    assert server.meta["nnz"] == thg.nnz
    with pytest.raises(ValueError, match="shape"):
        server.predict(x[:, :-1])
    assert server.plan is None  # the xla route needs no table


def test_seeded_weights_are_reproducible():
    _, thg, _ = _graphs(200, 100, seed=6)
    a = build_model("HGNN", NFEAT, 8, NCLASS, thg.num_edges, device="cpu", seed=1).state_dict()
    b = build_model("HGNN", NFEAT, 8, NCLASS, thg.num_edges, device="cpu", seed=1).state_dict()
    c = build_model("HGNN", NFEAT, 8, NCLASS, thg.num_edges, device="cpu", seed=2).state_dict()
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["convs.0.linear.weight"], c["convs.0.linear.weight"])
    w = a["convs.0.linear.weight"]
    std = (1.0 / NFEAT) ** 0.5 / 0.87962566103423978
    assert float(w.abs().max()) <= 2 * std  # flax's truncated lecun_normal


def test_serving_passes_its_plan_to_every_layer():
    _, thg, x = _graphs(200, 100, seed=7)
    plan = AggregationPlan.dense_plan(thg, "cpu")
    server = ServingModel(TrainConfig(nhid=8, backend="dense"), thg, NFEAT, NCLASS, "cpu",
                          plan=plan)
    assert server.plan is plan
    ref = ServingModel(TrainConfig(nhid=8, backend="xla"), thg, NFEAT, NCLASS, "cpu")
    np.testing.assert_allclose(server.predict(x).numpy(), ref.predict(x).numpy(),
                               rtol=0, atol=3e-2)


def test_train_config_matches_jax():
    ours = {f.name: f.default for f in dataclasses.fields(TrainConfig)}
    theirs = {f.name: f.default for f in dataclasses.fields(JTrainConfig)}
    assert ours == theirs
