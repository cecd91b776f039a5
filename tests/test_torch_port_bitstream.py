"""The port's bitstream route against the JAX package's, on the CPU.

Same NumPy inputs into ``hypergef_tpu`` and ``hypergef_tpu_torch``; JAX runs
on the CPU with its bitmm Pallas kernel in interpret mode, as
tests/test_bitstream.py runs it. JAX's ``plan_aggregation`` builds no
bitstream packs at these sizes, so its plans get
``plan.bitstream = BitIncidence.from_hypergraph(hg)`` (test_bitstream.py:123).
Tolerances:

* packs (words, m, k, padding): bit-equal;
* ``bit_matvec`` forward and x gradient: rtol 1e-6, atol 1e-6·max (exact
  products of bf16 values, f32 sums in another order);
* the route's outputs and gradients, sum, mean and max: rtol 1e-5, atol
  1e-5·max (the same, through two products and JAX's prefix-difference max
  backward at a few thousand nnz);
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
import scipy.sparse as sp
import torch

import hypergef_tpu.data.synthetic as jsyn
from hypergef_tpu.ops import bitstream as jbits
from hypergef_tpu.ops import fused as jfused
from hypergef_tpu.sparse.planner import plan_aggregation
from hypergef_tpu.train import splits as jsplits
from hypergef_tpu.train.trainer import TrainConfig as JTrainConfig
from hypergef_tpu.train.trainer import Trainer as JTrainer

import hypergef_tpu_torch.data.synthetic as tsyn
from hypergef_tpu_torch.models.convert import params_from_flax
from hypergef_tpu_torch.ops import bitstream, fused
from hypergef_tpu_torch.sparse.planner import AggregationPlan, plan_tree
from hypergef_tpu_torch.train.trainer import TrainConfig, Trainer, default_plan, device_plans

NFEAT, NCLASS = 12, 3
# (n, e, avg_edge_size, seed): the graph of tests/test_bitstream.py:19, and
# one with N and E past a K tile (4096), so each pack has kt >= 2
GRAPHS = {"small": (500, 300, 6.0, 0), "multi_tile": (5000, 4500, 3.0, 1)}


@pytest.fixture(autouse=True)
def deterministic():
    prev = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    yield
    torch.use_deterministic_algorithms(prev)


@functools.lru_cache(maxsize=None)
def _graphs(name):
    n, e, avg, seed = GRAPHS[name]
    jhg = jsyn.random_hypergraph(n, e, avg_edge_size=avg, seed=seed)
    thg = tsyn.random_hypergraph(n, e, avg_edge_size=avg, seed=seed)
    return jhg, thg, jbits.BitIncidence.from_hypergraph(jhg), bitstream.BitIncidence.from_hypergraph(thg)


def _x(rows, f, seed):
    return np.random.default_rng(seed).normal(size=(rows, f)).astype(np.float32)


def _close(got, want, rel):
    np.testing.assert_allclose(got, want, rtol=rel, atol=rel * float(np.abs(want).max()))


# ---- host half ---------------------------------------------------------


def _dense_cases():
    """The shapes of tests/test_bitstream.py:30, then rows and a whole
    matrix with no entries, and a full row."""
    rng = np.random.default_rng(0)
    cases = [(rng.random((m, k)) < 0.05).astype(np.uint8)
             for m, k in ((3, 5), (17, 4097), (128, 4096), (9, 12000))]
    empty_rows = (rng.random((40, 5000)) < 0.01).astype(np.uint8)
    empty_rows[::3] = 0
    full_row = np.zeros((4, 4100), np.uint8)
    full_row[2] = 1
    return cases + [empty_rows, np.zeros((6, 7), np.uint8), full_row]


@pytest.mark.parametrize("case", range(len(_dense_cases())))
def test_pack_bits_csr_is_bit_equal(case):
    dense = _dense_cases()[case]
    csr = sp.csr_matrix(dense)
    m, k = dense.shape
    want = jbits.pack_bits_csr(csr.indptr, csr.indices, m, k)
    got = bitstream.pack_bits_csr(csr.indptr, csr.indices, m, k)
    assert got.dtype == want.dtype == np.int32
    np.testing.assert_array_equal(got, want)
    # and the twin's unpack reads it back
    back = bitstream.unpack_rows(torch.as_tensor(got)).numpy()
    np.testing.assert_array_equal(back[:, :k], dense)
    assert not back[:, k:].any()


@pytest.mark.parametrize("name", list(GRAPHS))
def test_bit_incidence_is_bit_equal(name):
    jhg, thg, jbi, tbi = _graphs(name)
    assert (tbi.num_nodes, tbi.num_edges) == (jbi.num_nodes, jbi.num_edges)
    for jp, tp in ((jbi.h_pack, tbi.h_pack), (jbi.ht_pack, tbi.ht_pack)):
        assert (tp.m, tp.k, tp.mp, tp.kp) == (jp.m, jp.k, jp.mp, jp.kp)
        np.testing.assert_array_equal(tp.words, np.asarray(jp.words))
        assert tp.mp % 256 == 0 and not tp.words[tp.m:].any()  # pad rows are zero
    assert tbi.table_bytes() == jbi.table_bytes()
    if name == "multi_tile":
        assert tbi.h_pack.kp // bitstream.KTILE >= 2 and tbi.ht_pack.kp // bitstream.KTILE >= 2
    h, ht = tbi.device("cpu")
    assert tbi.device("cpu")[0] is h  # put on the device once
    assert h.words.dtype == torch.int32 and torch.equal(h.words, torch.as_tensor(tbi.h_pack.words))
    assert (ht.m, ht.k) == (thg.num_edges, thg.num_nodes)


def test_nonbinary_incidence_raises():
    class FakeHG:
        def to_scipy(self):
            return sp.csr_matrix(np.array([[2.0, 0.0], [0.0, 1.0]]))

    with pytest.raises(ValueError, match="binary"):
        jbits.BitIncidence.from_hypergraph(FakeHG())
    with pytest.raises(ValueError, match="binary"):
        bitstream.BitIncidence.from_hypergraph(FakeHG())


def test_twin_matches_scipy_on_multi_tile_packs():
    """The twin's row blocks (forced small here) and its K tiles against
    scipy on bf16-rounded x: exact products, f32 sums."""
    _, thg, _, tbi = _graphs("multi_tile")
    csr = thg.to_scipy().tocsr()
    h, ht = tbi.device("cpu")
    for pack, a in ((h, csr), (ht, csr.T.tocsr())):
        x = torch.as_tensor(_x(pack.k, 5, pack.m))
        want = a.astype(np.float64) @ bitstream.bf16_round(x).numpy().astype(np.float64)
        got = bitstream.bitmm_plain(pack.words, x, pack.m, pack.k, block_elems=3 * pack.kp + 7)
        _close(got.numpy(), want, 1e-6)


# ---- the op and the route ----------------------------------------------


@pytest.mark.parametrize("orient", ["ht", "h"])
@pytest.mark.parametrize("f", [3, 20])
def test_bit_matvec_and_gradient_match_jax(orient, f):
    _, _, jbi, tbi = _graphs("small")
    jpacks = (jbi.ht_pack, jbi.h_pack) if orient == "ht" else (jbi.h_pack, jbi.ht_pack)
    h, ht = tbi.device("cpu")
    tpacks = (ht, h) if orient == "ht" else (h, ht)
    x, cot = _x(jpacks[0].k, f, f), _x(jpacks[0].m, f, f + 1)
    out, vjp = jax.vjp(lambda a: jbits.bit_matvec(a, *jpacks), jnp.asarray(x))
    (want_dx,) = vjp(jnp.asarray(cot))
    xt = torch.as_tensor(x).requires_grad_(True)
    before = bitstream.launches
    got = bitstream.bit_matvec(xt, *tpacks)
    got.backward(torch.as_tensor(cot))
    assert bitstream.launches == before  # the twin on CPU tensors
    assert got.shape == (jpacks[0].m, f)
    _close(got.detach().numpy(), np.asarray(out), 1e-6)
    _close(xt.grad.numpy(), np.asarray(want_dx), 1e-6)


def _jax_plan(jhg, jbi):
    jplan = plan_aggregation(jhg)
    jplan.bitstream = jbi
    return jplan


@functools.lru_cache(maxsize=None)
def _jax_route(aggr, with_wdiag):
    jhg, _, jbi, _ = _graphs("small")
    x, w, cot = _route_inputs()
    hgd, jplan = jhg.device_data(), _jax_plan(jhg, jbi)

    def f(xv, wv):
        out = jfused.hgnn_aggregate(hgd, xv, wv if with_wdiag else None, aggr, plan=jplan,
                                    backend="bitstream")
        return jnp.sum(out * cot), out

    (_, out), (dx, dw) = jax.value_and_grad(f, argnums=(0, 1), has_aux=True)(
        jnp.asarray(x), jnp.asarray(w))
    return np.asarray(out), np.asarray(dx), np.asarray(dw)


def _route_inputs():
    n, e = GRAPHS["small"][:2]
    rng = np.random.default_rng(9)
    return (rng.normal(size=(n, 6)).astype(np.float32),
            rng.uniform(0.5, 1.5, (e, 1)).astype(np.float32),
            rng.normal(size=(n, 6)).astype(np.float32))


@pytest.mark.parametrize("aggr", ["sum", "mean", "max"])
@pytest.mark.parametrize("with_wdiag", [False, True])
def test_bitstream_route_and_gradients_match_jax(aggr, with_wdiag):
    """Max runs the tree argmax V→E and the bitstream E→V (fused.py:239-243)."""
    _, thg, _, tbi = _graphs("small")
    x, w, cot = _route_inputs()
    want_out, want_dx, want_dw = _jax_route(aggr, with_wdiag)
    plan = AggregationPlan(bitstream=tbi, tree=plan_tree(thg) if aggr == "max" else None)
    xt = torch.as_tensor(x).requires_grad_(True)
    wt = torch.as_tensor(w).requires_grad_(True)
    out = fused.hgnn_aggregate(thg.device_data("cpu"), xt, wt if with_wdiag else None, aggr,
                               plan=plan, backend="bitstream")
    (out * torch.as_tensor(cot)).sum().backward()
    _close(out.detach().numpy(), want_out, 1e-5)
    _close(xt.grad.numpy(), want_dx, 1e-5)
    if with_wdiag:
        _close(wt.grad.numpy(), want_dw, 1e-5)


def test_bitstream_route_refusals():
    _, thg, _, tbi = _graphs("small")
    hgd, x = thg.device_data("cpu"), torch.as_tensor(_x(thg.num_nodes, 4, 0))
    with pytest.raises(ValueError, match="BitIncidence"):
        fused.hgnn_aggregate(hgd, x, plan=AggregationPlan(tree=plan_tree(thg)),
                             backend="bitstream")
    with pytest.raises(ValueError, match="record table"):  # max needs the tree
        fused.hgnn_aggregate(hgd, x, None, "max", plan=AggregationPlan(bitstream=tbi),
                             backend="bitstream")
    with pytest.raises(ValueError, match="first_aggr"):
        bitstream.hgnn_aggregate_bitstream(hgd, x, None, "max", tbi)
    h, _ = tbi.device("cpu")
    with pytest.raises(RuntimeError, match="bit_matvec"):
        bitstream.bitmm(h.words, torch.zeros((h.k, 2), requires_grad=True), h.m, h.k)
    # a raw BitIncidence serves as the plan, as a raw TreePlan does
    got = fused.hgnn_aggregate(hgd, x, plan=tbi, backend="bitstream")
    want = fused.hgnn_aggregate(hgd, x, plan=AggregationPlan(bitstream=tbi), backend="bitstream")
    assert torch.equal(got, want)


# ---- training ----------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _problem():
    jhg, y = jsyn.homophilic_hypergraph(240, 120, NCLASS, avg_edge_size=5.0, seed=5)
    thg, _ = tsyn.homophilic_hypergraph(240, 120, NCLASS, avg_edge_size=5.0, seed=5)
    x, _ = jsyn.random_features(240, NFEAT, NCLASS, seed=6)
    return jhg, thg, x, y, jsplits.rand_train_test_idx(y, seed=2)


@pytest.mark.parametrize("model,first_aggr", [("HGNN", "sum"), ("HGNN", "max"),
                                              ("UniGCNII", "sum")])
def test_trainer_matches_jax_trainer_on_bitstream(model, first_aggr):
    """JAX's Trainer on plan_aggregation + the packs, the port's on its
    default plan (no ``plan=``), from the same weights, dropout off, 40
    epochs."""
    jhg, thg, x, y, split = _problem()
    jcfg = JTrainConfig(model=model, nhid=8, nlayer=2, first_aggr=first_aggr, dropout=0.0,
                        input_drop=0.0, epochs=40, warmup=0, seed=0, backend="bitstream")
    jtr = JTrainer(jcfg, jhg, x, y, nclass=NCLASS,
                   plan=_jax_plan(jhg, jbits.BitIncidence.from_hypergraph(jhg)))
    params = params_from_flax(jtr.params)
    want = [jtr.fit(split["train"], epochs=1, warmup=0)["final_loss"] for _ in range(40)]
    want_pred = np.asarray(jtr._forward(jtr.params, jtr.x)).argmax(1)

    cfg = TrainConfig(**dataclasses.asdict(jcfg))
    before = bitstream.launches
    tr = Trainer(cfg, thg, x, y, nclass=NCLASS, device="cpu", params=params)
    assert isinstance(tr.plan.bitstream, bitstream.BitIncidence)
    assert (tr.plan.tree is not None) == (first_aggr == "max")
    res = tr.fit(split["train"])
    assert bitstream.launches == before
    np.testing.assert_allclose(res["losses"][:10], want[:10], rtol=1e-3)
    assert (tr.predict().argmax(1).numpy() == want_pred).mean() >= 0.98


def test_default_plan_puts_the_packs_on_the_device():
    _, thg, x, y, _ = _problem()
    plan = default_plan("bitstream", thg, "cpu")
    assert (plan.dense, plan.tree, plan.aligned) == (None, None, None)
    assert device_plans(plan) == [plan.bitstream] and not plan.bitstream._device
    assert default_plan("bitstream", thg, "cpu", "max").tree is not None
    tr = Trainer(TrainConfig(backend="bitstream", nhid=4), thg, x, y, device="cpu")
    assert torch.device("cpu") in tr.plan.bitstream._device  # built here, not in a step
    assert device_plans(tr.plan.bitstream) == [tr.plan.bitstream]
