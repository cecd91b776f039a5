"""The port's training slice against the JAX package's, on the CPU.

Same NumPy inputs into both packages; JAX runs its Pallas kernels in
interpret mode, as its own tests do. Tolerances:

* splits: exact (the same NumPy code);
* the ``pallas`` route's gradients (the fused dense op's backward, through
  ``scale_e`` into a learned ``wdiag``): 3e-2, the bf16 tolerance of
  tests/test_fuzz_backends.py:54;
* ``Trainer`` against JAX's ``Trainer``, dropout off, the same initial
  weights (``params_from_flax``) and split, 40 epochs: the losses of the
  first 10 epochs within rtol 1e-3 and the final predictions agreeing on
  ≥ 98% of the nodes (ROADMAP.md, queue 1 item 5; the bar of
  tests/test_torch_parity.py). That holds on every route here, the bf16
  ``pallas`` route included.
"""

import dataclasses
import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import hypergef_tpu.data.synthetic as jsyn
from hypergef_tpu.ops import pallas_kernels as jpk
from hypergef_tpu.sparse.planner import plan_aggregation
from hypergef_tpu.sparse.planner import plan_pallas_sparse as jplan_pallas_sparse
from hypergef_tpu.train import splits as jsplits
from hypergef_tpu.train.trainer import TrainConfig as JTrainConfig
from hypergef_tpu.train.trainer import Trainer as JTrainer

import hypergef_tpu_torch.data.synthetic as tsyn
from hypergef_tpu_torch.models.convert import params_from_flax
from hypergef_tpu_torch.models.zoo import dropout
from hypergef_tpu_torch.ops import ell_gather, fused, fused_dense
from hypergef_tpu_torch.sparse.planner import AggregationPlan, plan_pallas_sparse
from hypergef_tpu_torch.train import splits
from hypergef_tpu_torch.train.trainer import (
    TrainConfig,
    Trainer,
    default_plan,
    make_optimizer,
    train_full_batch,
)

NFEAT, NCLASS = 12, 3


@pytest.fixture(autouse=True)
def deterministic():
    prev = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    yield
    torch.use_deterministic_algorithms(prev)


@pytest.mark.parametrize("balance", [False, True])
@pytest.mark.parametrize("seed", [0, 2, 11])
def test_splits_are_bit_equal(balance, seed):
    rng = np.random.default_rng(seed)
    y = rng.integers(-1, 4, size=257)
    if balance:
        y = np.abs(y)
    for train_prop, valid_prop in ((0.5, 0.25), (0.1, 0.1)):
        want = jsplits.rand_train_test_idx(y, train_prop, valid_prop, balance=balance, seed=seed)
        got = splits.rand_train_test_idx(y, train_prop, valid_prop, balance=balance, seed=seed)
        assert set(got) == set(want)
        for name in want:
            assert got[name].dtype == want[name].dtype
            np.testing.assert_array_equal(got[name], want[name])
    z = rng.normal(size=(257, 4))
    assert splits.accuracy(z, y) == jsplits.accuracy(z, y)


@pytest.mark.parametrize("aggr", ["sum", "mean"])
@pytest.mark.parametrize("n,e,f", [(120, 80, 8), (301, 187, 17)])
def test_pallas_route_gradients_match_jax(aggr, n, e, f):
    """dx, and d wdiag through the op's d scale_e, against jax.grad of
    the Pallas route (interpret mode)."""
    jhg = jsyn.random_hypergraph(n, e, avg_edge_size=5.0, seed=n)
    thg = tsyn.random_hypergraph(n, e, avg_edge_size=5.0, seed=n)
    rng = np.random.default_rng(e)
    x = rng.normal(size=(n, f)).astype(np.float32)
    w = rng.uniform(0.5, 1.5, (e, 1)).astype(np.float32)
    cot = rng.normal(size=(n, f)).astype(np.float32)
    jhgd, jplan = jhg.device_data(), plan_aggregation(jhg)

    def loss(xv, wv):
        return jnp.sum(jpk.hgnn_aggregate_pallas(jhgd, xv, wv, aggr, jplan, interpret=True) * cot)

    want_dx, want_dw = (np.asarray(t) for t in jax.grad(loss, argnums=(0, 1))(
        jnp.asarray(x), jnp.asarray(w)))
    xt = torch.as_tensor(x).requires_grad_(True)
    wt = torch.as_tensor(w).requires_grad_(True)
    out = fused.hgnn_aggregate(thg.device_data("cpu"), xt, wt, aggr,
                               plan=AggregationPlan.dense_plan(thg, "cpu"), backend="pallas")
    (out * torch.as_tensor(cot)).sum().backward()
    np.testing.assert_allclose(xt.grad.numpy(), want_dx, rtol=3e-2, atol=3e-2)
    np.testing.assert_allclose(wt.grad.numpy(), want_dw, rtol=3e-2, atol=3e-2)


@functools.lru_cache(maxsize=None)
def _problem(n, e, seed):
    jhg, y = jsyn.homophilic_hypergraph(n, e, NCLASS, avg_edge_size=5.0, seed=seed)
    thg, _ = tsyn.homophilic_hypergraph(n, e, NCLASS, avg_edge_size=5.0, seed=seed)
    x, _ = jsyn.random_features(n, NFEAT, NCLASS, seed=seed + 1)
    split = jsplits.rand_train_test_idx(y, seed=2)
    return jhg, thg, x, y, split


TRAIN_CASES = [
    ("xla", "sum", 2),
    ("tree", "sum", 2),
    ("tree", "mean", 3),
    ("pallas_sparse", "sum", 2),
    ("pallas_sparse", "mean", 3),
    ("pallas", "sum", 2),
]


@pytest.mark.parametrize("backend,first_aggr,nlayer", TRAIN_CASES)
def test_trainer_matches_jax_trainer(backend, first_aggr, nlayer):
    jhg, thg, x, y, split = _problem(240, 120, seed=5)
    jcfg = JTrainConfig(model="HGNN", nhid=8, nlayer=nlayer, first_aggr=first_aggr,
                        dropout=0.0, input_drop=0.0, epochs=40, warmup=0, seed=0,
                        backend=backend)
    jplan = jplan_pallas_sparse(jhg, impl="vmem") if backend == "pallas_sparse" else None
    jtr = JTrainer(jcfg, jhg, x, y, nclass=NCLASS, plan=jplan)
    params = params_from_flax(jtr.params)
    want = [jtr.fit(split["train"], epochs=1, warmup=0)["final_loss"] for _ in range(40)]
    want_pred = np.asarray(jtr._forward(jtr.params, jtr.x)).argmax(1)

    cfg = TrainConfig(**dataclasses.asdict(jcfg))
    plan = plan_pallas_sparse(thg) if backend == "pallas_sparse" else None
    before = (fused_dense.launches, ell_gather.launches)
    tr = Trainer(cfg, thg, x, y, nclass=NCLASS, plan=plan, device="cpu", params=params)
    res = tr.fit(split["train"])
    assert (fused_dense.launches, ell_gather.launches) == before  # plain versions on the CPU
    assert res["epochs"] == 40 and res["timer"] == "host_clock"
    assert res["final_loss"] == res["losses"][-1]
    np.testing.assert_allclose(res["losses"][:10], want[:10], rtol=1e-3)
    got_pred = tr.predict().argmax(1).numpy()
    assert (got_pred == want_pred).mean() >= 0.98


def test_train_full_batch_learns_and_reports():
    _, thg, x, y, split = _problem(240, 120, seed=5)
    cfg = TrainConfig(model="HGNN", nhid=8, epochs=30, warmup=2, backend="tree")
    res = train_full_batch(cfg, thg, x, y, split, nclass=NCLASS, device="cpu")
    assert set(res) >= {"train_epoch_time_s", "timer", "final_loss", "losses", "epochs",
                        "inference_time_s", "train_acc", "valid_acc", "test_acc"}
    assert res["losses"].shape == (30,) and np.isfinite(res["losses"]).all()
    assert res["losses"][-1] < res["losses"][0]
    assert res["train_acc"] > 100.0 / NCLASS


def test_dropout_masks_come_from_the_generator():
    """Dropout keeps 1 - rate of the entries, scaled by 1/(1 - rate), from
    the generator it is given; a Trainer re-seeds it at every fit, so two
    fits from the same state give the same losses."""
    x = torch.ones((400, 50))
    a = dropout(x, 0.6, True, torch.Generator().manual_seed(3))
    b = dropout(x, 0.6, True, torch.Generator().manual_seed(3))
    assert torch.equal(a, b)
    assert set(torch.unique(a).tolist()) == {0.0, 2.5}
    assert abs(float((a != 0).float().mean()) - 0.4) < 0.02
    assert dropout(x, 0.6, False, None) is x
    _, thg, xf, y, split = _problem(240, 120, seed=5)
    cfg = TrainConfig(model="HGNN", nhid=8, epochs=5, warmup=0, backend="xla")
    runs = []
    for _ in range(2):
        tr = Trainer(cfg, thg, xf, y, nclass=NCLASS, device="cpu")
        runs.append(tr.fit(split["train"])["losses"])
    np.testing.assert_array_equal(runs[0], runs[1])


def test_optimizer_is_adam_with_l2_in_the_gradient():
    """One step from a zero state: Adam's first update is -lr·sign-like
    (m̂/√v̂ = g/|g|) of the gradient plus wd·param."""
    p = torch.nn.Parameter(torch.tensor([1.0, -2.0, 0.5]))
    opt = make_optimizer([p], lr=0.1, wd=0.5)
    p.grad = torch.tensor([0.2, 0.3, -0.25])
    opt.step()
    g = np.array([0.2, 0.3, -0.25]) + 0.5 * np.array([1.0, -2.0, 0.5])
    want = np.array([1.0, -2.0, 0.5]) - 0.1 * g / (np.abs(g) + 1e-8)
    np.testing.assert_allclose(p.detach().numpy(), want, rtol=1e-6)


def test_trainer_plans_and_unported_options(tmp_path, monkeypatch):
    _, thg, x, y, _ = _problem(240, 120, seed=5)
    assert default_plan("xla", thg, "cpu") is None
    assert default_plan("pallas", thg, "cpu").dense is not None
    assert default_plan("tree", thg, "cpu").tree.form == "xla"
    with pytest.raises(ValueError, match="plan_pallas_sparse"):
        Trainer(TrainConfig(backend="pallas_sparse"), thg, x, y, device="cpu")
    # auto takes the ladder's plan and cumsum none, as in JAX (trainer.py:88-99)
    assert Trainer(TrainConfig(backend="auto"), thg, x, y, device="cpu").plan.preferred_backend
    assert Trainer(TrainConfig(backend="cumsum"), thg, x, y, device="cpu").plan is None
    # tune and plan_cache are ported (trainer.py:82-99): a measured plan, and a
    # plan kept in the default directory (here a temporary one)
    from hypergef_tpu_torch.sparse import autotune

    monkeypatch.setenv("HYPERGEF_TORCH_TUNE_DIR", str(tmp_path / "tune"))
    monkeypatch.setenv("HYPERGEF_TORCH_PLAN_CACHE", str(tmp_path / "plans"))
    monkeypatch.setattr(autotune, "sweep",  # the sweep is timed in test_torch_port_autotune.py
                        lambda *a, **k: [autotune.TuneResult("tree", {"ngs": 8}, 1e-6)])
    tuned = Trainer(TrainConfig(tune=True), thg, x, y, device="cpu")
    assert tuned.plan.preferred_backend == "tree" and len(os.listdir(tmp_path / "tune")) == 1
    cached = Trainer(TrainConfig(backend="tree", plan_cache=""), thg, x, y, device="cpu")
    assert cached.plan.tree.form == "xla" and len(os.listdir(tmp_path / "plans")) == 1
    # checkpoints are ported: a round trip into a Trainer of another seed
    tr = Trainer(TrainConfig(backend="xla"), thg, x, y, device="cpu")
    with pytest.raises(FileNotFoundError):
        tr.restore(str(tmp_path / "ckpt"))
    tr.save(str(tmp_path / "ckpt"), step=4)
    other = Trainer(TrainConfig(backend="xla", seed=9), thg, x, y, device="cpu")
    assert other.restore(str(tmp_path / "ckpt")) == 4
    for a, b in zip(tr.model.state_dict().values(), other.model.state_dict().values()):
        assert torch.equal(a, b)


def test_trainer_runs_on_the_card_by_default():
    """Without ``device`` a Trainer (and train_full_batch) runs on the card;
    where there is none, construction raises instead of falling back."""
    _, thg, x, y, split = _problem(240, 120, seed=5)
    cfg = TrainConfig(model="HGNN", nhid=8, epochs=2, warmup=0, backend="xla")
    if torch.cuda.is_available():
        assert Trainer(cfg, thg, x, y, nclass=NCLASS).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            Trainer(cfg, thg, x, y, nclass=NCLASS)
        with pytest.raises(RuntimeError, match="device='cpu'"):
            train_full_batch(cfg, thg, x, y, split, nclass=NCLASS)
