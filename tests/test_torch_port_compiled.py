"""The port's compiled step, its differenced timers and its checkpoints, on the CPU.

On the card a ``Trainer`` step, its forward and a ``ServingModel``
request are CUDA-graph replays (``hypergef_tpu_torch.utils.graphs``); the
CPU runs them eagerly, so these tests hold what the graphs rest on:

* (a) a step reads nothing back from the device on any route (the calls
  that would are counted and must be 0), but for the plain aligned max
  form, which refuses to be captured with a named error;
* (b) ``epoch_device_time`` and ``epoch_device_time_stats`` return JAX's
  keys and leave the parameters, Adam's state and the generator bitwise
  as they were;
* (c) checkpoints against JAX's (``tests/test_cli_and_utils.py:106-185``):
  round trip, no checkpoint, ``max_to_keep``, ``step=None``, background
  writes; ``Trainer.restore`` copies in place and a restored run goes on
  bitwise;
* (d) a JAX run's whole training state (``params_from_flax``,
  ``opt_state_from_optax``) goes on in the port: the next losses within
  rtol 1e-3 of JAX's (the f32 routes' bar of ROADMAP.md).
"""

import dataclasses
import functools

import numpy as np
import pytest
import torch

import hypergef_tpu.data.synthetic as jsyn
from hypergef_tpu.train import splits as jsplits
from hypergef_tpu.train.trainer import TrainConfig as JTrainConfig
from hypergef_tpu.train.trainer import Trainer as JTrainer

import hypergef_tpu_torch.data.synthetic as tsyn
from hypergef_tpu_torch.models.convert import opt_state_from_optax, params_from_flax
from hypergef_tpu_torch.serve import ServingModel
from hypergef_tpu_torch.sparse.planner import plan_pallas_sparse
from hypergef_tpu_torch.sparse.reorder import community_reorder
from hypergef_tpu_torch.train.checkpoint import restore_checkpoint, save_checkpoint
from hypergef_tpu_torch.train.splits import rand_train_test_idx
from hypergef_tpu_torch.train.trainer import TrainConfig, Trainer
from hypergef_tpu_torch.utils import graphs

NCLASS = 3
JAX_STATS_KEYS = {"median_s", "min_s", "max_s", "windows", "iters", "samples_s"}


@pytest.fixture(autouse=True)
def deterministic():
    prev = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    yield
    torch.use_deterministic_algorithms(prev)


@functools.lru_cache(maxsize=None)
def _graphs():
    hg, y = tsyn.homophilic_hypergraph(160, 100, NCLASS, avg_edge_size=5.0, seed=3)
    sbm, _ = community_reorder(tsyn.community_hypergraph(240, 160, 8, 5, 0.02, 3))
    return hg, y, sbm


def _trainer(route="xla", aggr="sum", **cfg):
    hg, y, sbm = _graphs()
    g = sbm if route == "aligned" else hg
    rng = np.random.default_rng(7)
    yy = y if g is hg else rng.integers(0, NCLASS, g.num_nodes)
    x = rng.normal(size=(g.num_nodes, 6)).astype(np.float32)
    plan = plan_pallas_sparse(g) if route == "pallas_sparse" else None
    tcfg = TrainConfig(model="HGNN", nhid=8, first_aggr=aggr, backend=route, epochs=3,
                       warmup=0, **cfg)
    tr = Trainer(tcfg, g, x, yy, nclass=NCLASS, plan=plan, device="cpu")
    return tr, rand_train_test_idx(yy, seed=2)["train"]


def _state_copy(tr):
    return ([t.clone() for t in tr.model.state_dict().values()],
            [t.clone() for st in tr.opt_state.values() for t in st.values()],
            tr.generator.get_state().clone())


def _assert_state_equal(a, b):
    for xs, ys in zip(a[:2], b[:2]):
        assert len(xs) == len(ys)
        for x, y in zip(xs, ys):
            assert torch.equal(x, y)
    assert torch.equal(a[2], b[2])


ROUTES = [(r, a) for r in ("xla", "cumsum", "tree", "dense", "pallas", "pallas_sparse",
                           "aligned", "bitstream", "precomp") for a in ("sum", "max")]
# (owner, name): the calls that read the device back to the host
HOST_READS = [(torch.Tensor, n) for n in ("item", "tolist", "cpu", "numpy", "__bool__",
                                         "nonzero")] + [(torch, "nonzero"),
                                                        (torch.cuda, "synchronize")]


@pytest.mark.parametrize("route,aggr", ROUTES)
def test_a_step_reads_nothing_back(route, aggr, monkeypatch):
    """After one warm-up step, a step makes none of the calls that read the
    device from the host, nor copies NumPy data to it. Adam's own update
    is left out: on the CPU it keeps its step count on the host
    (``capturable=False``); on the card it is capturable and the graph
    holds it. The plain aligned max form is the exception: it reads which
    entries are live (``ops/aligned_max.py::live_pairs``)."""
    tr, idx = _trainer(route, aggr)
    idx = torch.as_tensor(idx)
    tr.step(idx)
    counts = {}
    counting = [True]

    def counted(name, orig, numpy_only=False):
        def call(*a, **k):
            if counting[0] and (not numpy_only or isinstance(a[0], np.ndarray)):
                counts[name] = counts.get(name, 0) + 1
            return orig(*a, **k)
        return call

    for owner, name in HOST_READS:
        monkeypatch.setattr(owner, name, counted(name, getattr(owner, name)))
    for name in ("as_tensor", "from_numpy"):
        monkeypatch.setattr(torch, name, counted(name, getattr(torch, name), numpy_only=True))
    adam_step = tr.optimizer.step

    def uncounted_step(*a, **k):
        counting[0] = False
        try:
            return adam_step(*a, **k)
        finally:
            counting[0] = True

    monkeypatch.setattr(tr.optimizer, "step", uncounted_step)
    loss = tr.step(idx)
    monkeypatch.undo()
    assert np.isfinite(float(loss))
    if (route, aggr) == ("aligned", "max"):
        assert counts.get("nonzero", 0) > 0
    else:
        assert counts == {}


def test_plain_aligned_max_refuses_capture(monkeypatch):
    """Inside a capture the plain aligned max form raises CaptureError,
    naming the kernel form and compiled=False."""
    tr, idx = _trainer("aligned", "max")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing", lambda: True)
    with pytest.raises(graphs.CaptureError, match="pallas_.*compiled=False"):
        tr.step(torch.as_tensor(idx))


def test_compiled_switch_on_the_cpu():
    """None runs eagerly on the CPU, True there raises (jax.disable_jit's
    counterpart); a fit says which form ran."""
    tr, idx = _trainer("tree")
    assert tr.compiled is False
    res = tr.fit(idx, epochs=2)
    assert (res["step"], res["capture_s"], res["capture_warmup"]) == ("eager", 0.0, 0)
    hg, y, _ = _graphs()
    x = np.zeros((hg.num_nodes, 6), np.float32)
    with pytest.raises(ValueError, match="compiled=True needs a CUDA device"):
        Trainer(TrainConfig(backend="xla"), hg, x, y, device="cpu", compiled=True)
    with pytest.raises(ValueError, match="compiled=True needs a CUDA device"):
        ServingModel(TrainConfig(backend="xla"), hg, 6, NCLASS, "cpu", compiled=True)
    server = ServingModel(TrainConfig(backend="xla"), hg, 6, NCLASS, "cpu")
    assert server.compiled is False and server.capture_s == 0.0
    assert server.meta["payload_bytes"] is None


def test_adam_state_is_built_at_construction():
    """Adam's state exists before the first step (JAX's tx.init), so no
    step allocates it; a step updates it in place."""
    tr, idx = _trainer("cumsum")
    ptrs = {k: {n: t.data_ptr() for n, t in st.items()} for k, st in tr.opt_state.items()}
    assert set(ptrs) == set(dict(tr.model.named_parameters()))
    for st in tr.opt_state.values():
        assert float(st["step"]) == 0.0 and not st["exp_avg"].any()
    tr.fit(idx, epochs=2)
    for k, st in tr.opt_state.items():
        assert float(st["step"]) == 2.0
        assert {n: t.data_ptr() for n, t in st.items()} == ptrs[k]


@pytest.mark.parametrize("route", ["xla", "cumsum"])
def test_epoch_device_time_keeps_the_state(route):
    """JAX's keys (and ``timer``); parameters, Adam's state and the
    generator bitwise unchanged, dropout on."""
    tr, idx = _trainer(route)
    tr.fit(idx, epochs=2)
    before = _state_copy(tr)
    st = tr.epoch_device_time_stats(idx, iters=2, windows=3, repeats=2)
    assert JAX_STATS_KEYS <= set(st) and st["timer"] == "host_clock"
    assert st["windows"] == 3 and len(st["samples_s"]) == 3 and st["iters"] == 2
    assert st["min_s"] <= st["median_s"] <= st["max_s"]
    t = tr.epoch_device_time(idx, iters=2)
    assert t >= 0.0
    _assert_state_equal(before, _state_copy(tr))
    # the state the windows left gives the losses it gave before them
    again = Trainer(tr.cfg, tr.hg, tr.x.numpy(), tr.y.numpy(), nclass=NCLASS, device="cpu",
                    params=tr.model.state_dict(), opt_state=tr.opt_state)
    np.testing.assert_array_equal(tr.fit(idx, epochs=2)["losses"],
                                  again.fit(idx, epochs=2)["losses"])


def test_stats_keys_and_min_window_rule_match_jax():
    """The same keys as JAX's ``epoch_device_time_stats`` and its min-window
    rule (``tests/test_cli_and_utils.py:187-220``), the windows stubbed."""
    jhg, jy = jsyn.homophilic_hypergraph(60, 40, NCLASS, avg_edge_size=4.0, seed=31)
    jx, _ = jsyn.random_features(jhg.num_nodes, 6, NCLASS, seed=32)
    jtr = JTrainer(JTrainConfig(model="HGNN", nhid=8, epochs=1, warmup=0), jhg, jx, jy)
    tr, idx = _trainer("xla")
    for trainer in (jtr, tr):
        seen = []

        def fixed(train_idx, iters, windows, repeats, seen=seen):
            seen.append(iters)
            return [0.001] * windows

        trainer._epoch_windows = fixed
        st = trainer.epoch_device_time_stats(idx, iters=2, windows=1, repeats=1,
                                             min_window_s=0.05)
        assert st["iters"] == 50 and seen == [2, 50]
        keys = set(st) - {"timer"}
        assert keys == JAX_STATS_KEYS


def test_checkpoint_roundtrip(tmp_path):
    """JAX's test_checkpoint_roundtrip, with max_to_keep, step=None, an
    explicit step and a background write."""
    params = {"w": torch.arange(6.0).reshape(2, 3), "b": torch.zeros(3)}
    opt_state = {"w": {"step": torch.tensor(7.0), "m": torch.ones(2, 3)}}
    ck = str(tmp_path / "ck")
    save_checkpoint(ck, 7, params, opt_state)
    step, p2, o2 = restore_checkpoint(ck, params_template=params, opt_state_template=opt_state)
    assert step == 7
    assert torch.equal(p2["w"], params["w"]) and torch.equal(o2["w"]["m"], opt_state["w"]["m"])
    with pytest.raises(FileNotFoundError):
        restore_checkpoint(str(tmp_path / "nope"), params, opt_state)
    with pytest.raises(FileNotFoundError):
        restore_checkpoint(ck, params, opt_state, step=6)
    for s in (8, 9, 10):
        save_checkpoint(ck, s, {k: v + s for k, v in params.items()}, opt_state,
                        wait=(s != 10), max_to_keep=3)
    step, p3, _ = restore_checkpoint(ck, params, opt_state)  # joins the background write
    assert step == 10 and torch.equal(p3["w"], params["w"] + 10)
    assert sorted(int(d.name) for d in (tmp_path / "ck").iterdir()) == [8, 9, 10]
    step, p4, _ = restore_checkpoint(ck, params, opt_state, step=8)
    assert step == 8 and torch.equal(p4["b"], params["b"] + 8)
    with pytest.raises(ValueError, match="keys"):
        restore_checkpoint(ck, {"w": params["w"]}, opt_state)


def test_trainer_restore_continues_bitwise(tmp_path):
    """JAX's test_trainer_save_restore_methods, and more: restore copies
    into the existing tensors (every data_ptr kept), and a fit after it
    gives bitwise the losses of the run that was not interrupted."""
    tr, idx = _trainer("cumsum")
    tr.fit(idx, epochs=3)
    tr.save(str(tmp_path / "ck"), step=3)
    want = tr.fit(idx, epochs=3)["losses"]
    other, _ = _trainer("cumsum")
    other.fit(idx, epochs=2)  # a state of its own, which the restore overwrites
    ptrs = [t.data_ptr() for t in other._state()]
    assert other.restore(str(tmp_path / "ck")) == 3
    assert [t.data_ptr() for t in other._state()] == ptrs
    np.testing.assert_array_equal(other.fit(idx, epochs=3)["losses"], want)


@pytest.mark.parametrize("route", ["xla", "cumsum", "tree"])
def test_jax_training_state_carries_across(route):
    """A JAX Trainer fits 3 epochs without dropout; its params and optax
    state go into a port Trainer, whose next 4 losses are JAX's next 4
    within rtol 1e-3."""
    jhg, jy = jsyn.homophilic_hypergraph(120, 80, NCLASS, avg_edge_size=5.0, seed=5)
    thg, _ = tsyn.homophilic_hypergraph(120, 80, NCLASS, avg_edge_size=5.0, seed=5)
    x, _ = jsyn.random_features(120, 6, NCLASS, seed=6)
    split = jsplits.rand_train_test_idx(jy, seed=2)
    jcfg = JTrainConfig(model="HGNN", nhid=8, dropout=0.0, input_drop=0.0, epochs=3,
                        warmup=0, seed=0, backend=route)
    jtr = JTrainer(jcfg, jhg, x, jy, nclass=NCLASS)
    jtr.fit(split["train"], epochs=3, warmup=0)
    params = params_from_flax(jtr.params)
    opt_state = opt_state_from_optax(jtr.opt_state, jtr.params)
    assert set(opt_state) == set(params)
    assert all(float(st["step"]) == 3.0 for st in opt_state.values())
    want = [jtr.fit(split["train"], epochs=1, warmup=0)["final_loss"] for _ in range(4)]
    tr = Trainer(TrainConfig(**dataclasses.asdict(jcfg)), thg, x, jy, nclass=NCLASS,
                 device="cpu", params=params, opt_state=opt_state)
    got = tr.fit(split["train"], epochs=4)["losses"]
    np.testing.assert_allclose(got, want, rtol=1e-3)
    with pytest.raises(ValueError, match="ScaleByAdamState"):
        opt_state_from_optax((), jtr.params)
