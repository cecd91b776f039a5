"""The port's plan cache (``sparse/plancache.py``), on the CPU.

* Every plan type round-trips bit-exact (arrays and tensors of the same
  dtype and values, the same fields): the tree, the aligned plan in its
  plain and kernel forms, the int8 dense table, the bf16 propagation
  matrix, the bit packs and the ladder's plan; the fused op on a loaded plan
  gives the same output, bitwise.
* The key follows the graph's content, the keyword arguments and the
  device type; a file that cannot be read is rebuilt; classes outside
  ``hypergef_tpu_torch`` (the JAX package's among them) are refused, and
  a file the JAX package wrote is never served.
* ``Trainer(TrainConfig(plan_cache=DIR))`` builds once, then loads, and
  both trainers' losses are bitwise equal.
"""

import dataclasses
import os

import numpy as np
import pytest
import torch

from hypergef_tpu.data.synthetic import random_hypergraph as jrandom_hypergraph
from hypergef_tpu.sparse import plancache as jplancache
from hypergef_tpu.sparse.planner import plan_aggregation as jplan_aggregation

import hypergef_tpu_torch.data.synthetic as tsyn
from hypergef_tpu_torch.ops import fused
from hypergef_tpu_torch.ops.bitstream import BitIncidence
from hypergef_tpu_torch.sparse import plancache, planner
from hypergef_tpu_torch.sparse.reorder import community_reorder
from hypergef_tpu_torch.train.trainer import TrainConfig, Trainer

CPU = torch.device("cpu")


def assert_same(a, b, path="plan"):
    assert type(a) is type(b), f"{path}: {type(a)} != {type(b)}"
    if isinstance(a, torch.Tensor):
        assert a.dtype == b.dtype and a.device == b.device, path
        assert torch.equal(a, b), path
        return
    if isinstance(a, np.ndarray):
        assert a.dtype == b.dtype, f"{path}: dtype {a.dtype} != {b.dtype}"
        np.testing.assert_array_equal(a, b, err_msg=path)
        return
    if dataclasses.is_dataclass(a) and not isinstance(a, type):
        for f in dataclasses.fields(a):
            if not f.name.startswith("_"):
                assert_same(getattr(a, f.name), getattr(b, f.name), f"{path}.{f.name}")
        return
    if isinstance(a, tuple) and hasattr(a, "_fields"):
        for n in a._fields:
            assert_same(getattr(a, n), getattr(b, n), f"{path}.{n}")
        return
    if isinstance(a, (tuple, list)):
        assert len(a) == len(b), f"{path}: len {len(a)} != {len(b)}"
        for i, (x, y) in enumerate(zip(a, b)):
            assert_same(x, y, f"{path}[{i}]")
        return
    assert a == b, f"{path}: {a!r} != {b!r}"


def _sorted_graph():
    hg = tsyn.community_hypergraph(900, 700, 12, 5, 0.05, 7)
    return community_reorder(hg)[0]


def _plans():
    """name -> (graph, plan, the route the plan serves)."""
    small = tsyn.random_hypergraph(150, 90, avg_edge_size=4.0, seed=11)
    sbm = _sorted_graph()
    aligned = planner.plan_aligned(sbm)
    ladder_small, ladder_sorted = (planner.plan_aggregation(g, CPU) for g in (small, sbm))
    return {
        "tree": (small, planner.plan_tree(small), "tree"),
        "aligned": (sbm, aligned, "aligned"),
        "aligned_kernel_form": (sbm, dataclasses.replace(aligned, form="pallas_auto"),
                                "aligned"),
        "aligned_uniform": (sbm, planner.plan_aligned(sbm, form="uniform"), "aligned"),
        "dense_int8": (small, planner.AggregationPlan.dense_plan(small, CPU), "dense"),
        "precomp_bf16": (small, planner.AggregationPlan(
            precomp=planner.DensePrecomp.from_hypergraph(small, CPU)), "precomp"),
        "bitstream": (small, planner.AggregationPlan(
            bitstream=BitIncidence.from_hypergraph(small)), "bitstream"),
        "ladder_small": (small, ladder_small, ladder_small.preferred_backend),
        "ladder_sorted": (sbm, ladder_sorted, ladder_sorted.preferred_backend),
    }


PLANS = _plans()


@pytest.mark.parametrize("name", sorted(PLANS))
def test_round_trip_bit_exact(tmp_path, name):
    hg, plan, route = PLANS[name]
    path = plancache.save_plan(plan, str(tmp_path / "plan.npz"))
    back = plancache.load_plan(path, CPU)
    assert_same(plan, back)
    if isinstance(plan, planner.TreePlan):
        assert back.form == plan.form and back._device == {}
    hgd = hg.device_data(CPU)
    x = torch.as_tensor(np.random.default_rng(0).normal(size=(hg.num_nodes, 8))
                        .astype(np.float32))
    want = fused.hgnn_aggregate(hgd, x, None, "sum", plan=plan, backend=route)
    got = fused.hgnn_aggregate(hgd, x, None, "sum", plan=back, backend=route)
    assert torch.equal(got, want)


def test_tensors_share_one_payload(tmp_path):
    """A tensor named twice in a plan is stored once and loaded as one."""
    _, plan, _ = PLANS["dense_int8"]
    pair = (plan.dense, plan.dense)
    back = plancache.load_plan(plancache.save_plan(pair, str(tmp_path / "p.npz")), CPU)
    assert back[0].h is back[1].h and back[0].h.dtype == torch.int8


def test_key_follows_content_kwargs_and_device():
    hg1 = tsyn.random_hypergraph(100, 60, avg_edge_size=4.0, seed=1)
    hg2 = tsyn.random_hypergraph(100, 60, avg_edge_size=4.0, seed=2)
    k1 = plancache.plan_key(hg1, "cpu")
    assert k1 == plancache.plan_key(hg1, "cpu")
    assert k1 != plancache.plan_key(hg2, "cpu")
    assert k1 != plancache.plan_key(hg1, "cpu", with_precomp=False)
    assert k1 != plancache.plan_key(hg1, "cuda")
    assert plancache.plan_key(hg1, "cuda") == plancache.plan_key(hg1, "cuda:0")
    jhg1 = jrandom_hypergraph(100, 60, avg_edge_size=4.0, seed=1)
    assert k1 != jplancache.plan_key(jhg1)  # the package is hashed too


def test_cached_builds_once_then_loads(tmp_path, monkeypatch):
    hg = tsyn.random_hypergraph(120, 70, avg_edge_size=4.0, seed=5)
    d = str(tmp_path / "plans")
    calls = []
    real = planner.plan_aggregation

    def counting(*a, **k):
        calls.append(1)
        return real(*a, **k)

    monkeypatch.setattr(planner, "plan_aggregation", counting)
    p1 = plancache.cached_plan_aggregation(hg, cache_dir=d, device=CPU)
    assert len(calls) == 1 and len(os.listdir(d)) == 1
    p2 = plancache.cached_plan_aggregation(hg, cache_dir=d, device=CPU)
    assert len(calls) == 1  # loaded, not rebuilt
    assert_same(p1, p2)
    plancache.cached_plan_aggregation(hg, cache_dir=d, device=CPU, with_precomp=False)
    assert len(calls) == 2 and len(os.listdir(d)) == 2


def test_corrupt_file_is_rebuilt(tmp_path):
    hg = tsyn.random_hypergraph(80, 50, avg_edge_size=4.0, seed=9)
    d = str(tmp_path / "plans")
    want = plancache.cached_plan_aggregation(hg, cache_dir=d, device=CPU)
    (fname,) = os.listdir(d)
    for junk in (b"not an npz", b""):
        with open(os.path.join(d, fname), "wb") as fh:
            fh.write(junk)
        assert_same(plancache.cached_plan_aggregation(hg, cache_dir=d, device=CPU), want)
    assert_same(plancache.load_plan(os.path.join(d, fname), CPU), want)  # overwritten


@pytest.mark.parametrize("path", ["hypergef_tpu.sparse.planner:TreePlan",
                                  "hypergef_tpu:Hypergraph", "os.path:join",
                                  "hypergef_tpu_torchX.mod:C"])
def test_refuses_foreign_classes(path):
    with pytest.raises(ValueError, match="outside hypergef_tpu_torch"):
        plancache._resolve_class(path)


def test_never_serves_a_jax_file(tmp_path):
    jhg = jrandom_hypergraph(120, 70, avg_edge_size=4.0, seed=5)
    jpath = str(tmp_path / "jax.npz")
    jplancache.save_plan(jplan_aggregation(jhg), jpath)
    with pytest.raises(ValueError, match="rebuild"):
        plancache.load_plan(jpath, CPU)


def test_trainer_plan_cache_builds_then_loads(tmp_path, monkeypatch):
    hg, y = tsyn.homophilic_hypergraph(200, 120, 4, seed=3)
    x = np.random.default_rng(3).normal(size=(200, 8)).astype(np.float32)
    idx = np.arange(100)
    calls = []
    real = planner.plan_aggregation

    def counting(*a, **k):
        calls.append(1)
        return real(*a, **k)

    monkeypatch.setattr(planner, "plan_aggregation", counting)
    d = str(tmp_path / "plans")
    losses = []
    for _ in range(2):
        tr = Trainer(TrainConfig(nhid=8, epochs=5, warmup=0, plan_cache=d), hg, x, y,
                     device="cpu")
        losses.append(tr.fit(idx)["losses"])
    assert len(calls) == 1 and len(os.listdir(d)) == 1
    np.testing.assert_array_equal(losses[0], losses[1])
    # another route's plan is kept under a key naming the route
    tr = Trainer(TrainConfig(nhid=8, epochs=2, warmup=0, backend="tree", plan_cache=d), hg,
                 x, y, device="cpu")
    assert isinstance(tr.plan.tree, planner.TreePlan) and len(os.listdir(d)) == 2
