"""The distributed plans of the port (``hypergef_tpu_torch.parallel``) against
the JAX package's, NumPy only (no program is compiled or run):

* ``edge_partition_bounds``, ``ShardedAggPlan``, ``ShardedDensePlan`` and
  ``HaloPlan`` (tree and aligned interiors): every host array bit-equal to
  JAX's, on ``skewed_hg`` and ``small_hg`` and on a community-sorted graph
  small enough for the aligned interior;
* ``comm_fraction``, ``halo_comm_fraction``, ``interior_fraction`` equal;
* the aligned interior's fallback to trees is JAX's, and the plan records
  the form it took;
* ``cached_plan_halo`` loads a plan equal to the one it built;
* the dense shard's products a block of rows at a time equal the
  whole-slice ones;
* the refusals: nccl without a card a rank, CUDA ranks without a card
  (``packed=True`` is ported: ``tests/test_torch_port_packed_int4.py``).
"""

import dataclasses
import os
import sys

import numpy as np
import pytest
import torch

from hypergef_tpu.data.synthetic import random_hypergraph as jrandom
from hypergef_tpu.parallel import dense_shard as jdense
from hypergef_tpu.parallel import halo as jhalo
from hypergef_tpu.parallel import partition as jpart

from hypergef_tpu_torch.parallel import dense_shard, halo, mesh, partition
from hypergef_tpu_torch.sparse import plancache
from hypergef_tpu_torch.sparse.hypergraph import Hypergraph

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "experiments"))


def port_hg(hg):
    """The port's Hypergraph over a JAX hypergraph's arrays."""
    return Hypergraph(num_nodes=hg.num_nodes, num_edges=hg.num_edges, h_indptr=hg.h_indptr,
                      h_indices=hg.h_indices, ht_indptr=hg.ht_indptr,
                      ht_indices=hg.ht_indices, name=hg.name)


@pytest.fixture(scope="module")
def clustered():
    from weak_scaling import clustered_hypergraph

    return clustered_hypergraph(4000, 2000, 8.0, seed=3)


def assert_same(got, want, where="plan"):
    """Every field of JAX's structure equal in the port's, arrays bitwise
    (value and dtype)."""
    if dataclasses.is_dataclass(want):
        for f in dataclasses.fields(want):
            if not f.name.startswith("_"):
                assert_same(getattr(got, f.name), getattr(want, f.name), f"{where}.{f.name}")
    elif isinstance(want, dict):
        assert set(got) == set(want), where
        for k in want:
            assert_same(got[k], want[k], f"{where}[{k!r}]")
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want), where
        for i, (a, b) in enumerate(zip(got, want)):
            assert_same(a, b, f"{where}[{i}]")
    elif isinstance(want, np.ndarray):
        assert isinstance(got, np.ndarray) and got.dtype == want.dtype, (where, got.dtype)
        np.testing.assert_array_equal(got, want, err_msg=where)
    else:
        assert got == want, (where, got, want)


GRAPHS = ["skewed", "small"]


def _graph(name, request):
    return request.getfixturevalue({"skewed": "skewed_hg", "small": "small_hg",
                                    "clustered": "clustered"}[name])


@pytest.mark.parametrize("name", GRAPHS + ["clustered"])
@pytest.mark.parametrize("d", [2, 4, 8])
def test_edge_partition_bounds_equal_jax(name, d, request):
    hg = _graph(name, request)
    got = partition.edge_partition_bounds(port_hg(hg), d)
    want = jpart.edge_partition_bounds(hg, d)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("name", GRAPHS)
@pytest.mark.parametrize("d", [2, 4])
def test_sharded_agg_plan_equal_jax(name, d, request):
    hg = _graph(name, request)
    got = partition.plan_sharded_aggregation(port_hg(hg), d)
    want = jpart.plan_sharded_aggregation(hg, d)
    assert_same(got, want)
    w = np.random.default_rng(0).uniform(size=(hg.num_edges, 1)).astype(np.float32)
    np.testing.assert_array_equal(got.shard_edge_vector(w), want.shard_edge_vector(w))


@pytest.mark.parametrize("name", GRAPHS)
@pytest.mark.parametrize("d", [2, 4])
def test_sharded_dense_plan_equal_jax(name, d, request):
    hg = _graph(name, request)
    got = dense_shard.plan_sharded_dense(port_hg(hg), d)
    want = jdense.plan_sharded_dense(hg, d)
    assert_same(got, want)
    assert got.table_bytes_per_device() == want.table_bytes_per_device()


@pytest.mark.parametrize("name, form", [("skewed", "tree"), ("small", "tree"),
                                        ("clustered", "tree"), ("clustered", "aligned")])
@pytest.mark.parametrize("d", [2, 4])
def test_halo_plan_equal_jax(name, form, d, request):
    hg = _graph(name, request)
    got = halo.plan_halo(port_hg(hg), d, local_form=form)
    want = jhalo.plan_halo(hg, d, local_form=form)
    assert got.local_form == want.local_form
    if form == "aligned":
        assert got.local_form == "aligned"  # the clustered graph keeps it
    assert_same(got, want)
    for k in ("comm_fraction", "halo_comm_fraction", "interior_fraction"):
        assert getattr(got, k)() == getattr(want, k)(), k


def test_halo_aligned_fallback_recorded():
    """JAX's fallback (a 2-shard random graph spills too much for the
    aligned interior, ``tests/test_halo.py:312-316``): the port takes the
    same tree plan and records the form asked for."""
    hr = jrandom(16000, 8000, avg_edge_size=6, seed=3, name="rnd")
    got = halo.plan_halo(port_hg(hr), 2, local_form="aligned")
    assert (got.local_form, got.requested_form) == ("tree", "aligned")
    assert_same(got, jhalo.plan_halo(hr, 2, local_form="aligned"))


def test_cached_plan_halo_round_trip(skewed_hg, tmp_path):
    hg = port_hg(skewed_hg)
    built = plancache.cached_plan_halo(hg, 4, cache_dir=str(tmp_path), device="cpu")
    (path,) = [p for p in os.listdir(tmp_path) if p.startswith("halo_")]
    loaded = plancache.cached_plan_halo(hg, 4, cache_dir=str(tmp_path), device="cpu")
    assert loaded is not built and os.listdir(tmp_path) == [path]
    assert_same(loaded, built)
    assert_same(loaded, jhalo.plan_halo(skewed_hg, 4))
    assert plancache.plan_key(hg, "cpu", n_shards=4) != plancache.plan_key(hg, "cuda",
                                                                          n_shards=4)


def test_dense_byte_guard(small_hg):
    with pytest.raises(MemoryError, match="exceeds"):
        dense_shard.plan_sharded_dense(port_hg(small_hg), 2, max_bytes_per_device=100)


def test_dense_row_blocks_match_one_block(small_hg, monkeypatch):
    """The dense shard's products a block of the table's rows at a time (the
    slice converted block by block, never whole) give the whole-slice
    products, forward and backward, within f32 rounding."""
    plan = dense_shard.plan_sharded_dense(port_hg(small_hg), 2)
    loc = plan.local(1, "cpu")
    rng = np.random.default_rng(4)
    x = torch.as_tensor(rng.normal(size=(plan.num_nodes, 8)).astype(np.float32))
    g = torch.as_tensor(rng.normal(size=(plan.num_nodes, 8)).astype(np.float32))

    def run():
        xr = x.clone().requires_grad_(True)
        out = dense_shard._TwoStage.apply(xr, loc, loc.degE)
        out.backward(g)
        return out.detach(), xr.grad

    assert len(dense_shard._row_blocks(loc.h)) == 1
    whole = run()
    monkeypatch.setattr(dense_shard, "DENSE_BLOCK_BYTES", 4 * plan.e_pad * 7)
    assert len(dense_shard._row_blocks(loc.h)) == -(-plan.num_nodes // 7)
    for got, want in zip(run(), whole):
        torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6 * float(want.abs().max()))


def test_nccl_without_enough_cards_raises(monkeypatch):
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        mesh.rank_device("nccl", "cuda", 0, 2)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(RuntimeError, match="gloo"):
        mesh.rank_device("nccl", "cuda", 1, 2)
    assert mesh.rank_device("gloo", "cuda", 3, 4) == torch.device("cuda", 0)
    with pytest.raises(ValueError, match="gloo"):
        mesh.rank_device("nccl", "cpu", 0, 2)


def test_init_distributed_single_process(monkeypatch):
    """Without torchrun's RANK this is a single-process run: nothing joins."""
    monkeypatch.delenv("RANK", raising=False)
    assert mesh.init_distributed() is None
