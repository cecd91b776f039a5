"""The serialized halo pair of the port (``parallel/serial_halo.py``,
``parallel/serial_halo_train.py``) against the JAX package's, on the CPU,
on the same NumPy inputs:

* ``serialized_halo_forward`` on ``skewed_hg``: D ∈ {2, 4}, sum, mean and
  max, tree interiors, within 1e-5 (and with a stacked ``wdiag``); on
  ``clustered_hypergraph(4000, 2000, 8.0, seed=3)`` with the aligned
  interior, taken by both plans, at ``tests/test_torch_port_dist.py``'s
  bar for the aligned halo interior (1e-3); ``stats``' keys and values;
* ``serialized_halo_train_step``'s loss and gradients, tree and aligned
  interiors, and ``serialized_halo_train_epochs``' weights and losses after
  3 epochs, within 1e-5·max;
* the plan keeps no shard's tables after a serialized run; the copy of a
  shard's tables keeps one copy a storage (views stay views); without a
  card the default device raises.

The serialized forward's equality with the gloo world of the same plan is
checked in ``tests/test_torch_port_feature_axis.py``, whose world runs it.
JAX's train step compiles its programs at every call (``ADVICE.md:4``), so
each JAX step here costs seconds: the file runs three of them.
"""

import os
import sys

import numpy as np
import pytest
import torch

from hypergef_tpu.data.synthetic import homophilic_hypergraph
from hypergef_tpu.parallel import serial_halo_train as jtrain
from hypergef_tpu.parallel.halo import plan_halo as jplan_halo
from hypergef_tpu.parallel.serial_halo import serialized_halo_forward as jforward

from hypergef_tpu_torch.parallel import halo
from hypergef_tpu_torch.parallel.serial_halo import (
    ShardTables, StorageCopy, map_tensors, serialized_halo_forward, table_bytes,
)
from hypergef_tpu_torch.parallel.serial_halo_train import (
    serialized_halo_train_epochs, serialized_halo_train_step,
)

sys.path.insert(0, os.path.dirname(__file__))
sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "experiments"))

from test_torch_port_dist_plans import port_hg  # noqa: E402

F = 6
ALIGNED_TOL = dict(rtol=1e-3, atol=1e-3)


def rel_to_max(got, want) -> float:
    return float(np.abs(np.asarray(got) - want).max() / np.abs(want).max())


@pytest.fixture(scope="module")
def skewed(skewed_hg):
    """The graph, x, and each D's plan in both packages."""
    x = np.random.default_rng(0).normal(size=(skewed_hg.num_nodes, F)).astype(np.float32)
    plans = {d: (jplan_halo(skewed_hg, d), halo.plan_halo(port_hg(skewed_hg), d))
             for d in (2, 4)}
    return skewed_hg, x, plans


@pytest.fixture(scope="module")
def clustered():
    """JAX's clustered graph at D = 4 with the aligned interior."""
    from weak_scaling import clustered_hypergraph

    hg = clustered_hypergraph(4000, 2000, 8.0, seed=3)
    jp, pp = jplan_halo(hg, 4, local_form="aligned"), halo.plan_halo(port_hg(hg), 4,
                                                                      local_form="aligned")
    assert jp.local_form == "aligned" and pp.local_form == "aligned"
    return hg, jp, pp


def train_problem(hg, seed: int):
    """x [N, 12], labels in 4 classes, half the rows in the mask, weights
    [12, 8] and [8, 8] (JAX's padded classes)."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(hg.num_nodes, 12)).astype(np.float32)
    y = rng.integers(0, 4, size=hg.num_nodes)
    mask = np.zeros(hg.num_nodes, np.float32)
    mask[rng.choice(hg.num_nodes, hg.num_nodes // 2, replace=False)] = 1.0
    params = {"w1": (rng.normal(size=(12, 8)) / np.sqrt(12)).astype(np.float32),
              "w2": (rng.normal(size=(8, 8)) / np.sqrt(8)).astype(np.float32)}
    return x, y, mask, params


@pytest.fixture(scope="module")
def homophilic():
    hg, _ = homophilic_hypergraph(400, 260, 4, avg_edge_size=5.0, seed=9)
    return hg, jplan_halo(hg, 4), halo.plan_halo(port_hg(hg), 4)


@pytest.mark.parametrize("d", [2, 4])
@pytest.mark.parametrize("aggr", ["sum", "mean", "max"])
def test_serialized_forward_matches_jax(skewed, d, aggr):
    _, x, plans = skewed
    jp, pp = plans[d]
    want = jforward(jp, x, first_aggr=aggr)
    got = serialized_halo_forward(pp, x, aggr, device="cpu")
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5 * np.abs(want).max())


def test_serialized_forward_wdiag_matches_jax(skewed):
    hg, x, plans = skewed
    jp, pp = plans[2]
    w = np.random.default_rng(1).uniform(0.5, 1.5, (2, pp.e_pad, 1)).astype(np.float32)
    want = jforward(jp, x, wdiag=w)
    got = serialized_halo_forward(pp, x, wdiag=w, device="cpu")
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5 * np.abs(want).max())
    with pytest.raises(ValueError, match="stacked"):
        serialized_halo_forward(pp, x, wdiag=w[:, :1], device="cpu")


def test_serialized_aligned_forward_matches_jax(clustered):
    hg, jp, pp = clustered
    x = np.random.default_rng(2).normal(size=(hg.num_nodes, F)).astype(np.float32)
    np.testing.assert_allclose(serialized_halo_forward(pp, x, device="cpu"), jforward(jp, x),
                               **ALIGNED_TOL)


def test_serialized_stats_match_jax(skewed):
    """JAX's keys with JAX's values (the real exchange bytes, the shard
    count, a wall time a shard); the port's own keys beside them."""
    _, x, plans = skewed
    jp, pp = plans[4]
    want, got = {}, {}
    jforward(jp, x, stats=want)
    serialized_halo_forward(pp, x, stats=got, device="cpu")
    assert set(want) <= set(got)
    for k in ("halo_bytes_real", "return_bytes_real", "n_shards"):
        assert got[k] == want[k], k
    assert len(got["per_shard_wall_s"]) == 4 and min(got["per_shard_wall_s"]) > 0
    assert len(got["table_bytes"]) == 4 and min(got["table_bytes"]) > 0
    # no card: no device timers
    assert got["per_shard_device_ms"] == [] and got["per_shard_stage_ms"] == []


@pytest.mark.parametrize("form", ["tree", "aligned"])
def test_serialized_train_step_matches_jax(homophilic, clustered, form):
    hg, jp, pp = homophilic if form == "tree" else clustered
    x, y, mask, params = train_problem(hg, 4)
    want_loss, want = jtrain.serialized_halo_train_step(jp, params, x, y, mask)
    loss, got = serialized_halo_train_step(pp, params, x, y, mask, device="cpu")
    assert abs(loss - want_loss) <= 1e-5 * abs(want_loss)
    for k in ("w1", "w2"):
        assert got[k].shape == want[k].shape and got[k].dtype == np.float32
        assert rel_to_max(got[k], np.asarray(want[k])) <= 1e-5, k
    assert pp._local == {}


def test_serialized_train_epochs_match_jax(homophilic):
    """JAX's initial weights and three AdamW steps."""
    hg, jp, pp = homophilic
    x, y, mask, _ = train_problem(hg, 5)
    want, want_losses = jtrain.serialized_halo_train_epochs(jp, x, y, mask, 8, 4, epochs=3,
                                                            seed=2)
    got, losses = serialized_halo_train_epochs(pp, x, y, mask, 8, 4, epochs=3, seed=2,
                                               device="cpu")
    np.testing.assert_allclose(losses, want_losses, rtol=1e-5)
    for k in ("w1", "w2"):
        assert got[k].shape == np.asarray(want[k]).shape
        assert rel_to_max(got[k], np.asarray(want[k])) <= 1e-5, k


def test_train_step_is_repeatable(homophilic):
    """Two runs of a step (with tables shared) give bitwise equal
    gradients."""
    hg, _, pp = homophilic
    x, y, mask, params = train_problem(hg, 6)
    tables = ShardTables(pp, "cpu")
    a = serialized_halo_train_step(pp, params, x, y, mask, device="cpu", tables=tables)
    b = serialized_halo_train_step(pp, params, x, y, mask, device="cpu", tables=tables)
    assert a[0] == b[0]
    for k in ("w1", "w2"):
        assert np.array_equal(a[1][k], b[1][k])


def test_plan_keeps_no_shard_tables(skewed):
    """A serialized run builds each shard's tables uncached; the world
    program's ``local`` still caches."""
    _, x, plans = skewed
    pp = plans[2][1]
    serialized_halo_forward(pp, x, "max", device="cpu")
    assert pp._local == {}
    loc = pp.local(0, "cpu")
    assert pp.local(0, "cpu") is loc and pp.local(0, "cpu", cache=False) is not loc
    pp._local.clear()


def test_table_copy_keeps_views(clustered):
    """A shard's tables copied storage by storage: the same bytes, the band
    views still views of one flat copy, every value equal."""
    _, _, pp = clustered
    loc = pp.local(1, "cpu", cache=False)
    copier = StorageCopy("cpu")
    moved = map_tensors(loc, copier)
    assert table_bytes(moved) == table_bytes(loc) == copier.nbytes
    src = loc.int_fwd.b_dense
    dst = moved.int_fwd.b_dense
    assert dst.untyped_storage().data_ptr() != src.untyped_storage().data_ptr()
    assert torch.equal(dst, src) and dst.storage_offset() == src.storage_offset()
    got, want = [], []
    map_tensors(moved, lambda t: got.append(t) or t)
    map_tensors(loc, lambda t: want.append(t) or t)
    assert len(got) == len(want) and all(torch.equal(a, b) for a, b in zip(got, want))
    assert isinstance(moved, halo.LocalHalo) and moved.int_fwd.num_inputs == pp.n_own


def test_default_device_is_the_card(skewed, monkeypatch):
    _, x, plans = skewed
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serialized_halo_forward(plans[2][1], x)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serialized_halo_train_epochs(plans[2][1], x, np.zeros(len(x), np.int64),
                                     np.ones(len(x), np.float32), 8, 4)
