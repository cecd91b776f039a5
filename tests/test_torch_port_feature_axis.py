"""The feature mesh axis of the port (``n_feature > 1``) against the JAX
package's, in one gloo world of 4 CPU ranks laid out as a 2 x 2 ``(e, f)``
grid.

The world is started once for this file (a module fixture) and runs each
case in every rank (``tests/torch_dist_ranks.py``); JAX's counterparts run
here on a ``(2, 2)`` mesh of the simulated CPU devices, jitted:

* ``sharded_hgnn_aggregate`` (sum, mean, max), ``sharded_unignn_aggregate``
  and the dense shard (sum, mean) with ``feature_sharded=True``: the
  output and the gradient of ⟨out, cot⟩ with respect to x, every rank
  alike;
* ``DistTrainer(n_shards=2, n_feature=2)`` losses from JAX's weights
  (``dist_params_from_jax``), 3 classes padded to 4, HGNN sum and max;
* ``comm.slice_columns`` and ``gather_columns`` against a single-process
  oracle over every rank's seeded inputs;
* the grids' rank coordinates and groups against JAX's ``reshape`` order;
* the ``nhid % n_feature`` refusal, with JAX's text;
* the serialized halo forward (``parallel/serial_halo.py``) bitwise equal
  to the halo world it stands for, here over the grid's edge groups (D = 2,
  sum), so that the suite starts one world for both.

Tolerance: the repo's f32 bar, rtol and atol 1e-3, as
``tests/test_torch_port_dist.py``.
"""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from hypergef_tpu.parallel import dense_shard as jdense
from hypergef_tpu.parallel import dist_aggr as jagg
from hypergef_tpu.parallel import dist_model as jmodel
from hypergef_tpu.parallel import partition as jpart
from hypergef_tpu.parallel.mesh import make_mesh as jmake_mesh

from hypergef_tpu_torch.parallel import dense_shard, halo, partition
from hypergef_tpu_torch.parallel.dist_model import dist_params_from_jax
from hypergef_tpu_torch.parallel.launch import spawn
from hypergef_tpu_torch.parallel.serial_halo import serialized_halo_forward
from hypergef_tpu_torch.parallel.trainer import DistTrainer

sys.path.insert(0, os.path.dirname(__file__))

import torch_dist_ranks  # noqa: E402
from test_torch_port_dist_plans import port_hg  # noqa: E402

TOL = dict(rtol=1e-3, atol=1e-3)
GRID = (2, 2)
F = 6
NHID = 8
NCLASS = 3
STEPS = 3

AGG_CASES = {
    "sum": dict(kind="agg", aggr="sum"),
    "mean": dict(kind="agg", aggr="mean"),
    "max": dict(kind="agg", aggr="max"),
    "unignn deg": dict(kind="agg", unignn=True),
    "dense sum": dict(kind="dense", aggr="sum"),
    "dense mean": dict(kind="dense", aggr="mean"),
}
TRAIN_CASES = {"HGNN sum": "sum", "HGNN max": "max"}


class Problem:
    def __init__(self, hg):
        rng = np.random.default_rng(20)
        self.hg, self.phg = hg, port_hg(hg)
        self.x = rng.normal(size=(hg.num_nodes, F)).astype(np.float32)
        self.cot = rng.normal(size=(hg.num_nodes, F)).astype(np.float32)
        self.y = rng.integers(0, NCLASS, hg.num_nodes)
        self.mask = np.zeros(hg.num_nodes, np.float32)
        self.mask[::2] = 1.0
        self.plans = {("agg", "jax"): jpart.plan_sharded_aggregation(hg, GRID[0]),
                      ("agg", "torch"): partition.plan_sharded_aggregation(self.phg, GRID[0]),
                      ("dense", "jax"): jdense.plan_sharded_dense(hg, GRID[0]),
                      ("dense", "torch"): dense_shard.plan_sharded_dense(self.phg, GRID[0])}
        self.plans[("halo", "torch")] = halo.plan_halo(self.phg, GRID[0])
        # class_pad: the classifier padded to a multiple of the feature axis
        self.params = jmodel.init_dist_params(jax.random.key(6), F, NHID, NCLASS,
                                              class_pad=GRID[1])


def rank_cases(p: Problem):
    cases = []
    for name, c in AGG_CASES.items():
        cases.append((name, "agg", dict(
            plan=p.plans[(c["kind"], "torch")], x=p.x, cot=p.cot, aggr=c.get("aggr", "sum"),
            unignn=c.get("unignn"), dense=c["kind"] == "dense", degV=p.hg.degV, grid=GRID)))
    for name, aggr in TRAIN_CASES.items():
        cases.append((name, "trainer", dict(
            hg=p.phg, x=p.x, y=p.y, train_idx=np.nonzero(p.mask)[0], model="HGNN",
            first_aggr=aggr, params=dist_params_from_jax(p.params), steps=STEPS, nhid=NHID,
            plan=p.plans[("agg", "torch")], n_feature=GRID[1])))
    cases.append(("halo world", "halo", dict(plan=p.plans[("halo", "torch")], x=p.x, cot=p.cot,
                                             grid=GRID)))
    cases.append(("collectives", "feature_collectives", dict(grid=GRID, f=3)))
    cases.append(("grids", "grids", {}))
    return cases


@pytest.fixture(scope="module")
def problem(skewed_hg):
    return Problem(skewed_hg)


@pytest.fixture(scope="module")
def world(problem):
    return spawn(torch_dist_ranks.run, GRID[0] * GRID[1], backend="gloo", platform="cpu",
                 args=(rank_cases(problem),), timeout_s=240)


def _jmesh():
    return jmake_mesh(*GRID, devices=jax.devices()[: GRID[0] * GRID[1]])


def jax_agg(p: Problem, name: str):
    c = AGG_CASES[name]
    plan, mesh = p.plans[(c["kind"], "jax")], _jmesh()
    degV = jnp.asarray(p.hg.degV)
    mod = jagg if c["kind"] == "agg" else jdense
    if c.get("unignn") is not None:
        fn = lambda v: mod.sharded_unignn_aggregate(  # noqa: E731
            plan, mesh, v, use_deg=c["unignn"], degV=degV, feature_sharded=True)
    else:
        agg = mod.sharded_hgnn_aggregate if c["kind"] == "agg" else mod.sharded_dense_hgnn_aggregate
        fn = lambda v: agg(plan, mesh, v, None, c["aggr"], degV=degV,  # noqa: E731
                           feature_sharded=True)

    def both(v, cot):
        out, vjp = jax.vjp(fn, v)
        return out, vjp(cot)[0]

    out, dx = jax.jit(both)(jnp.asarray(p.x), jnp.asarray(p.cot))
    return np.asarray(out), np.asarray(dx)


@pytest.mark.parametrize("name", list(AGG_CASES))
def test_feature_sharded_aggregation_matches_jax(world, problem, name):
    """Output and d⟨out, cot⟩/dx over the 2 x 2 grid, every rank alike."""
    want = jax_agg(problem, name)
    got = world[0][name]
    for a, b in zip(got, want):
        np.testing.assert_allclose(a, b, **TOL)
    for r in range(1, 4):
        for a, b in zip(world[r][name], got):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("name", list(TRAIN_CASES))
def test_feature_sharded_trainer_losses_match_jax(world, problem, name):
    """DistTrainer(n_shards=2, n_feature=2) from JAX's weights (W2 padded to
    4 classes) against JAX's feature-sharded step."""
    assert problem.params["W2"].shape == (NHID, 4)
    step, tx, _, _ = jmodel.make_dist_train_step(
        _jmesh(), problem.plans[("agg", "jax")], jnp.asarray(problem.hg.degV),
        first_aggr=TRAIN_CASES[name], feature_sharded=True, nclass=NCLASS)
    params, opt_state = problem.params, tx.init(problem.params)
    args = (jnp.asarray(problem.x), jnp.asarray(problem.y, dtype=jnp.int32),
            jnp.asarray(problem.mask))
    want = []
    for _ in range(STEPS):
        params, opt_state, loss = step(params, opt_state, *args)
        want.append(float(loss))
    got = world[0][name]
    np.testing.assert_allclose(got, want, **TOL)
    for r in range(1, 4):
        np.testing.assert_array_equal(world[r][name], got)


@pytest.mark.parametrize("fn", ["slice_columns", "gather_columns"])
def test_column_collectives_match_oracle(world, fn):
    """Each rank's forward and backward against one process's slice or
    concatenation over the feature group's seeded inputs: the feature group
    of world rank r is {2·(r // 2), 2·(r // 2) + 1}, its rank r % 2."""
    def inputs(r):
        rng = np.random.default_rng(200 + r)
        out = []
        for _, width_x, width_c in (("slice", 6, 3), ("gather", 3, 6)):
            out.append((rng.normal(size=(3, width_x)).astype(np.float32),
                        rng.normal(size=(3, width_c)).astype(np.float32)))
        return out

    for r in range(4):
        group = [2 * (r // 2), 2 * (r // 2) + 1]
        k = r % 2
        y, g = world[r]["collectives"][fn]
        if fn == "slice_columns":
            x, cot = inputs(r)[0]
            want_y = x[:, 3 * k: 3 * (k + 1)]
            want_g = np.concatenate([inputs(j)[0][1] for j in group], axis=1)
        else:
            want_y = np.concatenate([inputs(j)[1][0] for j in group], axis=1)
            want_g = inputs(r)[1][1][:, 3 * k: 3 * (k + 1)]
        np.testing.assert_array_equal(y, want_y)
        np.testing.assert_array_equal(g, want_g)


def test_grid_coordinates_follow_jax_reshape(world):
    """World rank r sits where JAX's ``reshape`` puts device r: (2, 2) for
    ``make_mesh(2, 2)``, (2, 1, 2) for ``make_hybrid_mesh(n_edge=1,
    n_feature=2, n_data=2)``; each axis's group holds the ranks of its
    line of the grid."""
    ef = np.arange(4).reshape(2, 2)
    hybrid = np.arange(4).reshape(2, 1, 2)
    for r in range(4):
        got = world[r]["grids"]
        e, f = map(int, np.argwhere(ef == r)[0])
        assert got["ef"]["e"] == (e, 2, float(ef[:, f].sum()), [e])
        assert got["ef"]["f"] == (f, 2, float(ef[e, :].sum()), [f])
        d, e, f = map(int, np.argwhere(hybrid == r)[0])
        assert got["def"]["d"] == (d, 2, float(hybrid[:, e, f].sum()), [d])
        assert got["def"]["e"] == (e, 1, float(hybrid[d, :, f].sum()), [e])
        assert got["def"]["f"] == (f, 2, float(hybrid[d, e, :].sum()), [f])


def test_nhid_must_divide_by_the_feature_axis(problem):
    """JAX's refusal (``trainer.py:54-55``), before any process group is
    touched."""
    with pytest.raises(ValueError, match=r"nhid=9 must be divisible by the feature-mesh "
                                         r"axis \(2\)"):
        DistTrainer(problem.phg, problem.x, problem.y, nhid=9, n_shards=2, n_feature=2)


def test_serialized_halo_equals_the_world(world, problem):
    """The serialized forward of a D = 2 halo plan against the gloo world
    of two shards that runs the same plan: bitwise equal (a host
    permutation in place of each all_to_all); the plan keeps no tables."""
    plan = problem.plans[("halo", "torch")]
    got = serialized_halo_forward(plan, problem.x, device="cpu")
    for r in range(4):
        assert np.array_equal(world[r]["halo world"][0], got)
    assert plan._local == {}
