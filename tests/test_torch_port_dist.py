"""The distributed programs of the port against the JAX package's, in gloo
worlds of 2 and 4 CPU ranks.

Each world is started once for this file (a module fixture) and runs every
case in each rank (``tests/torch_dist_ranks.py``, which imports no JAX);
JAX's counterparts run here on the simulated 8-device CPU mesh, on the same
NumPy inputs:

* ``sharded_hgnn_aggregate`` (sum, mean, max; with ``wdiag``) and
  ``sharded_unignn_aggregate``; ``sharded_dense_*`` (int8, and the
  packed-int4 slices against JAX's packed ``psum``); ``halo_hgnn_aggregate``
  (sum, mean, max; tree and aligned interiors; with ``wdiag``) and
  ``halo_unignn_aggregate``: outputs and the gradients of ⟨out, cot⟩ with
  respect to x;
* a few ``DistTrainer`` and halo-step losses of each model family, from
  JAX's weights (``dist_params_from_jax``), which hold the weights'
  gradients and Adam;
* a ``DPMinibatchTrainer`` step against JAX's on the same batches, dropout
  off;
* each collective Function of ``parallel/comm.py`` against its
  single-process oracle; the (d, e) grid; a checkpoint round trip.

Tolerance: the repo's f32 bar, rtol and atol 1e-3
(``tests/test_fuzz_backends.py:46``); each comparison asserts it and the
largest difference seen is recorded in PERF.md. The ranks run under
``torch.use_deterministic_algorithms(True)``.
"""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from hypergef_tpu.data.synthetic import homophilic_hypergraph
from hypergef_tpu.parallel import dense_shard as jdense
from hypergef_tpu.parallel import dist_aggr as jagg
from hypergef_tpu.parallel import dist_model as jmodel
from hypergef_tpu.parallel import halo as jhalo
from hypergef_tpu.parallel import halo_aggr as jhaggr
from hypergef_tpu.parallel import partition as jpart
from hypergef_tpu.parallel.mesh import make_mesh as jmake_mesh

from hypergef_tpu_torch.models.convert import params_from_flax
from hypergef_tpu_torch.parallel import dense_shard, halo, partition
from hypergef_tpu_torch.parallel.dist_model import dist_params_from_jax
from hypergef_tpu_torch.parallel.launch import spawn
from hypergef_tpu_torch.train import TrainConfig

sys.path.insert(0, os.path.dirname(__file__))
sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "experiments"))

import torch_dist_ranks  # noqa: E402
from test_torch_port_dist_plans import port_hg  # noqa: E402

TOL = dict(rtol=1e-3, atol=1e-3)
F = 6
STEPS = 3
NHID = 8
NCLASS = 3


class Problem:
    """Every graph, input and plan of the file, in both packages."""

    def __init__(self, skewed, tmp):
        from weak_scaling import clustered_hypergraph

        self.tmp = tmp
        rng = np.random.default_rng(0)
        self.hg = {"skewed": skewed, "clustered": clustered_hypergraph(4000, 2000, 8.0, seed=3)}
        self.phg = {k: port_hg(v) for k, v in self.hg.items()}
        self.x = {k: rng.normal(size=(v.num_nodes, F)).astype(np.float32)
                  for k, v in self.hg.items()}
        self.cot = {k: rng.normal(size=(v.num_nodes, F)).astype(np.float32)
                    for k, v in self.hg.items()}
        hs = self.hg["skewed"]
        self.w = rng.uniform(0.5, 1.5, (hs.num_edges, 1)).astype(np.float32)
        self.y = rng.integers(0, NCLASS, hs.num_nodes)
        self.train_idx = np.arange(0, hs.num_nodes, 2)
        self.mask = np.zeros(hs.num_nodes, np.float32)
        self.mask[self.train_idx] = 1.0
        hd, yd = homophilic_hypergraph(300, 200, NCLASS, avg_edge_size=5, seed=0)
        self.dp_graph = (hd, yd, rng.normal(size=(hd.num_nodes, F)).astype(np.float32))
        self.plans = {}
        self.dp_jax = {}

    def plan(self, kind, name, d, pkg, packed=False):
        key = (kind, name, d, pkg, packed)
        if key not in self.plans:
            hg = self.hg[name] if pkg == "jax" else self.phg[name]
            if kind == "agg":
                mod = jpart if pkg == "jax" else partition
                self.plans[key] = mod.plan_sharded_aggregation(hg, d)
            elif kind == "dense":
                mod = jdense if pkg == "jax" else dense_shard
                self.plans[key] = mod.plan_sharded_dense(hg, d, packed=packed)
            else:
                mod = jhalo if pkg == "jax" else halo
                self.plans[key] = mod.plan_halo(hg, d, local_form=kind)
        return self.plans[key]

    def dist_params(self, model, nfeat):
        key = jax.random.key(5)
        if model == "HGNN":
            return jmodel.init_dist_params(key, nfeat, NHID, NCLASS)
        if model == "UniGIN":
            return jmodel.init_unigin_params(key, nfeat, NHID, NCLASS)
        return jmodel.init_unigcnii_params(key, nfeat, NHID, NCLASS)

    def dp_cfg(self, pkg):
        kw = dict(model="HGNN", nhid=NHID, dropout=0.0, input_drop=0.0, seed=4)
        if pkg == "jax":
            from hypergef_tpu.train import TrainConfig as JTrainConfig

            return JTrainConfig(**kw)
        return TrainConfig(**kw)

    def dp_trainer(self, d):
        """JAX's DP trainer of ``d`` devices, built before the world starts
        (its initial weights go to the ranks)."""
        if d not in self.dp_jax:
            from hypergef_tpu.train.dp_minibatch import DPMinibatchTrainer

            hd, yd, xd = self.dp_graph
            self.dp_jax[d] = DPMinibatchTrainer(
                self.dp_cfg("jax"), hd, xd, yd, np.arange(0, hd.num_nodes, 2),
                batch_edges=32, n_devices=d, sampler_seed=2)
        return self.dp_jax[d]


AGG_CASES = {
    "sharded sum": dict(kind="agg", aggr="sum"),
    "sharded mean": dict(kind="agg", aggr="mean"),
    "sharded max": dict(kind="agg", aggr="max"),
    "sharded sum wdiag": dict(kind="agg", aggr="sum", wdiag=True),
    "sharded unignn": dict(kind="agg", unignn=False),
    "sharded unignn deg": dict(kind="agg", unignn=True),
    "dense sum": dict(kind="dense", aggr="sum"),
    "dense mean wdiag": dict(kind="dense", aggr="mean", wdiag=True),
    "dense unignn deg": dict(kind="dense", unignn=True),
    "dense packed mean wdiag": dict(kind="dense", aggr="mean", wdiag=True, packed=True),
    "halo sum": dict(kind="tree", aggr="sum"),
    "halo mean": dict(kind="tree", aggr="mean"),
    "halo max": dict(kind="tree", aggr="max"),
    "halo sum wdiag": dict(kind="tree", aggr="sum", wdiag=True),
    "halo unignn": dict(kind="tree", aggr="sum", use_deg=False),
    "halo aligned sum": dict(kind="aligned", aggr="sum", graph="clustered"),
    "halo aligned max": dict(kind="aligned", aggr="max", graph="clustered"),
}
TRAIN_CASES = {
    "trainer HGNN": dict(model="HGNN", aggr="sum"),
    "trainer HGNN max": dict(model="HGNN", aggr="max"),
    "trainer UniGIN": dict(model="UniGIN", aggr="sum"),
    "trainer UniGCNII": dict(model="UniGCNII", aggr="sum"),
}
HALO_STEP_CASES = {"halo step HGNN": "HGNN", "halo step HGNN max": "HGNN",
                   "halo step UniGIN": "UniGIN", "halo step UniGCNII": "UniGCNII"}
# the smaller world runs a subset
WORLD2 = {"sharded sum", "sharded max", "dense sum", "halo sum", "halo max",
          "halo aligned sum", "trainer HGNN", "halo step HGNN"}


def rank_cases(p: Problem, d: int):
    cases = []
    for name, c in AGG_CASES.items():
        if d == 2 and name not in WORLD2:
            continue
        g = c.get("graph", "skewed")
        kind = c["kind"]
        plan = p.plan("agg" if kind == "agg" else kind, g, d, "torch", c.get("packed", False))
        kw = dict(plan=plan, x=p.x[g], cot=p.cot[g], wdiag=p.w if c.get("wdiag") else None)
        if kind in ("agg", "dense"):
            kw.update(aggr=c.get("aggr", "sum"), unignn=c.get("unignn"), dense=kind == "dense",
                      degV=p.hg[g].degV)
            cases.append((name, "agg", kw))
        else:
            kw.update(aggr=c["aggr"], use_deg=c.get("use_deg", True), form=kind)
            cases.append((name, "halo", kw))
    hs = p.phg["skewed"]
    for name, c in TRAIN_CASES.items():
        if d == 2 and name not in WORLD2:
            continue
        params = dist_params_from_jax(p.dist_params(c["model"], F))
        cases.append((name, "trainer", dict(
            hg=hs, x=p.x["skewed"], y=p.y, train_idx=p.train_idx, model=c["model"],
            first_aggr=c["aggr"], params=params, steps=STEPS, nhid=NHID,
            plan=p.plan("agg", "skewed", d, "torch"))))
    for name, model in HALO_STEP_CASES.items():
        if d == 2 and name not in WORLD2:
            continue
        params = dist_params_from_jax(p.dist_params(model, F))
        cases.append((name, "halo_step", dict(
            plan=p.plan("tree", "skewed", d, "torch"), model=model, params=params,
            x=p.x["skewed"], y=p.y, mask=p.mask, nclass=NCLASS, steps=STEPS,
            first_aggr="max" if name.endswith("max") else "sum")))
    cases.append(("collectives", "collectives", dict(f=5)))
    if d == 4:
        hd, yd, xd = p.dp_graph
        jtr = p.dp_trainer(d)
        cases.append(("dp", "dp", dict(
            cfg=p.dp_cfg("torch"), hg=port_hg(hd), x=xd, y=yd,
            train_idx=np.arange(0, hd.num_nodes, 2), batch_edges=32, sampler_seed=2,
            params=params_from_flax(jax.tree_util.tree_map(np.asarray, jtr.params)),
            steps=2)))
        cases.append(("checkpoint", "checkpoint", dict(
            hg=hs, x=p.x["skewed"], y=p.y, train_idx=p.train_idx,
            directory=os.path.join(p.tmp, "ckpt"), nhid=NHID)))
        cases.append(("meshes", "meshes", {}))
    return cases


@pytest.fixture(scope="module")
def problem(skewed_hg, tmp_path_factory):
    return Problem(skewed_hg, str(tmp_path_factory.mktemp("dist")))


@pytest.fixture(scope="module")
def worlds(problem):
    """Each world's results by rank: {2: [...], 4: [...]}."""
    out = {}
    for d in (2, 4):
        out[d] = spawn(torch_dist_ranks.run, d, backend="gloo", platform="cpu",
                       args=(rank_cases(problem, d),), timeout_s=240)
    return out


def _jmesh(d):
    return jmake_mesh(d, 1, devices=jax.devices()[:d])


def _out_and_grad(fn, x, cot):
    """fn(x) and the gradient of ⟨fn(x), cot⟩, as one jitted program (an
    eager ``shard_map`` compiles on every call)."""
    def both(v, c):
        out, vjp = jax.vjp(fn, v)
        return out, vjp(c)[0]

    return jax.jit(both)(x, cot)


def jax_agg(p: Problem, name: str, d: int):
    c = AGG_CASES[name]
    g = c.get("graph", "skewed")
    kind = c["kind"]
    hg = p.hg[g]
    plan = p.plan("agg" if kind == "agg" else kind, g, d, "jax", c.get("packed", False))
    mesh = _jmesh(d)
    x, cot = p.x[g], p.cot[g]
    aggr = c.get("aggr", "sum")
    degV = jnp.asarray(hg.degV)
    if kind in ("agg", "dense"):
        w = None if not c.get("wdiag") else jnp.asarray(plan.shard_edge_vector(p.w))
        mod = jagg if kind == "agg" else jdense
        if c.get("unignn") is not None:
            uni = (mod.sharded_unignn_aggregate if kind == "agg"
                   else mod.sharded_dense_unignn_aggregate)
            fn = lambda v: uni(plan, mesh, v, use_deg=c["unignn"], degV=degV)  # noqa: E731
        else:
            agg = (mod.sharded_hgnn_aggregate if kind == "agg"
                   else mod.sharded_dense_hgnn_aggregate)
            fn = lambda v: agg(plan, mesh, v, w, aggr, degV=degV)  # noqa: E731
        out, dx = _out_and_grad(fn, jnp.asarray(x), jnp.asarray(cot))
        return np.asarray(out), np.asarray(dx)
    w = None
    if c.get("wdiag"):
        w = np.zeros((d, plan.e_pad, 1), np.float32)
        for r in range(d):
            e0, e1 = int(plan.edge_bounds[r]), int(plan.edge_bounds[r + 1])
            w[r, : e1 - e0] = p.w[e0:e1]
        w = jnp.asarray(w)
    x_own = jnp.asarray(jhaggr.shard_vertex_features(plan, x))
    out, dx = _out_and_grad(
        lambda v: jhaggr.halo_hgnn_aggregate(plan, mesh, v, w, aggr,
                                             use_deg=c.get("use_deg", True)),
        x_own, jnp.asarray(jhaggr.shard_vertex_features(plan, p.cot[g])))
    return (jhaggr.unshard_vertex_features(plan, out),
            jhaggr.unshard_vertex_features(plan, dx))


def jax_losses(step, params, opt_state, args):
    out = []
    for _ in range(STEPS):
        params, opt_state, loss = step(params, opt_state, *args)
        out.append(float(loss))
    return np.array(out)


def jax_trainer(p: Problem, name: str, d: int):
    c = TRAIN_CASES[name]
    hg = p.hg["skewed"]
    plan = p.plan("agg", "skewed", d, "jax")
    mesh = _jmesh(d)
    degV = jnp.asarray(hg.degV)
    if c["model"] == "HGNN":
        step, tx, _, _ = jmodel.make_dist_train_step(mesh, plan, degV, first_aggr=c["aggr"],
                                                     nclass=NCLASS)
    elif c["model"] == "UniGIN":
        step, tx, _, _ = jmodel.make_dist_unigin_train_step(mesh, plan, nclass=NCLASS)
    else:
        step, tx, _, _ = jmodel.make_dist_unigcnii_train_step(mesh, plan, degV, nclass=NCLASS)
    params = p.dist_params(c["model"], F)
    args = (jnp.asarray(p.x["skewed"]), jnp.asarray(p.y, dtype=jnp.int32),
            jnp.asarray(p.mask))
    return jax_losses(step, params, tx.init(params), args)


def jax_halo_step(p: Problem, name: str, d: int):
    model = HALO_STEP_CASES[name]
    plan = p.plan("tree", "skewed", d, "jax")
    mesh = _jmesh(d)
    if model == "HGNN":
        step, tx, _ = jhaggr.make_halo_train_step(
            mesh, plan, nclass=NCLASS, first_aggr="max" if name.endswith("max") else "sum")
    elif model == "UniGIN":
        step, tx, _ = jhaggr.make_halo_unigin_train_step(mesh, plan, nclass=NCLASS)
    else:
        step, tx, _ = jhaggr.make_halo_unigcnii_train_step(mesh, plan, nclass=NCLASS)
    params = p.dist_params(model, F)
    yo = np.zeros(d * plan.n_own, np.int32)
    yo[: len(p.y)] = p.y
    args = (jnp.asarray(jhaggr.shard_vertex_features(plan, p.x["skewed"])), jnp.asarray(yo),
            jnp.asarray(jhaggr.shard_vertex_features(plan, p.mask[:, None])[:, 0]))
    return jax_losses(step, params, tx.init(params), args)


def close(got, want):
    np.testing.assert_allclose(got, want, **TOL)


def _params(names, worlds_of=(2, 4)):
    return [(d, n) for d in worlds_of for n in names if d == 4 or n in WORLD2]


@pytest.mark.parametrize("d, name", _params(AGG_CASES))
def test_aggregation_matches_jax(worlds, problem, d, name):
    """Output and d⟨out, cot⟩/dx of each aggregation, every rank alike."""
    got = worlds[d][0][name]
    want = jax_agg(problem, name, d)
    close(got[0], want[0])
    close(got[1], want[1])
    for r in range(1, d):
        np.testing.assert_array_equal(worlds[d][r][name][0], got[0])


@pytest.mark.parametrize("d, name", _params(TRAIN_CASES))
def test_dist_trainer_losses_match_jax(worlds, problem, d, name):
    got = worlds[d][0][name]
    close(got, jax_trainer(problem, name, d))
    for r in range(1, d):
        np.testing.assert_array_equal(worlds[d][r][name], got)


@pytest.mark.parametrize("d, name", _params(HALO_STEP_CASES))
def test_halo_step_losses_match_jax(worlds, problem, d, name):
    got = worlds[d][0][name]
    close(got, jax_halo_step(problem, name, d))


def test_dp_minibatch_step_matches_jax(worlds, problem):
    jtr = problem.dp_trainer(4)
    rng = jax.random.key(problem.dp_cfg("jax").seed + 1)
    want = []
    for _ in range(2):
        rng, sub = jax.random.split(rng)
        want.append(float(jtr.step_once(sub)))
    got = worlds[4][0]["dp"]
    close(got, np.array(want))
    for r in range(1, 4):
        np.testing.assert_array_equal(worlds[4][r]["dp"], got)


@pytest.mark.parametrize("d", [2, 4])
@pytest.mark.parametrize("fn", ["sum_to_replicated", "from_replicated", "all_to_all"])
def test_collective_matches_oracle(worlds, d, fn):
    """Forward and backward of each Function against one process's sum,
    identity or exchange over every rank's seeded inputs."""
    xs, cots = [], []
    for r in range(d):
        rng = np.random.default_rng(100 + r)
        xs.append(rng.normal(size=(d, 3, 5)).astype(np.float32))
        cots.append(rng.normal(size=(d, 3, 5)).astype(np.float32))
    for r in range(d):
        y, g = worlds[d][r]["collectives"][fn]
        if fn == "sum_to_replicated":
            want_y, want_g = sum(xs), cots[r]
        elif fn == "from_replicated":
            want_y, want_g = xs[r], sum(cots)
        else:
            want_y = np.stack([xs[j][r] for j in range(d)])
            want_g = np.stack([cots[j][r] for j in range(d)])
        np.testing.assert_allclose(y, want_y, rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(g, want_g, rtol=1e-6, atol=1e-6)


def test_checkpoint_round_trip(worlds):
    for r in range(4):
        step, after_save, after_restore = worlds[4][r]["checkpoint"]
        assert step == 1 and after_restore == after_save


def test_hybrid_mesh_groups(worlds):
    """Ranks 0..3 as a 2 x 2 (d, e) grid: edge groups {0, 1}, {2, 3}; data
    groups {0, 2}, {1, 3}."""
    for r in range(4):
        m = worlds[4][r]["meshes"]
        d, e = divmod(r, 2)
        assert m["e"] == (e, 2, float(2 * (2 * d) + 1), [e])
        assert m["d"] == (d, 2, float(2 * e + 2), [d])
