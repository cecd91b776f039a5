"""Rank-side cases of the distributed parity tests.

The test files start a world of gloo CPU ranks once
(``hypergef_tpu_torch.parallel.launch.spawn``) and run :func:`run` in each
rank over a list of cases; the results come back to the test process, which
holds them against the JAX package's programs. This module imports torch
and the port only, so no rank loads JAX.
"""

import numpy as np
import torch

from hypergef_tpu_torch.parallel import comm, dense_shard, dist_aggr
from hypergef_tpu_torch.parallel.halo_aggr import (
    HaloStep, gather_blocks, halo_hgnn_aggregate, own_block, shard_vertex_features,
)
from hypergef_tpu_torch.parallel.mesh import make_mesh


def _np(t):
    return t.detach().cpu().numpy()


def agg(mesh, plan, x, cot, aggr="sum", wdiag=None, unignn=None, dense=False, degV=None,
        grid=None):
    """A replicated-X aggregation's output and d<out, cot>/dx; on the
    ``grid`` (n_edge, n_feature) feature-sharded."""
    kw = {}
    if grid is not None:
        mesh = make_mesh(*grid)
        kw = dict(mesh=mesh, feature_sharded=True)
    xt = torch.tensor(x, requires_grad=True)
    dv = None if degV is None else torch.as_tensor(degV)
    if dense:
        if unignn is None:
            w = None if wdiag is None else torch.as_tensor(
                plan.shard_edge_vector(wdiag)[mesh.rank])
            out = dense_shard.sharded_dense_hgnn_aggregate(plan, xt, w, aggr, degV=dv, **kw)
        else:
            out = dense_shard.sharded_dense_unignn_aggregate(plan, xt, use_deg=unignn, degV=dv,
                                                             **kw)
    elif unignn is None:
        w = None if wdiag is None else torch.as_tensor(plan.shard_edge_vector(wdiag)[mesh.rank])
        out = dist_aggr.sharded_hgnn_aggregate(plan, xt, w, aggr, degV=dv, **kw)
    else:
        out = dist_aggr.sharded_unignn_aggregate(plan, xt, use_deg=unignn, degV=dv, **kw)
    (out * torch.as_tensor(cot)).sum().backward()
    return _np(out), _np(xt.grad)


def halo(mesh, plan, x, cot, aggr="sum", wdiag=None, use_deg=True, form=None, grid=None):
    """The halo aggregation's output and gradient, gathered to [N, F]; on
    the ``grid`` (n_edge, n_feature), over its edge groups."""
    if form is not None:
        assert plan.local_form == form, (plan.local_form, form)
    if grid is not None:
        mesh = make_mesh(*grid)
    dev = mesh.device
    xb = torch.tensor(own_block(plan, shard_vertex_features(plan, x), mesh.rank), device=dev,
                      requires_grad=True)
    cb = torch.as_tensor(own_block(plan, shard_vertex_features(plan, cot), mesh.rank),
                         device=dev)
    w = None
    if wdiag is not None:
        w = torch.zeros((plan.e_pad, 1), device=dev)
        e0, e1 = int(plan.edge_bounds[mesh.rank]), int(plan.edge_bounds[mesh.rank + 1])
        w[: e1 - e0] = torch.as_tensor(wdiag[e0:e1])
    out = halo_hgnn_aggregate(plan, xb, w, aggr, use_deg=use_deg, mesh=mesh)
    (out * cb).sum().backward()
    n = plan.num_nodes
    return (_np(gather_blocks(out.detach(), mesh))[:n],
            _np(gather_blocks(xb.grad, mesh))[:n])


def trainer(mesh, hg, x, y, train_idx, model, first_aggr, params, steps, plan, nhid,
            n_feature=1):
    """Losses of ``steps`` DistTrainer steps from the given weights."""
    from hypergef_tpu_torch.parallel.trainer import DistTrainer

    tr = DistTrainer(hg, x, y, nhid=nhid, model=model, first_aggr=first_aggr, plan=plan,
                     params=params, n_shards=plan.n_shards, n_feature=n_feature)
    mask = tr.train_mask(train_idx)
    return np.array([float(tr.step(mask)) for _ in range(steps)])


def halo_step(mesh, plan, model, params, x, y, mask, nclass, steps, first_aggr="sum"):
    """Losses of ``steps`` fully-sharded steps (x, y, mask in the [N] layout)."""
    step = HaloStep(model, plan, params, first_aggr=first_aggr, nclass=nclass)
    xb = torch.as_tensor(own_block(plan, shard_vertex_features(plan, x), mesh.rank))
    yo = np.zeros(plan.n_shards * plan.n_own, np.int64)
    yo[: len(y)] = y
    mo = np.zeros(plan.n_shards * plan.n_own, np.float32)
    mo[: len(mask)] = mask
    yb = torch.as_tensor(own_block(plan, yo, mesh.rank))
    mb = torch.as_tensor(own_block(plan, mo, mesh.rank))
    return np.array([float(step(xb, yb, mb)) for _ in range(steps)])


def dp(mesh, cfg, hg, x, y, train_idx, batch_edges, sampler_seed, params, steps):
    """Losses of ``steps`` data-parallel minibatch steps."""
    from hypergef_tpu_torch.train.dp_minibatch import DPMinibatchTrainer

    tr = DPMinibatchTrainer(cfg, hg, x, y, train_idx, batch_edges=batch_edges,
                            sampler_seed=sampler_seed, params=params)
    return np.array([float(tr.step_once()) for _ in range(steps)])


def collectives(mesh, f):
    """Each collective Function on this rank's seeded inputs: outputs and
    the gradients of <out, cot>."""
    rng = np.random.default_rng(100 + mesh.rank)
    x = rng.normal(size=(mesh.size, 3, f)).astype(np.float32)
    cot = rng.normal(size=(mesh.size, 3, f)).astype(np.float32)
    out = {}
    for name, fn in (("sum_to_replicated", comm.sum_to_replicated),
                     ("from_replicated", comm.from_replicated),
                     ("all_to_all", comm.all_to_all)):
        xt = torch.tensor(x, requires_grad=True)
        y = fn(xt, mesh.group)
        (y * torch.as_tensor(cot)).sum().backward()
        out[name] = (_np(y), _np(xt.grad))
    return out


def feature_collectives(mesh, grid, f):
    """slice_columns and gather_columns over the grid's feature group on
    this rank's seeded inputs (seeded by world rank): outputs and the
    gradients of <out, cot>."""
    import torch.distributed as dist

    fg = make_mesh(*grid).feature
    rng = np.random.default_rng(200 + dist.get_rank())
    out = {}
    for name, fn, width in (("slice_columns", comm.slice_columns, f * fg.size),
                            ("gather_columns", comm.gather_columns, f)):
        x = rng.normal(size=(3, width)).astype(np.float32)
        cot = rng.normal(size=(3, f * fg.size if name == "gather_columns" else f)).astype(
            np.float32)
        xt = torch.tensor(x, requires_grad=True)
        y = fn(xt, fg.group)
        (y * torch.as_tensor(cot)).sum().backward()
        out[name] = (_np(y), _np(xt.grad))
    return out


def grids(mesh):
    """The (e, f) grid 2 x 2 and the (d, e, f) grid 2 x 1 x 2 of a 4-rank
    world: each axis's (rank, size, sum of its ranks' world ranks, local
    slots)."""
    import torch.distributed as dist

    from hypergef_tpu_torch.parallel.mesh import local_shard_info, make_hybrid_mesh

    def axis(m, info_mesh, name):
        t = torch.tensor([float(dist.get_rank())])
        dist.all_reduce(t, group=m.group)
        return (m.rank, m.size, float(t[0]), local_shard_info(info_mesh, name)["local_slots"])

    g = make_mesh(2, 2)
    hm = make_hybrid_mesh(n_edge=1, n_feature=2, n_data=2)
    return {"ef": {"e": axis(g, g, "e"), "f": axis(g.feature, g, "f")},
            "def": {"d": axis(hm.data, hm, "d"), "e": axis(hm.edge, hm, "e"),
                    "f": axis(hm.feature, hm, "f")}}


def checkpoint(mesh, hg, x, y, train_idx, directory, nhid):
    """DistTrainer.save then restore: the next loss after a restore equals
    the next loss after the save."""
    from hypergef_tpu_torch.parallel.trainer import DistTrainer

    tr = DistTrainer(hg, x, y, nhid=nhid, seed=3)
    mask = tr.train_mask(train_idx)
    tr.step(mask)
    tr.save(directory, step=1)
    after_save = float(tr.step(mask))
    tr.step(mask)
    step = tr.restore(directory)
    return step, after_save, float(tr.step(mask))


def meshes(mesh):
    """The (d, e) grid of a 4-rank world as 2 x 2: each axis's rank sums."""
    import torch.distributed as dist

    from hypergef_tpu_torch.parallel.mesh import local_shard_info, make_hybrid_mesh

    hm = make_hybrid_mesh(n_edge=2, n_data=2)
    out = {}
    for axis, m in (("e", hm.edge), ("d", hm.data)):
        t = torch.tensor([float(dist.get_rank())])
        dist.all_reduce(t, group=m.group)
        out[axis] = (m.rank, m.size, float(t[0]), local_shard_info(hm, axis)["local_slots"])
    return out


def recorded_fits(hg, x, y, train_idx, runs, dp_args, epochs=(2, 5)):
    """In a one-rank nccl world on the card (called by ``spawn`` directly,
    not through :func:`run`): for each (model, first_aggr) of ``runs`` the
    losses of an eager and of a recorded ``DistTrainer`` fit from the same
    seed, and of three eager and three recorded ``DPMinibatchTrainer``
    steps (``dp_args``: cfg, batch_edges and params) with the same seeds."""
    from hypergef_tpu_torch.parallel.partition import plan_sharded_aggregation
    from hypergef_tpu_torch.parallel.trainer import DistTrainer
    from hypergef_tpu_torch.train.dp_minibatch import DPMinibatchTrainer

    plan = plan_sharded_aggregation(hg, 1)
    warmup, n = epochs
    out = {}
    for model, aggr in runs:
        fits = [DistTrainer(hg, x, y, nhid=16, model=model, first_aggr=aggr, plan=plan,
                            compiled=c).fit(train_idx, epochs=n, warmup=warmup)
                for c in (False, None)]
        out[model, aggr] = [(f["step"], f["losses"]) for f in fits]
    cfg, batch_edges, params = dp_args
    dps = [DPMinibatchTrainer(cfg, hg, x, y, train_idx, batch_edges=batch_edges,
                              params=params, compiled=c) for c in (False, None)]
    out["dp"] = [(t.compiled, np.array([float(t.step_once()) for _ in range(3)]))
                 for t in dps]
    return out


KINDS = {"agg": agg, "halo": halo, "trainer": trainer, "halo_step": halo_step, "dp": dp,
         "collectives": collectives, "checkpoint": checkpoint,
         "meshes": meshes, "feature_collectives": feature_collectives, "grids": grids}


def run(cases):
    """Every case in order: {name: result}."""
    torch.use_deterministic_algorithms(True)
    mesh = make_mesh()
    return {name: KINDS[kind](mesh, **kw) for name, kind, kw in cases}
