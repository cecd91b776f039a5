"""The recorded minibatch, data-parallel and distributed steps' CPU side.

* :func:`max_warp_runs` bounds the runs :func:`warp_runs` makes, on
  hypothesis CSRs (empty, long and ghost segments, several shares) and on
  every batch of a sampler epoch at its probed pad shape; with no entries
  the bound is reached.
* ``warp_runs(pad_to=P)`` is the exact runs and then terminal rows (S,
  nnz) up to P + 1 rows; a table that needs more than P runs raises.
* :class:`StaticTables` (a pad shape's tensors, written in place): after
  each write its tensors equal the batch's own ``HypergraphData`` bitwise,
  its runs the padded exact runs; a batch of another shape, or past the
  run bound, raises before anything is copied.
* ``MinibatchTrainer(device="cpu")`` over those tables: every batch's loss
  within rtol 1e-3 of JAX's (as ``test_torch_port_sampling.py``: the f32
  gather bar of ROADMAP.md) with a bucket shape a batch, and on a run
  forced to double its pad shape; ``compile_count`` equals JAX's jit cache
  size (``_cache_size()``) in both.
* ``compiled=True`` raises on the CPU (the minibatch trainer) and on a gloo
  rank (``DistTrainer``, ``DPMinibatchTrainer``), naming nccl; a gloo
  world's fit says its step ran eagerly, and so does the CLI.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

import hypergef_tpu.data.synthetic as jsyn
from hypergef_tpu.train.minibatch import MinibatchTrainer as JMinibatchTrainer
from hypergef_tpu.train.trainer import TrainConfig as JTrainConfig

import hypergef_tpu_torch.data.synthetic as tsyn
from hypergef_tpu_torch.data.sampling import HyperedgeSampler
from hypergef_tpu_torch.models.convert import params_from_flax
from hypergef_tpu_torch.ops.segment_sum import RUN_SHARE, max_warp_runs, warp_runs
from hypergef_tpu_torch.parallel.mesh import Mesh, compiled_for
from hypergef_tpu_torch.sparse.hypergraph import StaticTables
from hypergef_tpu_torch.train.minibatch import MinibatchTrainer
from hypergef_tpu_torch.train.trainer import TrainConfig

NCLASS = 3
DATA_FIELDS = ("ht_indptr", "ht_vertex", "ht_segids", "h_indptr", "h_edge", "h_segids",
               "degV", "degE")


@functools.lru_cache(maxsize=None)
def _problem():
    jhg, y = jsyn.homophilic_hypergraph(300, 160, NCLASS, avg_edge_size=5.0, seed=2)
    thg, ty = tsyn.homophilic_hypergraph(300, 160, NCLASS, avg_edge_size=5.0, seed=2)
    assert np.array_equal(y, ty) and np.array_equal(jhg.ht_indices, thg.ht_indices)
    x = np.random.default_rng(3).normal(size=(300, 12)).astype(np.float32)
    train_idx = np.random.default_rng(4).permutation(300)[:150]
    return jhg, thg, x, np.asarray(y), train_idx


def _indptr(lengths) -> np.ndarray:
    out = np.zeros(len(lengths) + 1, dtype=np.int64)
    np.cumsum(lengths, out=out[1:])
    return out


# segment lengths: mostly short, some empty, some long (≥ a share), and
# optionally a ghost segment of all the padding at the end
_lengths = st.lists(st.one_of(st.integers(0, 6), st.just(0), st.integers(16, 200)),
                    min_size=0, max_size=300)


@settings(max_examples=300, deadline=None)
@given(lengths=_lengths, ghost=st.one_of(st.just(0), st.integers(1, 5000)),
       share=st.sampled_from([16, RUN_SHARE, 64]))
def test_max_warp_runs_bounds_the_runs(lengths, ghost, share):
    ip = _indptr(list(lengths) + ([ghost] if ghost else []))
    s, z = ip.size - 1, int(ip[-1])
    runs = warp_runs(ip, share)
    assert runs.shape[0] - 1 <= max_warp_runs(s, z, share)
    # padded to the bound: the exact runs, then terminal rows
    padded = warp_runs(ip, share, pad_to=max_warp_runs(s, z, share))
    w = runs.shape[0]
    assert padded.shape == (max_warp_runs(s, z, share) + 1, 2)
    np.testing.assert_array_equal(padded[:w], runs)
    assert (padded[w:] == [s, z]).all()


@pytest.mark.parametrize("s", [0, 1, 31, 32, 33, 1000, 4096])
def test_max_warp_runs_is_reached_without_entries(s):
    """S empty segments: a run a bucket of 32 starts, which the bound gives."""
    ip = np.zeros(s + 1, dtype=np.int64)
    assert warp_runs(ip).shape[0] - 1 == max_warp_runs(s, 0) == -(-s // RUN_SHARE)


def test_warp_runs_pad_to_raises_past_its_bound():
    ip = _indptr([1] * 100)
    exact = warp_runs(ip)
    w = exact.shape[0] - 1
    np.testing.assert_array_equal(warp_runs(ip, pad_to=w), exact)
    with pytest.raises(ValueError, match="warp runs"):
        warp_runs(ip, pad_to=w - 1)


def test_every_batch_of_an_epoch_fits_its_bound():
    """Each batch of a sampler epoch at the probed pad shape: both CSRs'
    runs within the shape's bound, and the tables take it."""
    _, thg, _, _, _ = _problem()
    sampler = HyperedgeSampler(thg, 24, seed=3, device="cpu")
    pad = sampler.probe_pad_shapes()
    n, e, z = pad
    tables = StaticTables(*pad, "cpu")
    batches = list(sampler.epoch(pad_to=pad))
    assert len(batches) == 6
    for b in batches:
        assert warp_runs(b.ht_indptr).shape[0] - 1 <= max_warp_runs(e, z)
        assert warp_runs(b.h_indptr).shape[0] - 1 <= max_warp_runs(n, z)
        b.write(tables)


def test_static_tables_hold_each_batch_bitwise():
    """Three batches written in turn (both staging buffers, one reused):
    after each write, every tensor equals the batch's own device data,
    the int32 tables their int64 ones, the runs the padded exact runs."""
    _, thg, _, _, _ = _problem()
    sampler = HyperedgeSampler(thg, 24, seed=5, device="cpu")
    pad = (256, 64, 512)
    tables = StaticTables(*pad, "cpu")
    views = {k: t.data_ptr() for k, t in tables.tensors.items()}
    for _ in range(3):
        b = sampler.sample_batch(pad_to=pad)
        b.write(tables)
        got, want = tables.data, b.data
        for name in DATA_FIELDS:
            assert torch.equal(getattr(got, name), getattr(want, name)), name
        assert (got.num_nodes, got.num_edges) == (want.num_nodes, want.num_edges)
        for side, ip in (("v2e", b.ht_indptr), ("e2v", b.h_indptr)):
            gt, wt = getattr(got, side), getattr(want, side)
            assert torch.equal(gt.indptr, wt.indptr) and torch.equal(gt.gather, wt.gather)
            assert gt.indptr.dtype == gt.gather.dtype == torch.int32
            assert (gt.nnz, gt.num_inputs) == (wt.nnz, wt.num_inputs)
            np.testing.assert_array_equal(
                gt.runs.numpy(), warp_runs(ip, pad_to=tables.runs[side]))
        assert torch.equal(tables.tensors["rows"], b.rows)
        assert torch.equal(tables.tensors["row_mask"], b.row_mask)
    # written in place: the same storage every time
    assert {k: t.data_ptr() for k, t in tables.tensors.items()} == views


def test_static_tables_refuse_a_batch_they_cannot_hold():
    _, thg, _, _, _ = _problem()
    sampler = HyperedgeSampler(thg, 24, seed=5, device="cpu")
    b = sampler.sample_batch(pad_to=(256, 64, 512))
    with pytest.raises(ValueError, match="pad shape"):
        b.write(StaticTables(256, 64, 1024, "cpu"))
    tables = StaticTables(256, 64, 512, "cpu")
    b.write(tables)
    before = {k: t.clone() for k, t in tables.tensors.items()}
    tables.runs["e2v"] = 1  # a bound the batch passes: raises, copies nothing
    with pytest.raises(ValueError, match="warp runs"):
        sampler.sample_batch(pad_to=(256, 64, 512)).write(tables)
    assert all(torch.equal(t, before[k]) for k, t in tables.tensors.items())


def _jax_fit_losses(tr):
    """JAX's ``MinibatchTrainer.fit`` for one epoch (``minibatch.py:132-156``),
    keeping every batch's loss."""
    rng = jax.random.key(tr.cfg.seed + 1)
    losses = []
    for batch in tr._epoch_batches():
        xb = jnp.asarray(tr.x[batch.vertex_ids])
        yb = jnp.asarray(tr.y[batch.vertex_ids])
        mask = jnp.asarray(batch.vertex_mask * tr.train_mask_global[batch.vertex_ids])
        tr.params, tr.opt_state, rng, loss = tr._step(tr.params, tr.opt_state, rng,
                                                      batch.data, xb, yb, mask)
        losses.append(float(loss))
    return np.asarray(losses)


def _pair(fixed_shapes: bool, pad_shapes=None):
    jhg, thg, x, y, train_idx = _problem()
    kw = dict(nhid=8, dropout=0.0, input_drop=0.0, seed=5)
    jtr = JMinibatchTrainer(JTrainConfig(**kw), jhg, x, y, train_idx, batch_edges=32,
                            fixed_shapes=fixed_shapes)
    ttr = MinibatchTrainer(TrainConfig(**kw), thg, x, y, train_idx, batch_edges=32,
                           fixed_shapes=fixed_shapes, device="cpu",
                           params=params_from_flax(jtr.params))
    assert ttr.pad_shapes == jtr.pad_shapes and not ttr.compiled
    if pad_shapes is not None:
        jtr.pad_shapes = ttr.pad_shapes = pad_shapes
    return jtr, ttr


@pytest.mark.parametrize("fixed_shapes,pad_shapes", [(False, None), (True, (16, 16, 64))],
                         ids=["bucket_shape_a_batch", "forced_doubling"])
def test_minibatch_losses_and_compile_count_match_jax(fixed_shapes, pad_shapes):
    """Over the static tables, one epoch's losses within rtol 1e-3 of JAX's
    and ``compile_count`` equal to JAX's cache size: several shapes each
    (a bucket a batch; a probed shape too small, doubled where batches
    overflow it)."""
    jtr, ttr = _pair(fixed_shapes, pad_shapes)
    want = _jax_fit_losses(jtr)
    got = ttr.fit(epochs=1)
    assert got["batches"] == len(want) == 5 and got["step"] == "eager"
    assert got["capture_s"] == 0.0 and got["recorded"] == 0
    np.testing.assert_allclose(got["losses"], want, rtol=1e-3)
    assert ttr.compile_count == jtr.compile_count > 1
    assert ttr.compile_count == len(ttr.tables)
    if pad_shapes is not None:
        assert ttr.pad_shapes == jtr.pad_shapes != pad_shapes


def test_compiled_true_raises_on_the_cpu():
    _, thg, x, y, train_idx = _problem()
    with pytest.raises(ValueError, match="CUDA device"):
        MinibatchTrainer(TrainConfig(), thg, x, y, train_idx, device="cpu", compiled=True)


@pytest.mark.parametrize("device", ["cpu", "cuda"])
def test_compiled_true_raises_on_gloo(device):
    """A gloo rank, on the CPU or sharing a card, cannot record its step:
    ``compiled=True`` raises naming nccl, before the trainer builds
    anything; None runs eagerly; an nccl rank on a card records."""
    from hypergef_tpu_torch.parallel.trainer import DistTrainer
    from hypergef_tpu_torch.train.dp_minibatch import DPMinibatchTrainer

    _, thg, x, y, train_idx = _problem()
    gloo = Mesh(group=None, rank=0, size=1, device=torch.device(device), backend="gloo")
    with pytest.raises(ValueError, match="nccl"):
        DistTrainer(thg, x, y, nhid=8, mesh=gloo, compiled=True)
    with pytest.raises(ValueError, match="nccl"):
        DPMinibatchTrainer(TrainConfig(), thg, x, y, train_idx, mesh=gloo, compiled=True)
    assert compiled_for(gloo, None, "DistTrainer") is False
    assert compiled_for(gloo, False, "DistTrainer") is False
    nccl = Mesh(group=None, rank=0, size=1, device=torch.device("cuda", 0), backend="nccl")
    assert compiled_for(nccl, None, "DistTrainer") is True
    assert compiled_for(nccl, False, "DistTrainer") is False


def test_cli_minibatch_prints_its_step(capsys):
    from hypergef_tpu_torch.train import cli

    res = cli.main(["--synthetic", "random", "--n", "300", "--e", "160", "--feat", "8",
                    "--epochs", "10", "--minibatch-edges", "32", "--platform", "cpu"])
    assert res["step"] == "eager" and res["recorded"] == 0
    assert "step: eager" in capsys.readouterr().out.splitlines()
