"""The port's hyperedge sampler and minibatch trainer against the JAX
package's (``data/sampling.py``, ``train/minibatch.py``), on the CPU.

* For a fixed seed, uniform and weighted draws, with and without
  ``pad_to``, with the Horvitz-Thompson factor on and off: every array of
  the port's batch equals JAX's, bitwise.
* ``probe_pad_shapes`` gives JAX's shapes and ``epoch`` JAX's edges.
* ``MinibatchTrainer`` with dropout 0 and JAX's initial parameters: the
  losses of one epoch's 5 batches within rtol 1e-3 of JAX's (the f32
  gather bar of ROADMAP.md), and ``evaluate_full``'s full-graph logits
  after them within 1e-3.
* A padded batch's gradient through the ``cumsum`` route equals JAX's at
  1e-3 of its scale (the ghost rows keep the two CSRs exact transposes).
* ``first_aggr="max"`` raises; the sampler's default device is the card.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import hypergef_tpu.data.synthetic as jsyn
from hypergef_tpu.data.sampling import HyperedgeSampler as JSampler
from hypergef_tpu.ops import fused as jfused
from hypergef_tpu.train.minibatch import MinibatchTrainer as JMinibatchTrainer
from hypergef_tpu.train.trainer import TrainConfig as JTrainConfig

import hypergef_tpu_torch.data.synthetic as tsyn
from hypergef_tpu_torch.data.sampling import HyperedgeSampler
from hypergef_tpu_torch.models.convert import params_from_flax
from hypergef_tpu_torch.ops import fused
from hypergef_tpu_torch.train.minibatch import MinibatchTrainer
from hypergef_tpu_torch.train.trainer import TrainConfig

NCLASS = 3
# the arrays of a batch's data, compared as integers or f32
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


def _assert_batches_equal(jb, tb):
    for name in DATA_FIELDS:
        want = np.asarray(getattr(jb.data, name))
        got = getattr(tb.data, name).cpu().numpy()
        assert got.shape == want.shape and np.array_equal(got, want.astype(got.dtype)), name
    assert (tb.data.num_nodes, tb.data.num_edges) == (jb.data.num_nodes, jb.data.num_edges)
    for name in ("vertex_ids", "vertex_mask", "edge_ids"):
        want, got = getattr(jb, name), getattr(tb, name)
        assert got.dtype == want.dtype and np.array_equal(got, want), name
    assert (tb.num_real_vertices, tb.num_real_edges) == (jb.num_real_vertices,
                                                         jb.num_real_edges)


@pytest.mark.parametrize("deg_correction", [True, False])
@pytest.mark.parametrize("pad_to", [None, (256, 64, 512)])
@pytest.mark.parametrize("weighted", [False, True])
def test_batches_bit_equal_jax(weighted, pad_to, deg_correction):
    jhg, thg, _, _, _ = _problem()
    kw = dict(weighted=weighted, seed=11, deg_correction=deg_correction)
    js, ts = JSampler(jhg, 24, **kw), HyperedgeSampler(thg, 24, device="cpu", **kw)
    for _ in range(3):
        jb, tb = js.sample_batch(pad_to=pad_to), ts.sample_batch(pad_to=pad_to)
        _assert_batches_equal(jb, tb)
        assert tb.ghost_entries == tb.pad_shape[2] - int(jb.data.h_indptr[-2])
    # the whole graph: the Horvitz-Thompson factor is 1
    full = np.arange(thg.num_edges)
    _assert_batches_equal(js.induce(full), ts.induce(full))


def test_pad_shapes_and_epoch_equal_jax():
    jhg, thg, _, _, _ = _problem()
    js = JSampler(jhg, 40, seed=1, drop_last=False)
    ts = HyperedgeSampler(thg, 40, seed=1, drop_last=False, device="cpu")
    assert ts.probe_pad_shapes() == js.probe_pad_shapes()
    jedges = [jb.edge_ids[: jb.num_real_edges] for jb in js.epoch()]
    tedges = [tb.edge_ids[: tb.num_real_edges] for tb in ts.epoch()]
    assert len(tedges) == len(jedges) == 4
    for j, t in zip(jedges, tedges):
        assert np.array_equal(j, t)
    assert np.array_equal(np.sort(np.concatenate(tedges)), np.arange(thg.num_edges))


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


@functools.lru_cache(maxsize=None)
def _trained():
    jhg, thg, x, y, train_idx = _problem()
    kw = dict(nhid=8, dropout=0.0, input_drop=0.0, seed=5)
    jtr = JMinibatchTrainer(JTrainConfig(**kw), jhg, x, y, train_idx, batch_edges=32)
    params = params_from_flax(jtr.params)
    ttr = MinibatchTrainer(TrainConfig(**kw), thg, x, y, train_idx, batch_edges=32,
                           device="cpu", params=params)
    assert ttr.pad_shapes == jtr.pad_shapes
    want = _jax_fit_losses(jtr)
    got = ttr.fit(epochs=1)
    return jtr, ttr, want, got


def test_minibatch_losses_match_jax():
    jtr, ttr, want, got = _trained()
    assert got["batches"] == len(want) == 5
    np.testing.assert_allclose(got["losses"], want, rtol=1e-3)
    assert got["final_loss"] == got["losses"][-1]
    assert got["mean_loss"] == pytest.approx(float(np.mean(got["losses"][-10:])))
    assert ttr.compile_count == 1


def test_evaluate_full_logits_match_jax():
    jtr, ttr, _, _ = _trained()
    jhg, thg, x, y, _ = _problem()
    want = np.asarray(jtr.model.apply({"params": jtr.params}, jnp.asarray(x),
                                      jhg.device_data(), None, deterministic=True))
    ttr.model.eval()
    with torch.no_grad():
        got = ttr.model(ttr.x, thg.device_data("cpu"), None).numpy()
    np.testing.assert_allclose(got, want, atol=1e-3)
    split = {"train": np.arange(100), "test": np.arange(100, 300)}
    accs = ttr.evaluate_full(split)
    assert set(accs) == {"train_acc", "test_acc"}


def test_padded_batch_gradient_matches_jax():
    jhg, thg, x, _, _ = _problem()
    jb = JSampler(jhg, 48, seed=5).sample_batch()
    tb = HyperedgeSampler(thg, 48, seed=5, device="cpu").sample_batch()
    xb = x[jb.vertex_ids][:, :8]
    want = np.asarray(jax.grad(lambda a: jfused.hgnn_aggregate(
        jb.data, a, None, "sum", plan=None, backend="cumsum").sum())(jnp.asarray(xb)))
    xt = torch.as_tensor(xb).requires_grad_(True)
    fused.hgnn_aggregate(tb.data, xt, None, "sum", plan=None, backend="cumsum").sum().backward()
    scale = float(np.abs(want).max())
    np.testing.assert_allclose(xt.grad.numpy(), want, atol=1e-3 * scale)
    # the pad entries sit in one ghost segment per CSR, each pointing at
    # the other side's ghost row
    ghost = tb.ghost_entries
    assert ghost > 0 and tb.data.v2e.gather[-ghost:].eq(tb.data.num_nodes - 1).all()
    assert tb.data.e2v.gather[-ghost:].eq(tb.data.num_edges - 1).all()


def test_max_and_default_device_raise():
    _, thg, x, y, train_idx = _problem()
    with pytest.raises(ValueError, match="max"):
        MinibatchTrainer(TrainConfig(first_aggr="max"), thg, x, y, train_idx, device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            HyperedgeSampler(thg, 8)
