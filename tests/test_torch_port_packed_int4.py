"""The packed-int4 dense incidence of the port against the JAX package's, on
the CPU.

JAX's packed form (``DenseIncidence.from_hypergraph(hg, dtype=jnp.int4)``,
``plan_sharded_dense(packed=True)``) is an explicit opt-in that must stay
bit-correct (``tests/test_packed_int4.py``); the port's is
``DenseIncidence.from_hypergraph(hg, device, packed=True)`` and the same
``plan_sharded_dense`` flag. On graphs of 60 × 31 (odd E, so the last
byte of each carrier row holds a padding nibble) and one whose counts
reach 7:

* the carrier bit-equal to JAX's, ``unpacked()`` equal to the int8 table,
  ``MemoryError`` past a count of 7 (``tests/test_packed_int4.py:73-80``);
* the ``dense`` and ``pallas`` routes (HGNN sum, mean and max, UniGNN with
  and without degrees): outputs and gradients on a packed plan bitwise
  equal to the int8 plan's, and within ``BF16_TOL`` (3e-2, as
  ``tests/test_torch_port_ops.py:33``) of JAX's packed routes (its
  ``pallas`` route in interpret mode, as its own tests run it);
* the packed op (``fused_dense_two_stage_packed``): ``opcheck``, its plain
  twin, and an explicit flag where the shapes cannot tell (E = 1);
* the plan cache's round trip, a packed ``Trainer`` (losses bitwise the
  int8 plan's) and a serving export of a packed plan;
* ``plan_sharded_dense(packed=True)``: ``h`` bit-equal to JAX's, each
  rank's ``local_two_stage`` bitwise the unpacked slice's, forward and
  backward, and the sum of the ranks' partials against JAX's packed
  ``psum`` (``tests/test_packed_int4.py:83-101``).

On CPU tensors no kernel launches; the card's checks are in
``tests/test_torch_port_cuda.py`` and ``chip_smoke.py`` phase 35.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import hypergef_tpu.data.synthetic as jsyn
from hypergef_tpu.ops import fused as jfused
from hypergef_tpu.ops import pallas_kernels as jpk
from hypergef_tpu.parallel import dense_shard as jdense
from hypergef_tpu.parallel.mesh import make_mesh as jmake_mesh
from hypergef_tpu.sparse import planner as jplanner
from hypergef_tpu.sparse.hypergraph import Hypergraph as JHypergraph

import hypergef_tpu_torch.data.synthetic as tsyn
from hypergef_tpu_torch import serve
from hypergef_tpu_torch.ops import fused, fused_dense, library
from hypergef_tpu_torch.parallel import dense_shard
from hypergef_tpu_torch.sparse import plancache
from hypergef_tpu_torch.sparse.hypergraph import Hypergraph
from hypergef_tpu_torch.sparse.planner import (
    AggregationPlan, DenseIncidence, plan_tree, unpack_nibbles,
)
from hypergef_tpu_torch.train.trainer import TrainConfig, Trainer

BF16_TOL = dict(rtol=3e-2, atol=3e-2)
N, E, F = 60, 31, 6


@pytest.fixture(autouse=True)
def deterministic():
    prev = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    yield
    torch.use_deterministic_algorithms(prev)


def _counts_to_7():
    """(v, e) incidences of a 60 × 31 graph listed 1 to 7 times over."""
    rng = np.random.default_rng(5)
    cells = rng.choice(N * E, 240, replace=False)
    v, e = cells // E, cells % E
    reps = rng.integers(1, 8, 240)
    reps[0] = 7
    return np.repeat(v, reps), np.repeat(e, reps)


@functools.lru_cache(maxsize=None)
def graphs(name):
    """(JAX graph, port graph) of ``name``: ``random`` or ``counts7``."""
    if name == "random":
        return (jsyn.random_hypergraph(N, E, avg_edge_size=5.0, seed=3),
                tsyn.random_hypergraph(N, E, avg_edge_size=5.0, seed=3))
    v, e = _counts_to_7()
    return (JHypergraph.from_coo(v, e, num_nodes=N, num_edges=E, dedup=False),
            Hypergraph.from_coo(v, e, num_nodes=N, num_edges=E, dedup=False))


@functools.lru_cache(maxsize=None)
def inputs(f=F):
    rng = np.random.default_rng(11)
    return (rng.normal(size=(N, f)).astype(np.float32),
            rng.uniform(0.5, 1.5, (E, 1)).astype(np.float32),
            rng.normal(size=(N, f)).astype(np.float32))


def port_plans(name):
    """The int8 and the packed plan of the port, each with the tree (max)."""
    thg = graphs(name)[1]
    tree = plan_tree(thg)
    return {packed: AggregationPlan(dense=DenseIncidence.from_hypergraph(thg, "cpu", packed),
                                    tree=tree) for packed in (False, True)}


@pytest.fixture(scope="module")
def jax_packed_plan():
    jhg = graphs("random")[0]
    plan = jplanner.plan_aggregation(jhg)
    plan.dense = jplanner.DenseIncidence.from_hypergraph(jhg, dtype=jnp.int4)
    assert plan.dense.packed
    return plan


# (name, HGNN first aggregation or UniGNN use_deg)
CASES = {"hgnn sum": ("hgnn", "sum"), "hgnn mean": ("hgnn", "mean"),
         "unignn deg": ("unignn", True), "unignn": ("unignn", False)}


def port_call(case, route, plan, x, w):
    """The port's output and its gradients: of ⟨out, cot⟩ by x and, for
    HGNN, by wdiag (whose gradient is the kernel's d scale_e)."""
    kind, arg = CASES[case]
    thg = graphs("random")[1]
    hgd = thg.device_data("cpu")
    xt = torch.as_tensor(x).requires_grad_(True)
    wt = torch.as_tensor(w).requires_grad_(True)
    if kind == "hgnn":
        out = fused.hgnn_aggregate(hgd, xt, wt, arg, plan=plan, backend=route)
    else:
        out = fused.unignn_aggregate(hgd, xt, arg, plan=plan, backend=route)
    (out * torch.as_tensor(inputs()[2])).sum().backward()
    grads = [xt.grad] + ([wt.grad] if kind == "hgnn" else [])
    return out.detach(), grads


def jax_call(case, route, plan, x, w):
    kind, arg = CASES[case]
    jhg = graphs("random")[0]
    hgd = jhg.device_data()
    if route == "pallas":
        if kind == "hgnn":
            return jpk.hgnn_aggregate_pallas(hgd, jnp.asarray(x), jnp.asarray(w), arg, plan,
                                             interpret=True)
        return jpk.unignn_aggregate_pallas(hgd, jnp.asarray(x), arg, plan, interpret=True)
    if kind == "hgnn":
        return jfused.hgnn_aggregate(hgd, jnp.asarray(x), jnp.asarray(w), arg, plan=plan,
                                     backend="dense")
    return jfused.unignn_aggregate(hgd, jnp.asarray(x), arg, plan=plan, backend="dense")


@pytest.mark.parametrize("name", ["random", "counts7"])
def test_carrier_is_jax_bit_for_bit(name):
    jhg, thg = graphs(name)
    want = np.asarray(jplanner.DenseIncidence.from_hypergraph(jhg, dtype=jnp.int4).h)
    got = DenseIncidence.from_hypergraph(thg, "cpu", packed=True)
    assert got.packed and got.h.dtype == torch.int8
    assert tuple(got.h.shape) == (N, -(-E // 2)) == want.shape
    np.testing.assert_array_equal(got.h.numpy(), want)
    # the padding nibble past the odd E is zero
    assert not (got.h[:, -1] >> 4).any()


@pytest.mark.parametrize("name", ["random", "counts7"])
def test_unpacked_is_the_int8_table(name):
    thg = graphs(name)[1]
    i8 = DenseIncidence.from_hypergraph(thg, "cpu")
    packed = DenseIncidence.from_hypergraph(thg, "cpu", packed=True)
    assert i8.unpacked() is i8.h
    got = packed.unpacked()
    assert got.dtype == torch.int8 and torch.equal(got, i8.h)
    if name == "counts7":
        assert int(got.max()) == 7


def test_unpack_reads_signed_nibbles_as_jax():
    """JAX's S4 bitcast reads ``[0x21, 0x73, 0x05]`` as ``[1, 2, 3, 7, 5, 0]``
    and a nibble of 8 or more as negative; ``unpack_nibbles`` does too."""
    carrier = np.array([[0x21, 0x73, 0x05], [-1, 0x78, 0x0F]], np.int8)
    want = np.asarray(jax.lax.bitcast_convert_type(jnp.asarray(carrier), jnp.int4)
                      .reshape(2, -1)).astype(np.int8)
    got = unpack_nibbles(torch.as_tensor(carrier), 6)
    np.testing.assert_array_equal(got.numpy(), want)
    assert got[0].tolist() == [1, 2, 3, 7, 5, 0]
    np.testing.assert_array_equal(unpack_nibbles(torch.as_tensor(carrier), 5).numpy(),
                                  want[:, :5])


def test_rejects_counts_over_7():
    """Mirrors ``tests/test_packed_int4.py:73-80``: vertex 0 nine times in
    edge 0; the int8 table takes it, the packed forms raise."""
    v = np.zeros(9, np.int64)
    e = np.zeros(9, np.int64)
    hg = Hypergraph.from_coo(v, e, num_nodes=2, num_edges=1, dedup=False)
    with pytest.raises(MemoryError):
        DenseIncidence.from_hypergraph(hg, "cpu", packed=True)
    with pytest.raises(MemoryError):
        dense_shard.plan_sharded_dense(hg, 1, packed=True)
    assert int(DenseIncidence.from_hypergraph(hg, "cpu").h.max()) == 9


@pytest.mark.parametrize("route", ["dense", "pallas"])
@pytest.mark.parametrize("case", list(CASES))
def test_route_matches_int8_and_jax(route, case, jax_packed_plan):
    """Outputs and gradients on the packed plan bitwise equal to the int8
    plan's; outputs within the bf16 bar of JAX's packed route."""
    x, w, _ = inputs()
    plans = port_plans("random")
    before = (fused_dense.launches, fused_dense.packed_launches)
    out8, grads8 = port_call(case, route, plans[False], x, w)
    out4, grads4 = port_call(case, route, plans[True], x, w)
    assert (fused_dense.launches, fused_dense.packed_launches) == before  # CPU: plain twins
    assert torch.equal(out4, out8)
    for g4, g8 in zip(grads4, grads8):
        assert torch.equal(g4, g8)
    want = np.asarray(jax_call(case, route, jax_packed_plan, x, w))
    np.testing.assert_allclose(out4.numpy(), want, **BF16_TOL)


@pytest.mark.parametrize("route", ["dense", "pallas"])
def test_packed_grad_matches_jax(route, jax_packed_plan):
    """d⟨out, cot⟩/dx of HGNN sum on the packed plan against JAX's, through
    JAX's custom VJP on ``pallas`` (interpret mode) and autodiff on
    ``dense``."""
    x, w, cot = inputs()
    _, grads = port_call("hgnn sum", route, port_plans("random")[True], x, w)

    def f(xv):
        return jnp.sum(jax_call("hgnn sum", route, jax_packed_plan, xv, w) * cot)

    want = np.asarray(jax.grad(f)(jnp.asarray(x)))
    np.testing.assert_allclose(grads[0].numpy(), want, **BF16_TOL)


@pytest.mark.parametrize("route", ["dense", "pallas"])
def test_max_rides_the_tree(route):
    """Max on a packed plan takes V→E from the plan's tree and E→V from the
    route's own table, as with int8: bitwise the int8 plan's."""
    x, w, cot = inputs()
    thg = graphs("random")[1]
    hgd = thg.device_data("cpu")
    outs = []
    for packed, plan in port_plans("random").items():
        xt = torch.as_tensor(x).requires_grad_(True)
        out = fused.hgnn_aggregate(hgd, xt, torch.as_tensor(w), "max", plan=plan,
                                   backend=route)
        (out * torch.as_tensor(cot)).sum().backward()
        outs.append((out.detach(), xt.grad))
    assert torch.equal(outs[0][0], outs[1][0]) and torch.equal(outs[0][1], outs[1][1])


def test_packed_op_is_its_twin_and_passes_opcheck():
    """The packed op's CPU form is the plain twin on the unpacked table,
    bitwise; ``opcheck`` (schema, fake against real) passes."""
    thg = graphs("counts7")[1]
    x, w, _ = inputs()
    h4 = DenseIncidence.from_hypergraph(thg, "cpu", packed=True).h
    h8 = DenseIncidence.from_hypergraph(thg, "cpu").h
    args = (h4, torch.as_tensor(x), torch.as_tensor(w), torch.rand(N, 1))
    got = library.OPS["fused_dense_two_stage_packed"](*args)
    assert torch.equal(got, fused_dense.fused_dense_two_stage_plain(h8, *args[1:]))
    assert torch.equal(got, fused_dense.fused_dense_two_stage(*args, packed=True))
    torch.library.opcheck(library.OPS["fused_dense_two_stage_packed"], args)


def test_packed_is_said_not_guessed():
    """At E = 1 the carrier and the int8 table have the same shape [N, 1]:
    only the flag tells them apart. A count of 3 in the high nibble's place
    is padding to the carrier, a count of 0x30 = 48 to the int8 table."""
    h = torch.tensor([[0x31], [0x02]], dtype=torch.int8)
    x = torch.tensor([[1.0], [1.0]])
    se, sv = torch.ones(1, 1), torch.ones(2, 1)
    packed = fused_dense.fused_dense_two_stage(h, x, se, sv, packed=True)
    int8 = fused_dense.fused_dense_two_stage(h, x, se, sv)
    assert packed.flatten().tolist() == [3.0, 6.0]  # counts 1 and 2: xe = 3
    assert int8.flatten().tolist() == [49.0 * 51.0, 2.0 * 51.0]


def test_plan_cache_round_trip(tmp_path):
    thg = graphs("random")[1]
    plan = port_plans("random")[True]
    path = plancache.save_plan(plan, str(tmp_path / "packed.npz"))
    loaded = plancache.load_plan(path, "cpu")
    assert loaded.dense.packed and loaded.dense.num_edges == E
    assert torch.equal(loaded.dense.h, plan.dense.h)
    assert not plancache.load_plan(
        plancache.save_plan(port_plans("random")[False], str(tmp_path / "i8.npz")),
        "cpu").dense.packed
    x = torch.as_tensor(inputs()[0])
    hgd = thg.device_data("cpu")
    assert torch.equal(fused.hgnn_aggregate(hgd, x, None, "sum", loaded, "pallas"),
                       fused.hgnn_aggregate(hgd, x, None, "sum", plan, "pallas"))


def _trainer(route, packed, **kw):
    jhg, thg = graphs("random")
    rng = np.random.default_rng(2)
    x = rng.normal(size=(N, 8)).astype(np.float32)
    y = rng.integers(0, 3, N)
    cfg = TrainConfig(model="HGNN", nhid=8, nlayer=2, dropout=0.0, input_drop=0.0,
                      backend=route, seed=4)
    plan = port_plans("random")[packed]
    return Trainer(cfg, thg, x, y, nclass=3, plan=plan, device="cpu", **kw)


@pytest.mark.parametrize("route", ["dense", "pallas"])
def test_trainer_losses_equal_int8(route):
    """Five no-dropout steps on the packed plan: losses bitwise the int8
    plan's, from the same seeded weights."""
    idx = np.arange(0, N, 2)
    losses = [_trainer(route, packed).fit(idx, epochs=5, warmup=0)["losses"]
              for packed in (False, True)]
    np.testing.assert_array_equal(losses[1], losses[0])
    assert np.isfinite(losses[1]).all()


def test_serving_export_of_a_packed_plan(tmp_path):
    """A CPU export of a Trainer on a packed plan answers as the built
    server on the packed plan and as the int8 plan's server, bitwise."""
    tr = _trainer("pallas", True)
    path = str(tmp_path / "packed.hgefsrv")
    serve.export_trainer(tr, path, platforms=["cpu"])
    loaded = serve.ServingModel.load(path, device="cpu")
    x = torch.as_tensor(np.random.default_rng(9).normal(size=(N, 8)).astype(np.float32))
    params = tr.model.state_dict()
    built = {packed: serve.ServingModel(tr.cfg, tr.hg, 8, 3, "cpu", params=params,
                                        plan=port_plans("random")[packed])
             for packed in (False, True)}
    got = loaded.predict(x)
    assert torch.equal(got, built[True].predict(x))
    assert torch.equal(got, built[False].predict(x))


@pytest.mark.parametrize("d", [2, 4])
def test_sharded_carrier_is_jax_bit_for_bit(d):
    jhg, thg = graphs("counts7")
    want = jdense.plan_sharded_dense(jhg, d, packed=True)
    got = dense_shard.plan_sharded_dense(thg, d, packed=True)
    assert got.packed and want.packed and got.h.dtype == np.int8
    np.testing.assert_array_equal(got.h, want.h)
    assert got.h.shape == (d, N, got.e_pad // 2)
    for k in ("edge_bounds", "degE", "counts"):
        np.testing.assert_array_equal(getattr(got, k), getattr(want, k))
    assert got.table_bytes_per_device() == want.table_bytes_per_device() == N * got.e_pad // 2
    unpacked = dense_shard.plan_sharded_dense(thg, d)
    assert unpacked.table_bytes_per_device() == 2 * got.table_bytes_per_device()


def test_sharded_byte_guard_counts_carrier_bytes():
    """A budget between the carrier's and the int8 slice's bytes takes the
    packed plan and refuses the int8 one."""
    thg = graphs("random")[1]
    need = dense_shard.plan_sharded_dense(thg, 2, packed=True).table_bytes_per_device()
    dense_shard.plan_sharded_dense(thg, 2, max_bytes_per_device=need, packed=True)
    with pytest.raises(MemoryError, match="exceeds"):
        dense_shard.plan_sharded_dense(thg, 2, max_bytes_per_device=need)
    with pytest.raises(MemoryError, match="exceeds"):
        dense_shard.plan_sharded_dense(thg, 2, max_bytes_per_device=need - 1, packed=True)


def test_local_two_stage_packed_equals_unpacked(monkeypatch):
    """Each rank's slice product and its gradient on the carrier bitwise the
    unpacked slice's, with the whole slice as one row block and with blocks
    of 7 rows (each block unpacked on its own)."""
    thg = graphs("counts7")[1]
    plans = {p: dense_shard.plan_sharded_dense(thg, 4, packed=p) for p in (False, True)}
    x, _, cot = inputs()
    for blocks in (None, 7):
        if blocks:
            monkeypatch.setattr(dense_shard, "DENSE_BLOCK_BYTES",
                                blocks * 4 * plans[True].e_pad)
        for r in range(4):
            res = []
            for packed, plan in plans.items():
                loc = plan.local(r, "cpu")
                assert loc.packed == packed
                xt = torch.as_tensor(x).requires_grad_(True)
                out = dense_shard.local_two_stage(loc, xt, "mean")
                out.backward(torch.as_tensor(cot))
                res.append((out.detach(), xt.grad))
            assert torch.equal(res[0][0], res[1][0]) and torch.equal(res[0][1], res[1][1])
        assert len(dense_shard._row_blocks(plans[True].local(0, "cpu").h,
                                           plans[True].e_pad)) == (-(-N // 7) if blocks else 1)


def test_sharded_sum_matches_jax_psum():
    """The ranks' partials summed and scaled by degV against JAX's packed
    ``sharded_dense_hgnn_aggregate`` on four simulated devices, which equals
    its unpacked one (``tests/test_packed_int4.py:83-101``)."""
    jhg, thg = graphs("random")
    x, _, _ = inputs()
    mesh = jmake_mesh(4, 1, devices=jax.devices()[:4])
    degV = jnp.asarray(jhg.degV)
    want = np.asarray(jdense.sharded_dense_hgnn_aggregate(
        jdense.plan_sharded_dense(jhg, 4, packed=True), mesh, jnp.asarray(x), None, "sum",
        degV))
    plan = dense_shard.plan_sharded_dense(thg, 4, packed=True)
    xt = torch.as_tensor(x)
    got = sum(dense_shard.local_two_stage(plan.local(r, "cpu"), xt) for r in range(4))
    got = got * torch.as_tensor(thg.degV).reshape(-1, 1)
    np.testing.assert_allclose(got.numpy(), want, **BF16_TOL)


def test_default_stays_int8():
    """Nothing but the explicit flag builds the packed form."""
    thg = graphs("random")[1]
    assert not AggregationPlan.dense_plan(thg, "cpu").dense.packed
    assert not dataclasses.replace(DenseIncidence.from_hypergraph(thg, "cpu")).packed
    assert not dense_shard.plan_sharded_dense(thg, 2).packed
