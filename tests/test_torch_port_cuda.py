"""The port's CUDA kernels against their plain versions, on the card.

Every test here needs an NVIDIA Hopper card and skips without one. This
file imports no JAX, so it also runs where JAX is not installed:

    python -m pytest --noconftest -m cuda tests/test_torch_port_cuda.py

Tolerances:

* fused dense op, forward and backward: rtol 1e-2 and atol 1e-2·max|plain|.
  Kernel and plain version round the same operands to bf16, but sum in
  different orders, so Xe can round to a neighbouring bf16 value (2^-8
  relative) before the second stage. Its packed form (the nibble carrier):
  bitwise equal to the int8 kernel on the same counts, forward and
  backward (the same work split, products and order).
* gather kernel and the probes' chunk-sum ring: bitwise equal to the
  sequential plain loop, which rounds each product and each sum in the same
  order; a row holding Inf that only dead slots name gives NaN in the same
  places.
* band kernel (aligned stages): rtol 1e-5 and atol 1e-5·max|plain|. The
  products are exact in f32 in both forms; the kernel sums each row in one
  order (window, then spill), the plain chain in bmm's order and band and
  spill apart.
* masked argmax kernel: values and ids bitwise equal to the twin (a max is
  one of its inputs; both take the lowest id among equal values).
* masked arg-sum kernel: rtol 1e-6 and atol 1e-6·max|plain| (the same few
  f32 terms summed in another order).
* bit-packed product kernel: rtol 1e-5 and atol 1e-5·max|plain|. The
  products are exact (0/1 times bf16); the kernel sums each row in its
  layout's order (word ascending, then bit), the twin in its matmul's
  order.
* segment-sum kernel: rtol 1e-6 and atol 1e-6·max|plain| (the same f32
  terms: every value is one lane's f32 sum in CSR order, long segments
  included, against segment_reduce's own order).
* record-routed sum: bitwise equal to the sequential CSR-order sum
  (``record_routed_dx_sequential``: each won value added in CSR order from
  +0.0), and within the segment sum's 1e-6 of its plain twin.
* the compiled step and request (``utils/graphs.py``): a CUDA-graph replay
  bitwise equal to the eager step or request under the same seed, dropout
  on: the graph launches the same kernels on the same inputs. So are the
  recorded minibatch steps (a graph a pad shape), a one-rank nccl world's
  recorded ``DistTrainer`` fit and ``DPMinibatchTrainer`` steps.
* segment sum over a pad shape's runs (padded to ``max_warp_runs`` with
  empty runs): bitwise equal to the launch over the batch's exact runs
  and to the plain version.
"""

import dataclasses
import functools
import importlib.util
import os
from pathlib import Path

import numpy as np
import pytest
import torch

from hypergef_tpu_torch.data.synthetic import community_hypergraph
from hypergef_tpu_torch.ops import (
    aligned_band, aligned_max, bitstream, ell_gather, fused, fused_dense,
)
from hypergef_tpu_torch.sparse import planner
from hypergef_tpu_torch.sparse.hypergraph import Hypergraph
from hypergef_tpu_torch.sparse.reorder import apply_vertex_order, community_reorder

pytestmark = pytest.mark.cuda

REPO = Path(__file__).resolve().parents[1]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _operands(n, e, f, density, seed, device):
    rng = np.random.default_rng(seed)
    h = (rng.random((n, e)) < density).astype(np.int8)
    h[rng.random((n, e)) < density / 8] = 3  # repeated incidences count too
    x = rng.normal(size=(n, f)).astype(np.float32)
    se = rng.uniform(0.1, 1.0, size=(e, 1)).astype(np.float32)
    sv = rng.uniform(0.1, 1.0, size=(n, 1)).astype(np.float32)
    return [torch.as_tensor(a, device=device) for a in (h, x, se, sv)]


@pytest.mark.parametrize(
    "n,e,f,density",
    [
        (5, 3, 1, 0.5),
        (120, 80, 8, 0.06),
        (301, 187, 17, 0.03),
        (1000, 500, 4, 0.01),
        (2048, 300, 40, 0.02),
        (16242, 100, 32, 0.04),
        (16242, 100, 100, 0.04),
        (2708, 2708, 32, 0.0015),
        (2708, 2708, 7, 0.0015),
        (19717, 7963, 32, 0.0014),
        (130, 4099, 3, 0.01),
        (3000, 17, 65, 0.2),
    ],
)
def test_kernel_matches_plain(cuda, n, e, f, density):
    h, x, se, sv = _operands(n, e, f, density, seed=n + e + f, device=cuda)
    before = fused_dense.launches
    got = fused_dense.fused_dense_two_stage(h, x, se, sv)
    again = fused_dense.fused_dense_two_stage(h, x, se, sv)
    torch.cuda.synchronize()
    assert fused_dense.launches == before + 2
    want = fused_dense.fused_dense_two_stage_plain(h, x, se, sv)
    scale = float(want.abs().max())
    torch.testing.assert_close(got, want, rtol=1e-2, atol=1e-2 * scale)
    assert torch.equal(got, again), "two runs differ"


@pytest.mark.parametrize("n,e,f,density", [(301, 187, 17, 0.03), (16242, 100, 4, 0.04),
                                           (2708, 2708, 32, 0.0015)])
def test_backward_matches_plain_formula(cuda, n, e, f, density):
    h, x, se, sv = _operands(n, e, f, density, seed=n + f, device=cuda)
    g = torch.as_tensor(np.random.default_rng(f).normal(size=(n, f)).astype(np.float32),
                        device=cuda)
    ts = [t.clone().requires_grad_(True) for t in (x, se, sv)]
    out = fused_dense.fused_dense_two_stage(h, *ts)
    before = (fused_dense.launches, fused_dense.v2e_launches)
    out.backward(g)
    torch.cuda.synchronize()
    # dx and d scale_v run the op once each, d scale_e its first phase twice
    assert (fused_dense.launches, fused_dense.v2e_launches) == (before[0] + 2, before[1] + 2)
    for name, t, want in zip(("dx", "d_scale_e", "d_scale_v"), ts,
                             fused_dense.fused_dense_backward_plain(h, x, se, sv, g)):
        scale = float(want.abs().max())
        torch.testing.assert_close(t.grad, want, rtol=1e-2, atol=1e-2 * scale, msg=name)


def _gather_operands(n, c, ngs, f, seed, device):
    rng = np.random.default_rng(seed)
    x = torch.as_tensor(rng.normal(size=(n, f)).astype(np.float32), device=device)
    gidx = torch.as_tensor(rng.integers(0, n, size=(c, ngs)).astype(np.int32), device=device)
    mask = torch.as_tensor((rng.random((c, ngs)) > 0.2).astype(np.float32), device=device)
    table = ell_gather.GatherTable(gidx=gidx, gidx_long=gidx.long(), mask=mask, num_inputs=n)
    return x, table


@pytest.mark.parametrize(
    "n,c,ngs,f",
    [(300, 700, 8, 16), (50, 3, 1, 1), (1000, 777, 5, 3), (2000, 1500, 37, 32),
     (500, 300, 12, 33), (19717, 9000, 12, 4), (7963, 20000, 4, 32)],
)
def test_gather_kernel_is_bitwise_plain(cuda, n, c, ngs, f):
    x, table = _gather_operands(n, c, ngs, f, seed=n + c + f, device=cuda)
    before = ell_gather.launches
    got = ell_gather.ell_gather_sum(x, table)
    again = ell_gather.ell_gather_sum(x, table)
    torch.cuda.synchronize()
    assert ell_gather.launches == before + 2
    want = ell_gather.ell_gather_sum_plain(x, table.gidx_long, table.mask)
    assert got.shape == want.shape == (c, f)
    assert torch.equal(got, want), float((got - want).abs().max())
    assert torch.equal(got, again), "two runs differ"


def _dead_inf_operands(n, c, ngs, f, seed, device, aligned=True):
    """x, gidx, mask with row 0 of x all Inf, named only by dead slots (a
    quarter of them), so 0·Inf makes NaN where the plain loop makes it; x
    is 16-byte aligned or, with ``aligned`` False, a contiguous view 4 bytes
    past an aligned start."""
    rng = np.random.default_rng(seed)
    xn = rng.normal(size=(n, f)).astype(np.float32)
    xn[0] = np.inf
    gidx = rng.integers(1, n, size=(c, ngs)).astype(np.int32)
    mask = (rng.random((c, ngs)) > 0.3).astype(np.float32)
    gidx[(mask == 0) & (rng.random((c, ngs)) < 0.25)] = 0
    if aligned:
        x = torch.as_tensor(xn, device=device)
    else:
        x = torch.empty(n * f + 1, device=device)[1:].view(n, f)
        x.copy_(torch.as_tensor(xn))
        assert x.data_ptr() % 16 == 4 and x.is_contiguous()
    return (x, torch.as_tensor(gidx, device=device), torch.as_tensor(mask, device=device))


def _assert_bitwise_with_nans(got, want):
    nan = torch.isnan(want)
    assert torch.equal(torch.isnan(got), nan), "NaN in other places than the plain loop's"
    assert torch.equal(got[~nan], want[~nan]), float((got - want)[~nan].abs().max())


@pytest.mark.parametrize("aligned", [True, False])
@pytest.mark.parametrize("f", [1, 3, 4, 6, 32, 33, 128])
@pytest.mark.parametrize("ngs", [1, 2, 5, 8, 16, 64])
def test_gather_kernel_is_bitwise_plain_in_every_form(cuda, ngs, f, aligned):
    """Every form of the schedule (quad, wide; vector or scalar
    tables; several batches at ngs 64) on 1003 chunks, a multiple of no
    warp's or block's chunks, with dead slots naming an Inf row."""
    n, c = 517, 1003
    x, gidx, mask = _dead_inf_operands(n, c, ngs, f, seed=ngs * 100 + f, device=cuda,
                                       aligned=aligned)
    table = ell_gather.GatherTable(gidx=gidx, gidx_long=gidx.long(), mask=mask, num_inputs=n)
    sched = ell_gather.gather_schedule(f, ngs, x.data_ptr() % 16 == 0)
    assert (sched.form == "quad") == (aligned and f % 4 == 0)
    before = ell_gather.launches
    got = ell_gather.ell_gather_sum(x, table)
    again = ell_gather.ell_gather_sum(x, table)
    torch.cuda.synchronize()
    assert ell_gather.launches == before + 2
    want = ell_gather.ell_gather_sum_plain(x, table.gidx_long, table.mask)
    assert bool(torch.isnan(want).any()) and got.shape == want.shape == (c, f)
    _assert_bitwise_with_nans(got, want)
    _assert_bitwise_with_nans(again, got)


def test_gather_wrapper_rejects_what_the_kernel_does_not_take(cuda):
    x, table = _gather_operands(64, 32, 4, 8, seed=1, device=cuda)
    with pytest.raises(TypeError):
        ell_gather.ell_gather_sum(x.double(), table)
    with pytest.raises(TypeError):
        ell_gather.ell_gather_sum(x[:10], table)
    with pytest.raises(ValueError, match="contiguous"):
        ell_gather.ell_gather_sum(x.t().contiguous().t(), table)
    with pytest.raises(ValueError):
        ell_gather.ell_gather_sum(x.cpu(), table)


@pytest.mark.parametrize("offset", [1, 3, 8])
def test_kernel_reads_a_table_at_any_byte_offset(cuda, offset):
    """The table's rows are read as the aligned 16-byte words that hold
    them, so a table that starts off a 16-byte boundary (a view) gives the
    same result as a copy of it."""
    h, x, se, sv = _operands(777, 203, 12, 0.05, seed=offset, device=cuda)
    buf = torch.zeros(h.numel() + offset, dtype=torch.int8, device=cuda)
    view = buf[offset:].view(h.shape)
    view.copy_(h)
    assert view.data_ptr() % 16 != 0 or offset % 16 == 0
    got = fused_dense.fused_dense_two_stage(view, x, se, sv)
    assert torch.equal(got, fused_dense.fused_dense_two_stage(h, x, se, sv))


def test_kernel_is_one_cuda_kernel_a_call(cuda):
    from hypergef_tpu_torch.utils.profiling import device_events, profiler

    h, x, se, sv = _operands(16242, 100, 32, 0.04, seed=3, device=cuda)
    fused_dense.fused_dense_two_stage(h, x, se, sv)
    fused_dense._launch_v2e(h, x)
    torch.cuda.synchronize()
    for call in (lambda: fused_dense.fused_dense_two_stage(h, x, se, sv),
                 lambda: fused_dense._launch_v2e(h, x)):
        with profiler() as prof:
            call()
            torch.cuda.synchronize()
        names = [e.name for e in device_events(prof)]
        assert len(names) == 1 and "fused_dense_kernel" in names[0], names


def test_kernel_runs_on_two_streams_at_once(cuda):
    """Each call owns its scratch (partials, Xe): calls queued on two streams
    without waiting for each other each give the plain version's result,
    bitwise equal to the same call alone."""
    ops = [_operands(2708, 2708, 32, 0.0015, seed=s, device=cuda) for s in (1, 2)]
    alone = [fused_dense.fused_dense_two_stage(*o) for o in ops]
    streams = [torch.cuda.Stream(cuda) for _ in range(2)]
    torch.cuda.synchronize()
    outs = ([], [])
    for _ in range(20):
        for st, o, got in zip(streams, ops, outs):
            with torch.cuda.stream(st):
                got.append(fused_dense.fused_dense_two_stage(*o))
    torch.cuda.synchronize()
    for o, a, got in zip(ops, alone, outs):
        want = fused_dense.fused_dense_two_stage_plain(*o)
        torch.testing.assert_close(a, want, rtol=1e-2, atol=1e-2 * float(want.abs().max()))
        for g in got:
            assert torch.equal(g, a)


def test_entry_refuses_a_grid_beyond_the_coresident_limit(cuda):
    """A cooperative grid larger than the card holds at once is refused with
    an error (never run, never hung), and the wrapper's check raises on it."""
    from hypergef_tpu_torch.ops import _build

    h, x, se, sv = _operands(2708, 2708, 8, 0.0015, seed=4, device=cuda)
    lib = _build.load_library()
    sms, ctas = fused_dense._card(torch.cuda.current_device())
    ws = fused_dense.work_split(2708, 2708, 8, sms, ctas)
    out = torch.empty((2708, 8), device=cuda)
    pa = torch.empty((ws.splits_a, 2708, ws.fp), device=cuda)
    xe = torch.empty((2708, ws.fp), dtype=torch.bfloat16, device=cuda)
    pc = torch.empty((ws.splits_c, 2708, ws.fp), device=cuda)
    stream = torch.cuda.current_stream().cuda_stream

    def call(grid):
        return lib.hg_fused_dense_two_stage(
            h.data_ptr(), x.data_ptr(), se.data_ptr(), sv.data_ptr(), out.data_ptr(),
            pa.data_ptr(), xe.data_ptr(), pc.data_ptr(), 2708, 2708, 8, ws.splits_a, ws.k_a,
            ws.ways_a, ws.splits_c, ws.k_c, ws.ways_c, grid, 0, stream)

    err = call(sms * 64 + 1)
    assert err != 0
    with pytest.raises(RuntimeError, match="launch failed"):
        fused_dense._raise_on(err, lib, "fused_dense_two_stage")
    assert call(ws.grid) == 0  # the refusal left no error behind
    want = fused_dense.fused_dense_two_stage_plain(h, x, se, sv)
    torch.testing.assert_close(out, want, rtol=1e-2, atol=1e-2 * float(want.abs().max()))


def test_wrapper_rejects_what_the_kernel_does_not_take(cuda):
    h, x, se, sv = _operands(64, 32, 8, 0.1, seed=1, device=cuda)
    with pytest.raises(TypeError):
        fused_dense.fused_dense_two_stage(h.float(), x, se, sv)
    with pytest.raises(ValueError, match="contiguous"):
        fused_dense.fused_dense_two_stage(h, x.t().contiguous().t(), se, sv)
    with pytest.raises(ValueError):
        fused_dense.fused_dense_two_stage(h.cpu(), x, se, sv)


# The packed-int4 form of the fused dense kernel.

def _packed(h):
    """The nibble carrier of an int8 table of counts in [0, 7], on its device."""
    return torch.as_tensor(planner.pack_nibbles(h.cpu().numpy()), device=h.device)


def _counts_to_7(h, seed):
    """``h`` with a share of its counts raised to 4-7: a carrier's every nibble value."""
    rng = np.random.default_rng(seed)
    live = h.cpu().numpy() != 0
    up = torch.as_tensor(live * rng.integers(1, 8, size=live.shape).astype(np.int8))
    return up.to(h.device)


@pytest.mark.parametrize(
    "n,e,f,density",
    [
        (5, 3, 1, 0.5),
        (120, 80, 8, 0.06),
        (301, 187, 17, 0.03),
        (16242, 100, 32, 0.04),
        (16242, 100, 4, 0.04),
        (16242, 100, 100, 0.04),
        (2708, 2708, 32, 0.0015),
        (2708, 2708, 7, 0.0015),
        (19717, 7963, 32, 0.0014),
        (130, 4099, 3, 0.01),
        (3000, 17, 65, 0.2),
        (64, 1, 8, 0.5),
    ],
)
@pytest.mark.parametrize("counts", ["ones and threes", "up to 7"])
def test_packed_kernel_is_bitwise_the_int8_kernel(cuda, n, e, f, density, counts):
    """The packed form on the carrier against the int8 form on the same
    counts: bitwise equal (odd E included: the padding nibble is never
    read as a count), within the plain bar, two runs equal, one count a
    call on its own counter."""
    h, x, se, sv = _operands(n, e, f, density, seed=n + e + f, device=cuda)
    if counts == "up to 7":
        h = _counts_to_7(h, seed=n + f)
    carrier = _packed(h)
    assert tuple(carrier.shape) == (n, -(-e // 2))
    before = (fused_dense.launches, fused_dense.packed_launches)
    got = fused_dense.fused_dense_two_stage(carrier, x, se, sv, packed=True)
    again = fused_dense.fused_dense_two_stage(carrier, x, se, sv, packed=True)
    torch.cuda.synchronize()
    assert (fused_dense.launches, fused_dense.packed_launches) == (before[0], before[1] + 2)
    int8 = fused_dense.fused_dense_two_stage(h, x, se, sv)
    assert torch.equal(got, int8), float((got - int8).abs().max())
    assert torch.equal(got, again), "two runs differ"
    want = fused_dense.fused_dense_two_stage_plain(h, x, se, sv)
    torch.testing.assert_close(got, want, rtol=1e-2, atol=1e-2 * float(want.abs().max()))


@pytest.mark.parametrize("n,e,f,density", [(301, 187, 17, 0.03), (16242, 100, 4, 0.04),
                                           (2708, 2708, 32, 0.0015),
                                           (19717, 7963, 32, 0.0014)])
def test_packed_backward_is_bitwise_the_int8_backward(cuda, n, e, f, density):
    """dx, d scale_e and d scale_v on the carrier: the packed op twice and
    the packed V→E phase twice, bitwise the int8 form's gradients."""
    h, x, se, sv = _operands(n, e, f, density, seed=n + f, device=cuda)
    h = _counts_to_7(h, seed=f)
    carrier = _packed(h)
    g = torch.as_tensor(np.random.default_rng(f).normal(size=(n, f)).astype(np.float32),
                        device=cuda)
    grads = []
    for table, packed in ((h, False), (carrier, True)):
        ts = [t.clone().requires_grad_(True) for t in (x, se, sv)]
        out = fused_dense.fused_dense_two_stage(table, *ts, packed=packed)
        before = (fused_dense.packed_launches, fused_dense.packed_v2e_launches)
        out.backward(g)
        torch.cuda.synchronize()
        if packed:
            assert (fused_dense.packed_launches, fused_dense.packed_v2e_launches) == (
                before[0] + 2, before[1] + 2)
        grads.append([t.grad for t in ts])
    for name, a, b in zip(("dx", "d_scale_e", "d_scale_v"), *grads):
        assert torch.equal(a, b), name


@pytest.mark.parametrize("offset", [1, 3, 8])
def test_packed_kernel_reads_a_carrier_at_any_byte_offset(cuda, offset):
    h, x, se, sv = _operands(777, 203, 12, 0.05, seed=offset, device=cuda)
    carrier = _packed(h)
    buf = torch.zeros(carrier.numel() + offset, dtype=torch.int8, device=cuda)
    view = buf[offset:].view(carrier.shape)
    view.copy_(carrier)
    got = fused_dense.fused_dense_two_stage(view, x, se, sv, packed=True)
    assert torch.equal(got, fused_dense.fused_dense_two_stage(h, x, se, sv))


def test_packed_kernel_is_one_cuda_kernel_a_call(cuda):
    """The packed two-stage call and the packed V→E phase are one CUDA
    kernel each, the kernel's packed form, under ``torch.profiler``, in this
    process after the int8 form's sessions. Opened otherwise than by
    ``utils/profiling.py::profiler``, a session kept CUPTI attached from the
    process's first session, and a short session's kernel, stamped from a
    stale clock correlation, fell out of its window: no device events."""
    from hypergef_tpu_torch.utils.profiling import device_events, profiler

    h, x, se, sv = _operands(16242, 100, 32, 0.04, seed=3, device=cuda)
    carrier = _packed(h)
    calls = (lambda: fused_dense.fused_dense_two_stage(carrier, x, se, sv, packed=True),
             lambda: fused_dense._launch_v2e(carrier, x, 100))
    for call in calls:
        call()
    torch.cuda.synchronize()
    for call in calls:
        with profiler() as prof:
            call()
            torch.cuda.synchronize()
        names = [e.name for e in device_events(prof)]
        assert len(names) == 1 and "fused_dense_kernel<" in names[0], names
        assert "true>" in names[0].split("fused_dense_kernel<", 1)[1].split("(", 1)[0], names


def test_packed_call_makes_no_table(cuda):
    """A packed call at pubmed_real's shape grows the card's peak memory by
    its output and scratch alone, far under the int8 table's bytes."""
    h, x, se, sv = _operands(19717, 7963, 32, 0.0014, seed=3, device=cuda)
    carrier = _packed(h)
    del h
    fused_dense.fused_dense_two_stage(carrier, x, se, sv, packed=True)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(cuda)
    base = torch.cuda.memory_allocated(cuda)
    fused_dense.fused_dense_two_stage(carrier, x, se, sv, packed=True)
    torch.cuda.synchronize()
    assert torch.cuda.max_memory_allocated(cuda) - base < 19717 * 7963 // 4


def test_packed_wrapper_rejects_what_the_kernel_does_not_take(cuda):
    h, x, se, sv = _operands(64, 33, 8, 0.1, seed=1, device=cuda)
    carrier = _packed(h)
    with pytest.raises(TypeError, match="carrier"):
        fused_dense.fused_dense_two_stage(h, x, se, sv, packed=True)  # 33 columns, not 17
    with pytest.raises(TypeError, match="carrier"):
        fused_dense._launch_v2e(carrier, x, 35)
    with pytest.raises(ValueError):
        fused_dense.fused_dense_two_stage(carrier.cpu(), x, se, sv, packed=True)


@pytest.mark.parametrize("backend", ["pallas", "dense"])
def test_routes_on_a_packed_plan(cuda, backend):
    """On the card the pallas route runs the packed kernel on a packed plan
    (never the int8 one), the dense route its library products on the
    unpacked table; each bitwise the int8 plan's."""
    hg = community_hypergraph(3000, 301, 12, 8, 0.1, seed=2)
    hgd = hg.device_data(cuda)
    x = torch.as_tensor(np.random.default_rng(0).normal(size=(3000, 16)).astype(np.float32),
                        device=cuda)
    outs = []
    for packed in (False, True):
        plan = planner.AggregationPlan(dense=planner.DenseIncidence.from_hypergraph(
            hg, cuda, packed=packed))
        before = (fused_dense.launches, fused_dense.packed_launches)
        outs.append(fused.hgnn_aggregate(hgd, x, None, "mean", plan=plan, backend=backend))
        torch.cuda.synchronize()
        launched = (fused_dense.launches - before[0], fused_dense.packed_launches - before[1])
        if backend == "pallas":
            assert launched == ((0, 1) if packed else (1, 0))
        else:
            assert launched == (0, 0)
    assert torch.equal(outs[0], outs[1])


def sorted_community_graph(n, e, comm, avg, noise, seed, duplicate=0.0):
    """A community graph from raw (shuffled) vertex ids, reordered by the
    coarsening pass, as bench.py builds its clustered graph. With
    ``duplicate`` that share of the incidences is listed twice, so the band
    and spill tables hold counts of 2."""
    hg = community_hypergraph(n, e, comm, avg, noise, seed)
    hg, _ = apply_vertex_order(hg, np.random.default_rng(7).permutation(n), sort_edges=False)
    hg, _ = community_reorder(hg)
    if duplicate:
        v = hg.ht_indices.astype(np.int64)
        ed = np.repeat(np.arange(e), np.diff(hg.ht_indptr))
        twice = np.random.default_rng(seed).random(v.size) < duplicate
        hg = Hypergraph.from_coo(np.concatenate([v, v[twice]]), np.concatenate([ed, ed[twice]]),
                                 num_nodes=n, num_edges=e, dedup=False)
    return hg


def split_buckets(st):
    """The same bucketed stage laid out as several band and spill buckets out
    of group order: odd groups' windows get one more block (block 0, with
    zero band columns), and the spilling groups go to two spill buckets, the
    first in reverse group order, padded to a common width with zero-row
    slots. Neither slot map is then the identity."""
    g_rows, b_rows, n = st.group_rows, st.block_rows, st.num_inputs
    band, win = {}, {}
    for b in st.buckets:
        for l, g in enumerate(b.group_ids):
            band[int(g)], win[int(g)] = b.b_dense[l], b.win_block[l]
    n_groups = len(st.base_slot)
    classes = {}
    for g in range(n_groups):
        classes.setdefault((g % 2, len(win[g])), []).append(g)
    buckets, base_slot, slot = [], np.zeros(n_groups, np.int32), 0
    for (odd, _), gids in sorted(classes.items()):
        bands = [np.concatenate([band[g], np.zeros((g_rows, b_rows * odd), np.int8)], axis=1)
                 for g in gids]
        wins = [np.concatenate([win[g], np.zeros(odd, np.int32)]) for g in gids]
        buckets.append(planner.AlignedBucket(np.stack(bands), np.stack(wins),
                                             np.asarray(gids, np.int32)))
        base_slot[gids] = slot + np.arange(len(gids))
        slot += len(gids)
    per_group = {}
    for sp in st.spills:
        for l, g in enumerate(sp.group_ids):
            per_group[int(g)] = (sp.b_spill[l], sp.spill_src[l])
    spilling = sorted(per_group)
    parts = [[g for g in spilling if g % 3 == 0][::-1], [g for g in spilling if g % 3]]
    spills, spill_slot, m = [], np.zeros(n_groups, np.int32), 0
    for gids in (p for p in parts if p):
        sw = max(per_group[g][1].size for g in gids)
        tabs = [np.pad(per_group[g][0], ((0, 0), (0, sw - per_group[g][0].shape[1])))
                for g in gids]
        srcs = [np.pad(per_group[g][1], (0, sw - per_group[g][1].size), constant_values=n)
                for g in gids]
        spills.append(planner.AlignedSpill(np.stack(tabs), np.stack(srcs).astype(np.int32),
                                           np.asarray(gids, np.int32)))
        spill_slot[gids] = m + np.arange(len(gids))
        m += len(gids)
    spill_slot[[g for g in range(n_groups) if g not in per_group]] = m
    return st._replace(buckets=tuple(buckets), spills=tuple(spills), base_slot=base_slot,
                       spill_slot=spill_slot)


def widen_windows(st, gids, extra):
    """The same bucketed stage with the windows of groups ``gids`` wider by
    ``extra`` blocks (block 0, with zero band columns), in a bucket of their
    own: groups far wider than the rest, which the band kernel splits."""
    g_rows, b_rows = st.group_rows, st.block_rows
    band, win = {}, {}
    for b in st.buckets:
        for l, g in enumerate(b.group_ids):
            band[int(g)], win[int(g)] = b.b_dense[l], b.win_block[l]
    buckets, base_slot, slot = [], np.zeros(len(st.base_slot), np.int32), 0
    for wide in (False, True):
        classes = {}
        for g in range(len(st.base_slot)):
            if (g in gids) == wide:
                classes.setdefault(len(win[g]), []).append(g)
        for _, members in sorted(classes.items()):
            pad = extra if wide else 0
            buckets.append(planner.AlignedBucket(
                np.stack([np.pad(band[g], ((0, 0), (0, pad * b_rows))) for g in members]),
                np.stack([np.pad(win[g], (0, pad)) for g in members]).astype(np.int32),
                np.asarray(members, np.int32)))
            base_slot[members] = slot + np.arange(len(members))
            slot += len(members)
    return st._replace(buckets=tuple(buckets), base_slot=base_slot)


def widen_spills(st, extra):
    """The same bucketed stage with ``extra`` more slots in every spill
    bucket (zero columns whose source is the zero row N), so no spill width
    is a multiple of 4 and the spill tables' rows lie at odd byte offsets."""
    n = st.num_inputs
    spills = tuple(
        planner.AlignedSpill(np.pad(sp.b_spill, ((0, 0), (0, 0), (0, extra))),
                             np.pad(sp.spill_src, ((0, 0), (0, extra)),
                                    constant_values=n).astype(np.int32),
                             sp.group_ids)
        for sp in st.spills)
    return st._replace(spills=spills)


def spill_only_rows(st):
    """The same stage with the window counts of every row that spills set to
    zero: those rows reach their sources through spill slots alone."""
    if isinstance(st, planner.AlignedStage):
        band = st.b_dense.copy()
        band[(st.b_spill != 0).any(axis=2)] = 0
        return st._replace(b_dense=band)
    spilling = {int(g): (sp.b_spill[l] != 0).any(axis=1)
                for sp in st.spills for l, g in enumerate(sp.group_ids)}
    buckets = []
    for b in st.buckets:
        band = b.b_dense.copy()
        for l, g in enumerate(b.group_ids):
            if int(g) in spilling:
                band[l][spilling[int(g)]] = 0
        buckets.append(b._replace(b_dense=band))
    return st._replace(buckets=tuple(buckets))


def with_gaps(hg):
    """``hg`` without the incidences of edges [128, 256) and vertices [256,
    384): a group of each stage with no live slot."""
    v = hg.ht_indices.astype(np.int64)
    e = np.repeat(np.arange(hg.num_edges), np.diff(hg.ht_indptr))
    keep = ~(((e >= 128) & (e < 256)) | ((v >= 256) & (v < 384)))
    return Hypergraph.from_coo(v[keep], e[keep], num_nodes=hg.num_nodes, num_edges=hg.num_edges)


@functools.lru_cache(maxsize=None)
def aligned_plan(case):
    """The host plans the band kernel is held at: a small community graph
    in each form and layout, and the shapes that go wrong."""
    if case == "dense":  # bands about half full: the max kernels' chunks cut by entries
        return planner.plan_aligned(sorted_community_graph(600, 400, 2, 150, 0.0, 5))
    if case == "gap":
        return planner.plan_aligned(with_gaps(sorted_community_graph(2000, 1600, 25, 5, 0.02, 3)))
    if case in ("spill_only", "uniform_spill_only"):
        plan = aligned_plan("bucketed" if case == "spill_only" else "uniform")
        return dataclasses.replace(plan, edge_stage=spill_only_rows(plan.edge_stage),
                                   vertex_stage=spill_only_rows(plan.vertex_stage))
    if case == "empty":
        return planner.plan_aligned(Hypergraph.from_coo([], [], num_nodes=300, num_edges=200))
    if case == "past_n":  # N = 300 rows, windows of 4 blocks: block 3 holds no row
        return planner.plan_aligned(sorted_community_graph(300, 200, 5, 4, 0.02, 1),
                                    form="uniform", window_blocks=4)
    if case == "width32":  # 4096-row windows
        return planner.plan_aligned(sorted_community_graph(6000, 3000, 24, 12, 0.02, 0),
                                    form="uniform", window_blocks=32)
    if case == "counts":
        return planner.plan_aligned(sorted_community_graph(2000, 1600, 25, 5, 0.02, 3, 0.05))
    hg = sorted_community_graph(2000, 1600, 25, 5, 0.02, 3)
    if case in ("split", "odd_spill", "wide", "wide200"):
        plan = planner.plan_aligned(hg, group_rows=200 if case == "wide200" else 128)
        relay = {"split": split_buckets, "odd_spill": functools.partial(widen_spills, extra=5),
                 "wide": functools.partial(widen_windows, gids=(0, 5, 6), extra=12),
                 "wide200": functools.partial(widen_windows, gids=(1, 4), extra=12)}[case]
        return dataclasses.replace(plan, edge_stage=relay(plan.edge_stage),
                                   vertex_stage=relay(plan.vertex_stage))
    kw = {"bucketed": {}, "uniform": {"form": "uniform"}, "group64": {"group_rows": 64},
          "block64": {"block_rows": 64}, "group200": {"group_rows": 200},
          "group24": {"group_rows": 24}, "block32": {"block_rows": 32},
          "block200": {"block_rows": 200}}[case]
    return planner.plan_aligned(hg, **kw)


ALIGNED_CASES = ("bucketed", "split", "uniform", "group64", "block64", "counts", "past_n",
                 "width32", "empty")
# the shapes the tensor-core band kernel cuts differently: groups taller than
# a CTA's 128 rows or not a multiple of its 16-row tiles, source blocks
# shorter than or not a multiple of its 64-row slabs, spill widths at odd
# byte offsets, groups so much wider than the rest that the kernel splits
# them over two CTAs (also with two CTAs of rows a group); width32: a window
# of 64 slabs, wider than the 4-slab ring
BAND_CASES = ALIGNED_CASES + ("group200", "group24", "block32", "block200", "odd_spill", "wide",
                              "wide200")


@pytest.mark.parametrize("case", BAND_CASES)
@pytest.mark.parametrize("f", [3, 5, 32, 48, 100])
def test_band_kernel_matches_plain(cuda, case, f):
    plan = dataclasses.replace(aligned_plan(case), form="pallas_auto")
    for stage in plan.device(cuda):
        x = torch.as_tensor(np.random.default_rng(f).normal(size=(stage.num_inputs, f))
                            .astype(np.float32), device=cuda)
        before = aligned_band.launches
        got = aligned_band.aligned_band(x, stage)
        again = aligned_band.aligned_band(x, stage)
        torch.cuda.synchronize()
        assert aligned_band.launches == before + 2  # one launch a stage apply
        want = aligned_band.aligned_band_plain(x, stage)
        assert got.shape == want.shape == (stage.num_segments, f)
        scale = float(want.abs().max()) if want.numel() else 0.0
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5 * scale)
        assert torch.equal(got, again), "two runs differ"


def test_band_kernel_reads_no_row_past_n(cuda):
    """x's rows are a view into a larger buffer full of NaN: rows past N and
    the spill zero row must never be read."""
    plan = dataclasses.replace(aligned_plan("past_n"), form="pallas_auto")
    for stage in plan.device(cuda):
        n, f = stage.num_inputs, 5
        buf = torch.full((n + 1000, f), float("nan"), device=cuda)
        buf[:n] = torch.as_tensor(np.random.default_rng(2).normal(size=(n, f))
                                  .astype(np.float32), device=cuda)
        got = aligned_band.aligned_band(buf[:n], stage)
        assert bool(torch.isfinite(got).all())
        want = aligned_band.aligned_band_plain(buf[:n].clone(), stage)
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5 * float(want.abs().max()))


def test_band_kernel_runs_on_two_streams_at_once(cuda):
    """A split group's halves meet through scratch and counters of their
    own call: launches over one table on two streams, queued without
    waiting for each other, each give the plain twin's result."""
    plan = dataclasses.replace(aligned_plan("wide"), form="pallas_auto")
    rng = np.random.default_rng(9)
    for stage in plan.device(cuda):
        assert stage.band.slots > 0
        xs = [torch.as_tensor(rng.normal(size=(stage.num_inputs, 32)).astype(np.float32),
                              device=cuda) for _ in range(2)]
        streams = [torch.cuda.Stream(cuda) for _ in range(2)]
        torch.cuda.synchronize()
        outs = ([], [])
        for _ in range(20):
            for s, x, got in zip(streams, xs, outs):
                with torch.cuda.stream(s):
                    got.append(aligned_band.aligned_band(x, stage))
        torch.cuda.synchronize()
        for x, got in zip(xs, outs):
            want = aligned_band.aligned_band_plain(x, stage)
            for g in got:
                torch.testing.assert_close(g, want, rtol=1e-5, atol=1e-5 * float(want.abs().max()))


@pytest.mark.parametrize("aggr", ["sum", "mean"])
def test_aligned_route_runs_the_kernel_forward_and_backward(cuda, aggr):
    """The route on the kernel form against the plain form on the card: the
    output and dx, with one launch per stage apply (2 forward, 2 backward)."""
    hg = sorted_community_graph(2000, 1600, 25, 5, 0.02, 3)
    plain = planner.plan_aligned(hg)
    kernel = dataclasses.replace(plain, form="pallas_auto")
    hgd = hg.device_data(cuda)
    rng = np.random.default_rng(4)
    x = torch.as_tensor(rng.normal(size=(hg.num_nodes, 16)).astype(np.float32), device=cuda)
    cot = torch.as_tensor(rng.normal(size=(hg.num_nodes, 16)).astype(np.float32), device=cuda)
    res = []
    for plan in (kernel, plain):
        xr = x.clone().requires_grad_(True)
        before = aligned_band.launches
        out = fused.hgnn_aggregate(hgd, xr, None, aggr, plan=plan, backend="aligned")
        (out * cot).sum().backward()
        torch.cuda.synchronize()
        res.append((out.detach(), xr.grad, aligned_band.launches - before))
    (out_k, dx_k, n_k), (out_p, dx_p, n_p) = res
    assert (n_k, n_p) == (4, 0)
    for got, want in ((out_k, out_p), (dx_k, dx_p)):
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5 * float(want.abs().max()))


def test_band_wrapper_rejects_what_the_kernel_does_not_take(cuda):
    kernel_stage, _ = dataclasses.replace(aligned_plan("bucketed"), form="pallas_auto").device(cuda)
    plain_stage, _ = aligned_plan("bucketed").device(cuda)
    n = kernel_stage.num_inputs
    x = torch.ones((n, 4), device=cuda)
    with pytest.raises(RuntimeError, match="autograd"):
        aligned_band.aligned_band(x.clone().requires_grad_(True), kernel_stage)
    with pytest.raises(TypeError):
        aligned_band.aligned_band(x.double(), kernel_stage)
    with pytest.raises(TypeError):
        aligned_band.aligned_band(x[:10], kernel_stage)
    with pytest.raises(ValueError, match="contiguous"):
        aligned_band.aligned_band(torch.ones((4, n), device=cuda).t(), kernel_stage)
    with pytest.raises(ValueError, match="kernel tables"):
        aligned_band.aligned_band(x, plain_stage)
    with pytest.raises(ValueError):
        aligned_band.aligned_band(x.cpu(), kernel_stage)


def _max_x(rows, f, seed, device):
    """Normal values, or integers in [-2, 2] (many ties) for even seeds."""
    rng = np.random.default_rng(seed)
    a = rng.integers(-2, 3, size=(rows, f)) if seed % 2 == 0 else rng.normal(size=(rows, f))
    return torch.as_tensor(a.astype(np.float32), device=device)


# the shapes the max kernels' live layout cuts differently: a group with no
# live slot, rows that reach sources only through spill slots, blocks of 200
# rows cut into chunks of 128 and 72 (a row's slots cross a chunk boundary),
# and bands so full that chunks are cut by their entries
MAX_CASES = ALIGNED_CASES + ("gap", "spill_only", "uniform_spill_only", "block200", "dense")
MAX_WIDTHS = (3, 4, 32, 48, 100)


def live_entries(table, live):
    """Every entry a LiveLayout lists, in its order: (segment, source, slot
    of the group, chunk, offset), int64 host arrays."""
    g_rows = table.group_rows
    c = live.chunks.cpu().numpy().astype(np.int64)
    gc = live.group_chunks.cpu().numpy().astype(np.int64)
    rp = live.row_ptr.cpu().numpy().astype(np.int64)[:len(c) * g_rows + 1]
    at = np.repeat(np.arange(len(c) * g_rows), np.diff(rp))  # (chunk, row) of each entry
    chunk, row = at // g_rows, at % g_rows
    group = np.repeat(np.arange(len(gc) - 1), np.diff(gc))[chunk]
    off = live.slots.cpu().numpy().astype(np.int64)[:rp[-1]]
    first, spill = c[chunk, 0], c[chunk, 2] == 1
    srcs = np.concatenate([table.src.cpu().numpy(), np.zeros(1, np.int32)])
    src = np.where(spill, srcs[np.where(spill, first + off, 0)], first + off)
    return group * g_rows + row, src, c[chunk, 3] + off, chunk, off


def _walk(table, live, step):
    """Call ``step(rows, sources)`` for the k-th entry of every row's list
    of each chunk, chunk by chunk, k ascending: the kernels' order."""
    seg, src, _, chunk, _ = live_entries(table, live)
    for i in np.unique(chunk):
        s, v = seg[chunk == i], src[chunk == i]
        k = np.arange(len(s)) - np.searchsorted(s, s)  # position in its row's list
        for at in range(int(k.max()) + 1):
            step(s[k == at], v[k == at])


def walk_argmax(x, table, live):
    """The argmax kernel's walk over ``live``, on the host: (val, arg)."""
    rows, f = table.num_groups * table.group_rows, x.shape[1]
    best = np.full((rows, f), np.float32(-3.0e38), np.float32)
    best_id = np.full((rows, f), 2**31 - 1, np.int64)

    def step(r, ids):
        xv = x[ids]
        win = (xv > best[r]) | ((xv == best[r]) & (ids[:, None] < best_id[r]))
        best[r] = np.where(win, xv, best[r])
        best_id[r] = np.where(win, ids[:, None], best_id[r])

    _walk(table, live, step)
    none = best_id == 2**31 - 1
    s = table.num_segments
    return (np.where(none, 0.0, best).astype(np.float32)[:s],
            np.where(none, -1, best_id).astype(np.int32)[:s])


def walk_argsum(g, arg, table, live):
    """The arg-sum kernel's walk over ``live``, on the host: each row's f32
    sum, from +0, in chunk and list order (slot order)."""
    out = np.zeros((table.num_groups * table.group_rows, g.shape[1]), np.float32)

    def step(r, e):
        out[r] = np.where(arg[e] == r[:, None], out[r] + g[e], out[r])

    _walk(table, live, step)
    return out[:table.num_segments]


@pytest.mark.parametrize("case", MAX_CASES)
@pytest.mark.parametrize("f,seed", [(3, 1), (4, 2), (32, 2), (32, 3), (48, 4), (100, 5)])
def test_argmax_kernel_is_bitwise_plain(cuda, case, f, seed):
    plan = dataclasses.replace(aligned_plan(case), form="pallas_auto")
    for stage in plan.device(cuda):
        x = _max_x(stage.num_inputs, f, seed, cuda)
        before = aligned_max.argmax_launches
        val, arg = aligned_max.aligned_masked_argmax(x, stage)
        val2, arg2 = aligned_max.aligned_masked_argmax(x, stage)
        torch.cuda.synchronize()
        assert aligned_max.argmax_launches == before + 2  # one launch a stage apply
        want_val, want_arg = aligned_max.aligned_max_plain(x, stage)
        assert val.shape == want_val.shape == (stage.num_segments, f)
        assert arg.dtype == torch.int32
        assert torch.equal(val, want_val), float((val - want_val).abs().max())
        assert torch.equal(arg, want_arg), int((arg != want_arg).sum())
        assert torch.equal(val, val2) and torch.equal(arg, arg2), "two runs differ"


@pytest.mark.parametrize("case", MAX_CASES)
@pytest.mark.parametrize("f", MAX_WIDTHS)
def test_argsum_kernel_matches_plain(cuda, case, f):
    """Over the vertex stage, with the arg table of the argmax kernel on the
    edge stage: within 1e-6 of the twin, and bitwise equal to the host walk
    over the live layout (every row summed in slot order, as the kernel
    over the flat tables summed it)."""
    e_st, v_st = dataclasses.replace(aligned_plan(case), form="pallas_auto").device(cuda)
    _, arg = aligned_max.aligned_masked_argmax(_max_x(e_st.num_inputs, f, 5, cuda), e_st)
    g = _max_x(v_st.num_inputs, f, 7, cuda)
    before = aligned_max.argsum_launches
    got = aligned_max.aligned_masked_argsum(g, arg, v_st)
    again = aligned_max.aligned_masked_argsum(g, arg, v_st)
    torch.cuda.synchronize()
    assert aligned_max.argsum_launches == before + 2
    want = aligned_max.aligned_argsum_plain(g, arg, v_st)
    assert got.shape == want.shape == (v_st.num_segments, f)
    scale = float(want.abs().max()) if want.numel() else 0.0
    torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6 * scale)
    assert torch.equal(got, again), "two runs differ"
    walked = walk_argsum(g.cpu().numpy(), arg.cpu().numpy(), v_st.band, v_st.band.live)
    assert torch.equal(got.cpu(), torch.as_tensor(walked))


def test_max_kernels_read_no_row_past_n(cuda):
    """x's (and g's and arg's) rows are a view into a larger buffer full of
    NaN (and of ids that would hit): rows past N and the spill zero row must
    never be read."""
    e_st, v_st = dataclasses.replace(aligned_plan("past_n"), form="pallas_auto").device(cuda)
    n, f = e_st.num_inputs, 5
    buf = torch.full((n + 1000, f), float("nan"), device=cuda)
    buf[:n] = _max_x(n, f, 3, cuda)
    val, arg = aligned_max.aligned_masked_argmax(buf[:n], e_st)
    assert bool(torch.isfinite(val).all())
    want_val, want_arg = aligned_max.aligned_max_plain(buf[:n].clone(), e_st)
    assert torch.equal(val, want_val) and torch.equal(arg, want_arg)
    m = v_st.num_inputs
    gbuf = torch.full((m + 1000, f), float("nan"), device=cuda)
    gbuf[:m] = _max_x(m, f, 5, cuda)
    abuf = torch.zeros((m + 1000, f), dtype=torch.int32, device=cuda)
    abuf[:m] = arg
    got = aligned_max.aligned_masked_argsum(gbuf[:m], abuf[:m], v_st)
    assert bool(torch.isfinite(got).all())
    want = aligned_max.aligned_argsum_plain(gbuf[:m].clone(), arg, v_st)
    torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6 * float(want.abs().max()))


def test_max_route_runs_the_kernels_forward_and_backward(cuda):
    """The aligned route with max on the kernel form against the plain form
    on the card: the output bitwise equal up to the band kernel's sums, dx
    (the CSR-routed backward) equal; one argmax and one band launch forward,
    one band launch backward."""
    hg = sorted_community_graph(2000, 1600, 25, 5, 0.02, 3)
    plain = planner.plan_aligned(hg)
    kernel = dataclasses.replace(plain, form="pallas_auto")
    hgd = hg.device_data(cuda)
    x = _max_x(hg.num_nodes, 16, 9, cuda)
    cot = _max_x(hg.num_nodes, 16, 11, cuda)
    res = []
    for plan in (kernel, plain):
        xr = x.clone().requires_grad_(True)
        before = (aligned_max.argmax_launches, aligned_band.launches)
        out = fused.hgnn_aggregate(hgd, xr, None, "max", plan=plan, backend="aligned")
        (out * cot).sum().backward()
        torch.cuda.synchronize()
        res.append((out.detach(), xr.grad, (aligned_max.argmax_launches - before[0],
                                            aligned_band.launches - before[1])))
    (out_k, dx_k, n_k), (out_p, dx_p, n_p) = res
    assert (n_k, n_p) == ((1, 2), (0, 0))
    for got, want in ((out_k, out_p), (dx_k, dx_p)):
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5 * float(want.abs().max()))


def test_segment_sum_sorted_is_deterministic_on_the_card(cuda):
    """The max backward's direct segment sum at SBM-60k's nnz and F = 32:
    two runs bitwise equal, and within 1e-5 of float64 sums on the host."""
    from hypergef_tpu_torch.ops.segments import segment_sum_sorted

    rng = np.random.default_rng(0)
    nnz, segs = 351737, 60000
    indptr = np.concatenate([[0], np.sort(rng.integers(0, nnz + 1, size=segs - 1)), [nnz]])
    vals = rng.normal(size=(nnz, 32)).astype(np.float32)
    v, ip = torch.as_tensor(vals, device=cuda), torch.as_tensor(indptr, device=cuda)
    got, again = segment_sum_sorted(v, ip), segment_sum_sorted(v, ip)
    assert torch.equal(got, again), "two runs differ"
    prefix = np.concatenate([np.zeros((1, 32)), np.cumsum(vals, axis=0, dtype=np.float64)])
    want = prefix[indptr[1:]] - prefix[indptr[:-1]]  # float64: exact enough here
    np.testing.assert_allclose(got.cpu().numpy(), want, rtol=1e-5, atol=1e-5)


def test_max_wrappers_reject_what_the_kernels_do_not_take(cuda):
    plan = dataclasses.replace(aligned_plan("uniform"), form="pallas_auto")
    e_st, v_st = plan.device(cuda)
    e_cpu, _ = plan.device("cpu")
    e_plain, v_plain = aligned_plan("uniform").device(cuda)
    x = torch.ones((e_st.num_inputs, 4), device=cuda)
    with pytest.raises(ValueError, match="table is on"):
        aligned_max.aligned_masked_argmax(x, e_cpu)
    with pytest.raises(TypeError):
        aligned_max.aligned_masked_argmax(x.double(), e_st)
    with pytest.raises(TypeError):
        aligned_max.aligned_masked_argmax(x[:10], e_st)
    with pytest.raises(ValueError, match="contiguous"):
        aligned_max.aligned_masked_argmax(torch.ones((4, e_st.num_inputs), device=cuda).t(), e_st)
    with pytest.raises(ValueError, match="kernel tables"):
        aligned_max.aligned_masked_argmax(x, e_plain)
    _, arg = aligned_max.aligned_masked_argmax(x, e_st)
    g = torch.ones((v_st.num_inputs, 4), device=cuda)
    with pytest.raises(TypeError):
        aligned_max.aligned_masked_argsum(g, arg.long(), v_st)
    with pytest.raises(TypeError):
        aligned_max.aligned_masked_argsum(g.double(), arg, v_st)
    with pytest.raises(ValueError, match="kernel tables"):
        aligned_max.aligned_masked_argsum(g, arg, v_plain)
    # a kernel-form stage whose table lost its live layout: no fallback
    for fn, st, args in ((aligned_max.aligned_masked_argmax, e_st, (x,)),
                         (aligned_max.aligned_masked_argsum, v_st, (g, arg))):
        bare = dataclasses.replace(st, band=dataclasses.replace(st.band, live=None))
        with pytest.raises(ValueError, match="BandTable.build"):
            fn(*args, bare)


def _bit_pack(m, k, density, seed, device):
    """The device pack (words and the kernel's layout) of a random 0/1
    matrix [m, k] with every third row empty and row 1 full, padded to 256
    rows as BitIncidence pads them; and the matrix."""
    rng = np.random.default_rng(seed)
    a = (rng.random((m, k)) < density).astype(np.float32)
    a[::3] = 0
    if m > 1:
        a[1] = 1
    return _pack_of(a, device), a


def _pack_of(a, device):
    import scipy.sparse as sp

    m, k = a.shape
    csr = sp.csr_matrix(a)
    words = bitstream.pack_bits_csr(csr.indptr, csr.indices, m, k)
    return bitstream.BitPack(np.pad(words, ((0, -m % 256), (0, 0))), m, k).to(device)


def _edge_matrix(case):
    """0/1 matrices of the layout's edge cases (as
    tests/test_torch_port_bitstream.py builds them)."""
    rng = np.random.default_rng(7)
    if case == "all_zero":
        return np.zeros((40, 5000), np.float32)
    a = np.zeros((9, 3 * 4096 + 50), np.float32)
    if case == "full_word":
        a[2, 7::128] = 1  # word 7 of row 2: its 32 bits
        a[5, 7:4096:128] = 1
    elif case == "every_word":
        a[1, :] = 1
        a[4, ::130] = 1
    elif case == "around_the_share":  # rows of 0 .. the largest share + 1 bits
        a = np.zeros((110, 700), np.float32)
        for r in range(110):
            a[r, rng.choice(700, size=r % (max(bitstream.RUN_SHARES) + 2), replace=False)] = 1
    return a


def _check_bitmm(pack, a, f, device):
    x = torch.as_tensor(np.random.default_rng(f).normal(size=(pack.k, f)).astype(np.float32),
                        device=device)
    before = bitstream.launches
    got = bitstream.bitmm(pack, x)
    again = bitstream.bitmm(pack, x)
    torch.cuda.synchronize()
    assert bitstream.launches == before + 2
    want = bitstream.bitmm_plain(pack.words, x, pack.m, pack.k)
    assert got.shape == want.shape == (pack.m, f)
    scale = max(float(want.abs().max()), 1e-30)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5 * scale)
    assert torch.equal(got, again), "two runs differ"
    assert not got[torch.as_tensor(a.sum(1) == 0, device=device)].any()  # empty rows
    exact = torch.as_tensor(a, device=device).double() @ bitstream.bf16_round(x).double()
    torch.testing.assert_close(got.double(), exact, rtol=1e-5,
                               atol=1e-5 * max(float(exact.abs().max()), 1e-30))


# m not a multiple of the kernel's 8 runs a CTA (1, 133, 257, 300, 4100);
# k = 140000: rows of 35 K tiles, so a row's words span many windows of 32
# pairs; row 1 full: every word of every tile set, its bits staged 64 at a
# time
@pytest.mark.parametrize("m,k,density", [(1, 1, 1.0), (300, 5000, 0.01), (257, 4096, 0.05),
                                         (1000, 9000, 0.002), (4100, 700, 0.03),
                                         (133, 140000, 0.0005)])
@pytest.mark.parametrize("f", [1, 3, 4, 32, 100, 300])
def test_bitmm_kernel_matches_plain(cuda, m, k, density, f):
    pack, a = _bit_pack(m, k, density, seed=m + k + f, device=cuda)
    _check_bitmm(pack, a, f, cuda)


@pytest.mark.parametrize("case", ["all_zero", "full_word", "every_word", "around_the_share"])
@pytest.mark.parametrize("f", [1, 3, 4, 32, 100, 300])
@pytest.mark.parametrize("largest_share", [False, True])
def test_bitmm_kernel_matches_plain_on_the_layouts_edge_cases(cuda, case, f, largest_share):
    """The card's own share (the smallest, at these sizes) and the largest,
    the one stream100k's packs take."""
    a = _edge_matrix(case)
    pack = _pack_of(a, cuda)
    if largest_share:
        lay = bitstream.bit_layout(pack.words.cpu().numpy(), pack.m, pack.k, sms=0)
        assert lay.share == max(bitstream.RUN_SHARES)
        pack = dataclasses.replace(pack, layout=lay.to(cuda))
    _check_bitmm(pack, a, f, cuda)


def test_bitmm_kernel_runs_on_two_streams_at_once(cuda):
    """Both packs of a graph queued on two streams without waiting for each
    other: each gives its twin's result."""
    from hypergef_tpu_torch.data.synthetic import random_hypergraph

    hg = random_hypergraph(5000, 4500, avg_edge_size=6.0, seed=3)
    packs = bitstream.BitIncidence.from_hypergraph(hg).device(cuda)
    rng = np.random.default_rng(5)
    xs = [torch.as_tensor(rng.normal(size=(p.k, 32)).astype(np.float32), device=cuda)
          for p in packs]
    streams = [torch.cuda.Stream(cuda) for _ in range(2)]
    torch.cuda.synchronize()
    outs = ([], [])
    for _ in range(20):
        for st, p, x, got in zip(streams, packs, xs, outs):
            with torch.cuda.stream(st):
                got.append(bitstream.bitmm(p, x))
    torch.cuda.synchronize()
    for p, x, got in zip(packs, xs, outs):
        want = bitstream.bitmm_plain(p.words, x, p.m, p.k)
        for o in got:
            assert torch.equal(o, got[0])
        torch.testing.assert_close(got[0], want, rtol=1e-5, atol=1e-5 * float(want.abs().max()))


def test_bit_matvec_gradient_matches_the_twin(cuda):
    from hypergef_tpu_torch.data.synthetic import random_hypergraph

    hg = random_hypergraph(5000, 4500, avg_edge_size=6.0, seed=2)
    h, ht = bitstream.BitIncidence.from_hypergraph(hg).device(cuda)
    rng = np.random.default_rng(4)
    x = torch.as_tensor(rng.normal(size=(hg.num_nodes, 20)).astype(np.float32), device=cuda)
    g = torch.as_tensor(rng.normal(size=(hg.num_edges, 20)).astype(np.float32), device=cuda)
    xr = x.clone().requires_grad_(True)
    before = bitstream.launches
    out = bitstream.bit_matvec(xr, ht, h)
    out.backward(g)
    torch.cuda.synchronize()
    assert bitstream.launches == before + 2  # one forward, one backward
    for got, want in ((out.detach(), bitstream.bitmm_plain(ht.words, x, ht.m, ht.k)),
                      (xr.grad, bitstream.bitmm_plain(h.words, g, h.m, h.k))):
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5 * float(want.abs().max()))


def test_bitmm_wrapper_rejects_what_the_kernel_does_not_take(cuda):
    pack, _ = _bit_pack(300, 5000, 0.01, seed=1, device=cuda)
    x = torch.ones((5000, 4), device=cuda)
    with pytest.raises(ValueError, match="on the CPU"):
        bitstream.bitmm(pack, x.cpu())
    with pytest.raises(ValueError, match="pack is on"):
        bitstream.bitmm(dataclasses.replace(pack, words=pack.words.cpu()), x)
    with pytest.raises(TypeError):
        bitstream.bitmm(pack, x.double())
    with pytest.raises(TypeError):
        bitstream.bitmm(pack, x[:10])
    with pytest.raises(TypeError):
        bitstream.bitmm(dataclasses.replace(pack, words=pack.words.long()), x)
    with pytest.raises(ValueError, match="contiguous"):
        bitstream.bitmm(pack, torch.ones((4, 5000), device=cuda).t())
    with pytest.raises(ValueError, match="contiguous"):
        bitstream.bitmm(dataclasses.replace(pack, words=pack.words[:, :128], k=4096), x[:4096])
    with pytest.raises(ValueError, match="unsupported pack"):
        bitstream.bitmm(dataclasses.replace(pack, k=9000), torch.ones((9000, 4), device=cuda))
    with pytest.raises(RuntimeError, match="bit_matvec"):
        bitstream.bitmm(pack, x.clone().requires_grad_(True))
    # a device pack without the kernel's layout is refused, never summed by the twin
    with pytest.raises(ValueError, match="BitIncidence.device"):
        bitstream.bitmm(dataclasses.replace(pack, layout=None), x)


def test_chip_smoke_imports_and_reads_the_card():
    """Imported everywhere, so its helpers are import-checked on the CPU
    too; the card-reading part skips without a card."""
    spec = importlib.util.spec_from_file_location("chip_smoke", REPO / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    assert callable(mod.main) and set(mod.GRAPHS) == {"20news", "pubmed_real"}
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    assert mod.card_line().split(",")[0].strip() == torch.cuda.get_device_name(0)


# ---- the segment-sum kernel (cumsum route), precomp, the ladder ----------


def _segment_csr(s, n, density, seed, identity=False):
    """A CSR of ``s`` segments over rows of an [n, F] input, with every
    fourth segment empty and one long one."""
    rng = np.random.default_rng(seed)
    sizes = rng.poisson(density, size=s)
    sizes[::4] = 0
    if s > 2:
        sizes[1] = 700
    indptr = np.concatenate([[0], np.cumsum(sizes)])
    if identity:
        indptr = np.minimum(indptr, n)
        return indptr, None
    return indptr, rng.integers(0, n, size=int(indptr[-1])).astype(np.int32)


@pytest.mark.parametrize("s,n,density", [(1, 5, 3.0), (300, 500, 6.0), (4100, 2000, 2.5)])
@pytest.mark.parametrize("f", [1, 3, 4, 32, 33, 100])
@pytest.mark.parametrize("identity", [False, True])
def test_segment_sum_kernel_matches_plain(cuda, s, n, density, f, identity):
    """rtol 1e-6, atol 1e-6·max|plain|: the same f32 terms, summed in CSR
    order by the kernel and by segment_reduce's own order."""
    from hypergef_tpu_torch.ops import segment_sum

    indptr, gather = _segment_csr(s, n if not identity else 10**6, density, s + f, identity)
    rows = max(n, int(indptr[-1])) if identity else n
    table = segment_sum.SegmentTable.build(indptr, gather, rows, cuda)
    x = torch.as_tensor(np.random.default_rng(f).normal(size=(rows, f)).astype(np.float32),
                        device=cuda)
    before = segment_sum.launches
    got = segment_sum.gather_segment_sum(x, table)
    again = segment_sum.gather_segment_sum(x, table)
    torch.cuda.synchronize()
    assert segment_sum.launches == before + 2
    want = segment_sum.gather_segment_sum_plain(x, table)
    assert got.shape == want.shape == (s, f)
    torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6 * float(want.abs().max()))
    assert torch.equal(got, again), "two runs differ"
    empty = torch.as_tensor(np.diff(indptr) == 0, device=cuda)
    assert not got[empty].any()


def _long_csr(seed):
    """Segments over 7000 rows: every third one empty, a 12,000-row one."""
    rng = np.random.default_rng(seed)
    sizes = rng.poisson(3.0, size=3000)
    sizes[::3] = 0
    sizes[5] = 12_000
    indptr = np.concatenate([[0], np.cumsum(sizes)])
    return indptr, rng.integers(0, 7000, size=int(indptr[-1])).astype(np.int32)


@pytest.mark.parametrize("f", [1, 3, 4, 6, 32, 100, 1425])
@pytest.mark.parametrize("aligned", [True, False])
def test_segment_sum_kernel_on_a_long_segment_and_unaligned_rows(cuda, f, aligned):
    """The warp runs' two modes (several segments a warp's lane groups; one
    long segment a column a lane), on rows read 16 (or at F = 6, 8) bytes a
    lane and, from an x 4 bytes past a 16-byte boundary, one float a lane:
    rtol 1e-6 and atol 1e-6·max|plain|, repeats bitwise equal, one launch a
    call."""
    from hypergef_tpu_torch.ops import segment_sum

    indptr, gather = _long_csr(f)
    table = segment_sum.SegmentTable.build(indptr, gather, 7000, cuda)
    vals = torch.as_tensor(np.random.default_rng(f).normal(size=(7000, f)).astype(np.float32),
                           device=cuda)
    buf = torch.empty(7000 * f + 1, device=cuda)
    x = buf[1:].view(7000, f) if not aligned else buf[:-1].view(7000, f)
    x.copy_(vals)
    assert (x.data_ptr() % 16 == 0) == aligned
    before = segment_sum.launches
    got = segment_sum.gather_segment_sum(x, table)
    again = segment_sum.gather_segment_sum(x, table)
    torch.cuda.synchronize()
    assert segment_sum.launches == before + 2
    want = segment_sum.gather_segment_sum_plain(vals, table)
    torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6 * float(want.abs().max()))
    assert torch.equal(got, again), "two runs differ"
    assert not got[torch.as_tensor(np.diff(indptr) == 0, device=cuda)].any()


def _tree_record(cuda, seed, f):
    """(g, arg int32, record) of a max V→E through the tree on a random graph,
    tie-heavy (integers in [-2, 2]) so that ids of several members tie."""
    from hypergef_tpu_torch.data.synthetic import random_hypergraph
    from hypergef_tpu_torch.ops import maxops

    hg = random_hypergraph(3000, 1700, avg_edge_size=6.0, seed=seed)
    stage = planner.plan_tree(hg).device(cuda)[0]
    rng = np.random.default_rng(seed)
    x = torch.as_tensor(rng.integers(-2, 3, size=(hg.num_nodes, f)).astype(np.float32),
                        device=cuda)
    g = torch.as_tensor(rng.normal(size=(hg.num_edges, f)).astype(np.float32), device=cuda)
    _, arg = maxops.tree_max_with_arg(x, stage)
    return g, arg, hg.device_data(cuda).record


@pytest.mark.parametrize("ids", ["tree", "int64"])
@pytest.mark.parametrize("f", [32, 6, 3])
def test_record_routed_sum_matches_plain(cuda, ids, f):
    """The kernel on the tree's int32 record table and on its int64 copy:
    bitwise equal to the sequential CSR-order sum, rtol 1e-6 and atol
    1e-6·max|plain| of the plain twin, repeats bitwise equal, one record
    launch a call and no plain-sum launch."""
    from hypergef_tpu_torch.ops import segment_sum

    g, arg, record = _tree_record(cuda, 7 + f, f)
    assert arg.dtype == torch.int32
    if ids == "int64":
        arg = arg.to(torch.int64)
    before = (segment_sum.launches, segment_sum.record_launches)
    got = segment_sum.record_routed_dx(g, arg, record)
    again = segment_sum.record_routed_dx(g, arg, record)
    torch.cuda.synchronize()
    assert (segment_sum.launches, segment_sum.record_launches) == (before[0], before[1] + 2)
    want = segment_sum.record_routed_dx_plain(g, arg, record)
    assert bool((want != 0).any())
    torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6 * float(want.abs().max()))
    assert torch.equal(got, again), "two runs differ"
    seq = segment_sum.record_routed_dx_sequential(g, arg, record)
    assert torch.equal(got.view(torch.int32), seq.view(torch.int32))


def _record_graph(name):
    """Graphs of the layout's edge cases: duplicate members
    (``from_coo(dedup=False)``), empty edges and isolated vertices, long
    edges among short ones, and one edge holding every vertex."""
    rng = np.random.default_rng(len(name))
    if name == "duplicates":
        v, e = rng.integers(0, 400, size=3000), rng.integers(0, 250, size=3000)
        v, e = np.concatenate([v, v[:600], v[:150]]), np.concatenate([e, e[:600], e[:150]])
        return Hypergraph.from_coo(v, e, 400, 250, dedup=False)
    if name == "empty_edges":
        v = rng.integers(0, 600, size=1500)
        e = rng.choice(np.arange(0, 900, 3), size=1500)
        return Hypergraph.from_coo(v, e, 700, 900)
    if name == "long_edges":
        sizes = np.concatenate([[150, 64, 65, 129, 2000], rng.integers(1, 40, size=300)])
        e = np.repeat(np.arange(sizes.size), sizes)
        v = np.concatenate([rng.permutation(3000)[:k] for k in sizes])
        return Hypergraph.from_coo(v, e, 3000, sizes.size)
    return Hypergraph.from_coo(np.arange(500), np.zeros(500, np.int64), 500, 1)  # one edge


@pytest.mark.parametrize("graph", ["duplicates", "empty_edges", "long_edges", "one_edge"])
@pytest.mark.parametrize("f", [1, 3, 4, 32, 33, 64])
@pytest.mark.parametrize("ids", ["int32", "int64"])
def test_record_routed_sum_is_the_sequential_sum_bitwise(cuda, graph, f, ids):
    """Ids a member of their edge, of no member or -1; NaN in every other
    edge's values that no member wins (never added): the kernel bitwise
    equal to the sequential CSR-order sum and finite, repeats bitwise
    equal, one launch a call."""
    from hypergef_tpu_torch.ops import segment_sum

    hg = _record_graph(graph)
    hgd = hg.device_data(cuda)
    record = hgd.record
    rng = np.random.default_rng(f)
    size = np.diff(hg.ht_indptr)
    pick = hg.ht_indptr[:-1, None] + (rng.random((hg.num_edges, f)) * size[:, None]).astype(int)
    arg = np.where(size[:, None] > 0, hg.ht_indices[np.minimum(pick, hg.nnz - 1)], -1)
    draw = rng.random(arg.shape)
    arg = np.where(draw < 0.1, rng.integers(0, hg.num_nodes, size=arg.shape), arg)
    arg = np.where(draw > 0.95, -1, arg)
    edge = np.repeat(np.arange(hg.num_edges), size)
    won = np.zeros(arg.shape, dtype=bool)
    np.logical_or.at(won, edge, arg[edge] == hg.ht_indices[:, None])
    g = rng.normal(size=arg.shape).astype(np.float32)
    g[~won & (np.arange(hg.num_edges)[:, None] % 2 == 0)] = np.nan
    g = torch.as_tensor(g, device=cuda)
    arg = torch.as_tensor(arg, dtype=getattr(torch, ids), device=cuda)
    before = segment_sum.record_launches
    got = segment_sum.record_routed_dx(g, arg, record)
    again = segment_sum.record_routed_dx(g, arg, record)
    torch.cuda.synchronize()
    assert segment_sum.record_launches == before + 2
    want = segment_sum.record_routed_dx_sequential(g, arg, record)
    assert bool(torch.isfinite(got).all())
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    assert torch.equal(got.view(torch.int32), again.view(torch.int32)), "two runs differ"


def test_record_layout_on_the_card_is_the_host_layout(cuda):
    from hypergef_tpu_torch.ops import segment_sum

    hg = _record_graph("duplicates")
    lay = hg.device_data(cuda).record.layout
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    share = segment_sum.record_run_share(hg.nnz + hg.num_nodes, sms)
    edge, members, perm = segment_sum.record_layout(hg.h_indptr, hg.h_indices)
    host = (edge, members, np.argsort(perm), segment_sum.warp_runs(hg.h_indptr, share))
    for got, want in zip((lay.edge, lay.members, lay.slot, lay.runs), host):
        assert got.dtype == torch.int32 and got.device.type == "cuda"
        np.testing.assert_array_equal(got.cpu().numpy(), want)
    assert lay.nbytes == 12 * hg.nnz + 4 * lay.runs.numel()
    assert lay.build_s > 0


def test_segment_sum_kernels_run_on_two_streams_at_once(cuda):
    """The sum and the record-routed sum over one table, queued on two
    streams without waiting for each other: each gives its plain twin's
    result."""
    from hypergef_tpu_torch.ops import segment_sum

    g, arg, record = _tree_record(cuda, 3, 32)
    streams = [torch.cuda.Stream(cuda) for _ in range(2)]
    calls = [lambda: segment_sum.gather_segment_sum(g, record.e2v),
             lambda: segment_sum.record_routed_dx(g, arg, record)]
    torch.cuda.synchronize()
    outs = ([], [])
    for _ in range(20):
        for st, call, got in zip(streams, calls, outs):
            with torch.cuda.stream(st):
                got.append(call())
    torch.cuda.synchronize()
    wants = (segment_sum.gather_segment_sum_plain(g, record.e2v),
             segment_sum.record_routed_dx_plain(g, arg, record))
    for got, want in zip(outs, wants):
        for o in got:
            torch.testing.assert_close(o, want, rtol=1e-6, atol=1e-6 * float(want.abs().max()))


def test_record_routed_sum_rejects_what_the_kernel_does_not_take(cuda):
    from hypergef_tpu_torch.ops import segment_sum

    g, arg, record = _tree_record(cuda, 5, 4)
    with pytest.raises(TypeError, match="int32 or int64"):
        segment_sum.record_routed_dx(g, arg.float(), record)
    with pytest.raises(TypeError, match="int32 or int64"):
        segment_sum.record_routed_dx(g, arg[:, :2].contiguous(), record)
    with pytest.raises(ValueError, match="contiguous"):
        segment_sum.record_routed_dx(g, arg.t().contiguous().t(), record)
    with pytest.raises(TypeError, match="f32"):
        segment_sum.record_routed_dx(g.double(), arg, record)
    with pytest.raises(ValueError, match="no kernel layout"):
        segment_sum.record_routed_dx(g, arg, segment_sum.RecordTable(record.e2v))
    on_cpu = segment_sum.RecordTable.over(segment_sum.SegmentTable.build(
        record.e2v.indptr_long.cpu(), record.e2v.gather_long.cpu(), g.shape[0], "cpu"))
    with pytest.raises(ValueError, match="table is on"):
        segment_sum.record_routed_dx(g, arg, on_cpu)


def test_incidence_gather_sum_backward_is_the_transposed_csr(cuda):
    from hypergef_tpu_torch.data.synthetic import random_hypergraph
    from hypergef_tpu_torch.ops import segment_sum
    from hypergef_tpu_torch.ops.segments import incidence_gather_sum

    hg = random_hypergraph(3000, 1700, avg_edge_size=4.5, seed=3)
    hgd = hg.device_data(cuda)
    rng = np.random.default_rng(5)
    x = torch.as_tensor(rng.normal(size=(hg.num_nodes, 32)).astype(np.float32), device=cuda)
    g = torch.as_tensor(rng.normal(size=(hg.num_edges, 32)).astype(np.float32), device=cuda)
    xr = x.clone().requires_grad_(True)
    before = segment_sum.launches
    y = incidence_gather_sum(xr, hgd.v2e, hgd.e2v)
    y.backward(g)
    torch.cuda.synchronize()
    assert segment_sum.launches == before + 2  # one forward, one backward
    for got, want in ((y.detach(), segment_sum.gather_segment_sum_plain(x, hgd.v2e)),
                      (xr.grad, segment_sum.gather_segment_sum_plain(g, hgd.e2v))):
        torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6 * float(want.abs().max()))


@pytest.mark.parametrize("aggr", ["sum", "mean", "max"])
def test_cumsum_route_runs_the_kernel_forward_and_backward(cuda, aggr):
    """Sum and mean launch the kernel twice forward and twice backward;
    max takes V→E from the tree and launches it once each way."""
    from hypergef_tpu_torch.data.synthetic import random_hypergraph
    from hypergef_tpu_torch.ops import segment_sum

    hg = random_hypergraph(2000, 1500, avg_edge_size=4.0, seed=4)
    plan = planner.AggregationPlan(tree=planner.plan_tree(hg)) if aggr == "max" else None
    rng = np.random.default_rng(6)
    x = rng.normal(size=(hg.num_nodes, 16)).astype(np.float32)
    outs, grads = [], []
    for dev in (cuda, torch.device("cpu")):
        xt = torch.as_tensor(x, device=dev).requires_grad_(True)
        before = segment_sum.launches
        out = fused.hgnn_aggregate(hg.device_data(dev), xt, None, aggr, plan=plan,
                                   backend="cumsum")
        (out ** 2).sum().backward()
        if dev.type == "cuda":
            torch.cuda.synchronize()
            assert segment_sum.launches - before == (2 if aggr == "max" else 4)
        outs.append(out.detach().cpu())
        grads.append(xt.grad.cpu())
    torch.testing.assert_close(outs[0], outs[1], rtol=1e-5, atol=1e-5 * float(outs[1].abs().max()))
    torch.testing.assert_close(grads[0], grads[1], rtol=1e-5,
                               atol=1e-5 * float(grads[1].abs().max()))


def test_segment_sum_wrapper_rejects_what_the_kernel_does_not_take(cuda):
    from hypergef_tpu_torch.ops import segment_sum

    indptr, gather = _segment_csr(50, 80, 3.0, 1)
    table = segment_sum.SegmentTable.build(indptr, gather, 80, cuda)
    cpu_table = segment_sum.SegmentTable.build(indptr, gather, 80, "cpu")
    x = torch.ones((80, 4), device=cuda)
    with pytest.raises(ValueError, match="table is on"):
        segment_sum.gather_segment_sum(x, cpu_table)
    with pytest.raises(TypeError):
        segment_sum.gather_segment_sum(x.double(), table)
    with pytest.raises(TypeError):
        segment_sum.gather_segment_sum(x[:10], table)
    with pytest.raises(ValueError, match="contiguous"):
        segment_sum.gather_segment_sum(torch.ones((4, 80), device=cuda).t(), table)
    with pytest.raises(RuntimeError, match="incidence_gather_sum"):
        segment_sum.gather_segment_sum(x.requires_grad_(True), table)
    with pytest.raises(ValueError, match=r"\[0, 80\)"):
        segment_sum.SegmentTable.build(indptr, gather + 80, 80, cuda)


def test_precomp_product_on_the_card_is_unrounded_f32(cuda):
    """A·bf16(x) with an f32 result: within 1e-5 of the float64 product of
    the same bf16 values (not rounded to bf16), and its gradient within the
    same of bf16(Aᵀ·bf16(g))."""
    from hypergef_tpu_torch.data.synthetic import random_hypergraph
    from hypergef_tpu_torch.ops.fused_dense import bf16_round

    hg = random_hypergraph(2708, 2708, avg_edge_size=4.0, seed=0)
    pre = planner.DensePrecomp.from_hypergraph(hg, cuda)
    rng = np.random.default_rng(7)
    x = torch.as_tensor(rng.normal(size=(hg.num_nodes, 32)).astype(np.float32), device=cuda)
    g = torch.as_tensor(rng.normal(size=(hg.num_nodes, 32)).astype(np.float32), device=cuda)
    xr = x.clone().requires_grad_(True)
    y = fused.precomp_matvec(pre.a, xr)
    y.backward(g)
    a = pre.a.double()
    want = a @ bf16_round(x).double()
    assert y.dtype == torch.float32
    torch.testing.assert_close(y.double(), want, rtol=1e-5, atol=1e-5 * float(want.abs().max()))
    assert not torch.equal(y, bf16_round(y))  # not rounded to bf16
    want_dx = bf16_round((a.t() @ bf16_round(g).double()).float())
    torch.testing.assert_close(xr.grad, want_dx, rtol=1e-2, atol=1e-2 * float(want_dx.abs().max()))


def test_plan_aggregation_takes_the_aligned_kernel_form_on_the_card(cuda):
    """Past the dense and precomp gates (closed here: the graph is small) a
    community-sorted graph takes ``aligned``, in the kernel form on the card."""
    hg, _ = community_reorder(community_hypergraph(2000, 1600, 25, 5, 0.02, 3))
    gates = dict(dense_threshold=0, with_precomp=False)
    plan = planner.plan_aggregation(hg, cuda, **gates)
    assert plan.preferred_backend == "aligned" and plan.aligned.form == "pallas_auto"
    assert plan.tree.form == "xla"
    assert planner.plan_aggregation(hg, "cpu", **gates).aligned.form == "xla"
    before = aligned_band.launches
    x = torch.ones((hg.num_nodes, 8), device=cuda)
    fused.hgnn_aggregate(hg.device_data(cuda), x, plan=plan, backend="auto")
    torch.cuda.synchronize()
    assert aligned_band.launches == before + 2


# ---- the probe kernels ----------------------------------------------------


@pytest.mark.parametrize("f", [1, 4, 32, 64, 128, 132])
@pytest.mark.parametrize("n_buf", [0, 4, 8, 16])
# 5001 rows; one row; fewer rows than a ring tile (n_buf / 4 rows) or a
# warp's least range (8); a range that is no multiple of a tile; and more
# rows than one wave of warps at the least range, so each warp takes 9
@pytest.mark.parametrize("r", [5001, 1, 3, 6, 13, 132 * 32 * 8 + 5])
def test_row_gather_kernel_is_bitwise_plain(cuda, f, n_buf, r):
    """Repeated indices (R draws from 3000 rows), one launch a call, two
    runs bitwise equal."""
    from hypergef_tpu_torch import probes

    if n_buf and f % 4:
        pytest.skip("the ring takes F % 4 == 0")
    rng = np.random.default_rng(f + n_buf)
    x = torch.as_tensor(rng.normal(size=(3000, f)).astype(np.float32), device=cuda)
    idx = torch.as_tensor(rng.integers(0, 3000, size=r).astype(np.int32), device=cuda)
    before = probes.row_gather_launches
    got = probes.row_gather(x, idx, n_buf)
    again = probes.row_gather(x, idx, n_buf)
    torch.cuda.synchronize()
    assert probes.row_gather_launches == before + 2
    assert torch.equal(got, probes.row_gather_plain(x, idx))
    assert torch.equal(again, got)


@pytest.mark.parametrize("f", [4, 32, 128])
def test_row_gather_of_an_offset_x(cuda, f):
    """x one float past a 16-byte boundary: the direct form gathers it by
    floats, bitwise; the ring, which copies 16-byte pieces, raises."""
    from hypergef_tpu_torch import probes

    rng = np.random.default_rng(f)
    x = torch.empty(700 * f + 1, device=cuda)[1:].view(700, f)
    x.copy_(torch.as_tensor(rng.normal(size=(700, f)).astype(np.float32)))
    assert x.data_ptr() % 16 == 4 and x.is_contiguous()
    idx = torch.as_tensor(rng.integers(0, 700, size=1001).astype(np.int32), device=cuda)
    before = probes.row_gather_launches
    got = probes.row_gather(x, idx)
    torch.cuda.synchronize()
    assert probes.row_gather_launches == before + 1
    assert torch.equal(got, probes.row_gather_plain(x, idx))
    for nb in probes.RING_DEPTHS:
        with pytest.raises(ValueError, match="16-byte"):
            probes.row_gather(x, idx, nb)
    assert probes.row_gather_launches == before + 1


@pytest.mark.parametrize("ngs,f", [(2, 3), (8, 32), (8, 128), (5, 33)])
def test_chunk_masked_sum_kernels_are_bitwise_plain(cuda, ngs, f):
    from hypergef_tpu_torch import probes

    rng = np.random.default_rng(ngs * f)
    c, n = 1234, 900
    g = torch.as_tensor(rng.normal(size=(c, ngs, f)).astype(np.float32), device=cuda)
    mask = torch.as_tensor((rng.random((c, ngs)) > 0.2).astype(np.float32), device=cuda)
    before = probes.chunk_sum_launches
    assert torch.equal(probes.chunk_masked_sum(g, mask), probes.chunk_masked_sum_plain(g, mask))
    if f % 4 == 0:
        x = torch.as_tensor(rng.normal(size=(n, f)).astype(np.float32), device=cuda)
        gidx = torch.as_tensor(rng.integers(0, n, size=(c, ngs)).astype(np.int32), device=cuda)
        want = ell_gather.ell_gather_sum_plain(x, gidx.long(), mask)
        for nb in probes.RING_DEPTHS:
            assert torch.equal(probes.chunk_masked_sum_ring(x, gidx, mask, nb), want)
    torch.cuda.synchronize()
    assert probes.chunk_sum_launches == before + 1 + (3 if f % 4 == 0 else 0)


@pytest.mark.parametrize("n_buf", [4, 8, 16])
@pytest.mark.parametrize("ngs,f", [(1, 4), (2, 128), (5, 32), (8, 32), (16, 4), (64, 128),
                                   (8, 64)])
def test_chunk_ring_is_bitwise_plain(cuda, ngs, f, n_buf):
    """The ring at every depth on 3001 chunks (a multiple of no block's or
    consumer's share), with dead slots naming an Inf row; one launch a call,
    two runs bitwise equal."""
    from hypergef_tpu_torch import probes

    x, gidx, mask = _dead_inf_operands(900, 3001, ngs, f, seed=ngs * f + n_buf, device=cuda)
    before = probes.chunk_sum_launches
    got = probes.chunk_masked_sum_ring(x, gidx, mask, n_buf)
    again = probes.chunk_masked_sum_ring(x, gidx, mask, n_buf)
    torch.cuda.synchronize()
    assert probes.chunk_sum_launches == before + 2
    want = ell_gather.ell_gather_sum_plain(x, gidx.long(), mask)
    assert bool(torch.isnan(want).any())
    _assert_bitwise_with_nans(got, want)
    _assert_bitwise_with_nans(again, got)


@pytest.mark.parametrize("n_buf", [4, 8, 16])
@pytest.mark.parametrize("c", [1, 7, 131])
def test_chunk_ring_with_fewer_chunks_than_the_grid(cuda, c, n_buf):
    from hypergef_tpu_torch import probes

    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    plan = probes.ring_plan(c, 8, 32, n_buf, sms)
    assert plan.blocks * plan.pairs * plan.per_pair >= c and plan.per_pair == 1
    x, gidx, mask = _dead_inf_operands(50, c, 8, 32, seed=c + n_buf, device=cuda)
    got = probes.chunk_masked_sum_ring(x, gidx, mask, n_buf)
    _assert_bitwise_with_nans(got, ell_gather.ell_gather_sum_plain(x, gidx.long(), mask))


def test_chunk_ring_rejects_what_the_kernel_does_not_take(cuda):
    from hypergef_tpu_torch import probes

    x, gidx, mask = _dead_inf_operands(64, 40, 4, 8, seed=3, device=cuda)
    with pytest.raises(ValueError, match="n_buf"):
        probes.chunk_masked_sum_ring(x, gidx, mask, 5)
    unaligned = torch.empty(64 * 8 + 1, device=cuda)[1:].view(64, 8)
    with pytest.raises(ValueError, match="16-byte"):
        probes.chunk_masked_sum_ring(unaligned, gidx, mask, 4)
    with pytest.raises(ValueError, match="16-byte"):
        probes.chunk_masked_sum_ring(x[:, :6].contiguous(), gidx, mask, 4)


@pytest.mark.parametrize("numel", [1, 7, 4096, 1_000_003, 1_048_576 * 128 + 3])
def test_scaled_copy_kernel_is_bitwise_plain(cuda, numel):
    from hypergef_tpu_torch import probes

    x = torch.as_tensor(np.random.default_rng(numel).normal(size=numel).astype(np.float32),
                        device=cuda)
    before = probes.scaled_copy_launches
    assert torch.equal(probes.scaled_copy(x, 2.0), x * 2.0)
    assert probes.scaled_copy_launches == before + 1


def test_scaled_copy_refuses_an_offset_view(cuda):
    from hypergef_tpu_torch import probes

    x = torch.ones(4097, device=cuda)[1:]
    before = probes.scaled_copy_launches
    with pytest.raises(ValueError, match="16-byte"):
        probes.scaled_copy(x, 2.0)
    assert probes.scaled_copy_launches == before


def test_probes_hold_against_their_oracles_on_the_card(cuda):
    """Every probe of scripts/ at the scripts' shapes (probe_r2_gather's tiny
    and pubmed scales), each row against the script's oracle."""
    from hypergef_tpu_torch import probes

    for name, fn in probes.PROBES.items():
        kw = ({"scales": {k: probes.R2_SCALES[k] for k in ("tiny", "pubmed")}}
              if name == "probe_r2_gather" else {})
        rows = fn(cuda, **kw)
        bad = [(r["case"], r["max_abs_err"]) for r in rows if not r["ok"]]
        assert not bad, f"{name}: {bad}"
        assert all(r["launches"] == 1 for r in rows), name


# --------------------------------------------------------------------------
# The compiled step and request: CUDA-graph replays against eager calls

COMPILED_CASES = [("cumsum", "sum"), ("cumsum", "max"), ("tree", "sum"), ("tree", "max"),
                  ("dense", "sum"), ("pallas", "sum"), ("pallas", "max"),
                  ("pallas_sparse", "sum"), ("aligned", "sum"), ("aligned", "max"),
                  ("bitstream", "sum"), ("bitstream", "max"), ("precomp", "sum")]


@functools.lru_cache(maxsize=None)
def _compiled_graphs():
    from hypergef_tpu_torch.data.synthetic import random_features, random_hypergraph

    hg = random_hypergraph(3000, 1200, avg_edge_size=6.0, seed=4)
    sbm = sorted_community_graph(3000, 2000, 30, 6, 0.02, 5)
    return {g: (h, *random_features(h.num_nodes, 24, 4, seed=6)) for g, h in
            (("random", hg), ("community", sbm))}


def _compiled_problem(route, aggr, model="HGNN", **cfg):
    from hypergef_tpu_torch.train.splits import rand_train_test_idx
    from hypergef_tpu_torch.train.trainer import TrainConfig

    hg, x, y = _compiled_graphs()["community" if route == "aligned" else "random"]
    plan = None
    if route == "aligned":
        kernel = dataclasses.replace(planner.plan_aligned(hg), form="pallas_auto")
        plan = planner.AggregationPlan(aligned=kernel)
    elif route == "pallas_sparse":
        plan = planner.plan_pallas_sparse(hg)
    tcfg = TrainConfig(model=model, nhid=16, first_aggr=aggr, backend=route, **cfg)
    return tcfg, hg, x, y, rand_train_test_idx(y, seed=2)["train"], plan


def _trainers(route, aggr, model="HGNN", **cfg):
    from hypergef_tpu_torch.train.trainer import Trainer

    tcfg, hg, x, y, idx, plan = _compiled_problem(route, aggr, model, **cfg)
    return [Trainer(tcfg, hg, x, y, nclass=4, plan=plan, device="cuda", compiled=c)
            for c in (False, True)], idx


@pytest.mark.parametrize("route,aggr", COMPILED_CASES)
def test_captured_fit_equals_eager(cuda, route, aggr):
    """Five epochs with dropout: the captured step's losses bitwise equal
    the eager step's, again after fit re-seeds the registered generator,
    and the captured forward's log-probs equal the eager one's."""
    (eager, captured), idx = _trainers(route, aggr)
    assert (eager.compiled, captured.compiled) == (False, True)
    for _ in range(2):
        want, got = (t.fit(idx, epochs=5, warmup=1) for t in (eager, captured))
        assert (want["step"], got["step"]) == ("eager", "captured")
        np.testing.assert_array_equal(got["losses"], want["losses"])
    assert torch.equal(captured.predict(), eager.predict())
    for a, b in zip(captured._state(), eager._state()):
        assert torch.equal(a, b)


@pytest.mark.parametrize("model", ["UniGIN", "UniGCNII"])
def test_captured_unignn_fit_equals_eager(cuda, model):
    (eager, captured), idx = _trainers("bitstream", "sum", model)
    want, got = (t.fit(idx, epochs=4) for t in (eager, captured))
    np.testing.assert_array_equal(got["losses"], want["losses"])


def test_recording_counts_and_replays_run_the_kernels(cuda, tmp_path, monkeypatch):
    """The wrapper counts the warm-up step's launches and the recording's,
    and no replay's; the recording holds the step's 8 segment sums as
    kernel nodes, which every replay launches, and a graph kept to be
    written out gives the eager losses too; a second fit records nothing."""
    from hypergef_tpu_torch.ops import segment_sum
    from hypergef_tpu_torch.train.trainer import CAPTURE_WARMUP
    from hypergef_tpu_torch.utils import graphs

    monkeypatch.setattr(graphs, "DUMP_DIR", str(tmp_path))
    (eager, captured), idx = _trainers("cumsum", "sum")
    want = eager.fit(idx, epochs=4, warmup=0)["losses"]
    segment_sum.launches = 0
    res = captured.fit(idx, epochs=4, warmup=0)
    assert res["capture_warmup"] == CAPTURE_WARMUP and res["capture_s"] > 0
    assert segment_sum.launches == 8 * (CAPTURE_WARMUP + 1)
    np.testing.assert_array_equal(res["losses"], want)
    (step,) = captured._steps.values()
    lines = Path(step.dot).read_text().splitlines()
    assert sum("segment_sum_kernel" in line for line in lines) == 8
    segment_sum.launches = 0
    assert captured.fit(idx, epochs=3, warmup=0)["capture_s"] == 0.0
    assert segment_sum.launches == 0


@pytest.mark.parametrize("route,aggr", [("cumsum", "sum"), ("pallas", "sum"),
                                        ("aligned", "max"), ("bitstream", "sum")])
def test_captured_requests_equal_eager(cuda, route, aggr):
    """A captured request equals the eager one bitwise, and an answer
    survives the next request."""
    from hypergef_tpu_torch.serve import ServingModel

    cfg, hg, x, _, _, plan = _compiled_problem(route, aggr)
    eager, captured = (ServingModel(cfg, hg, x.shape[1], 4, "cuda", plan=plan, compiled=c)
                       for c in (False, True))
    assert captured.capture_s > 0 and eager.capture_s == 0.0
    x1 = torch.as_tensor(x, device="cuda")
    x2 = torch.flip(x1, dims=[0]).contiguous()
    a1 = captured.predict(x1)
    a2 = captured.predict(x2)
    assert torch.equal(a1, eager.predict(x1)) and torch.equal(a2, eager.predict(x2))
    assert not torch.equal(a1, a2)
    assert torch.equal(a1, captured.predict(x1))


def test_plain_aligned_max_raises_under_capture(cuda):
    """The plain aligned max form reads the device from the host: captured,
    the Trainer and the server raise CaptureError; eager, they run."""
    from hypergef_tpu_torch.serve import ServingModel
    from hypergef_tpu_torch.train.trainer import Trainer
    from hypergef_tpu_torch.utils.graphs import CaptureError

    cfg, hg, x, y, idx, _ = _compiled_problem("aligned", "max")
    plain = planner.AggregationPlan(aligned=planner.plan_aligned(hg))
    with pytest.raises(CaptureError, match="compiled=False"):
        Trainer(cfg, hg, x, y, nclass=4, plan=plain, device="cuda").fit(idx, epochs=1)
    with pytest.raises(CaptureError, match="compiled=False"):
        ServingModel(cfg, hg, x.shape[1], 4, "cuda", plan=plain)
    eager = Trainer(cfg, hg, x, y, nclass=4, plan=plain, device="cuda", compiled=False)
    assert np.isfinite(eager.fit(idx, epochs=1)["losses"]).all()


def test_restore_into_a_captured_trainer_continues_bitwise(cuda, tmp_path):
    """A restore copies into the tensors the graphs read: a captured Trainer
    that restores goes on with the saved run's losses bitwise."""
    (_, a), idx = _trainers("cumsum", "sum")
    (_, b), _ = _trainers("cumsum", "sum")
    a.fit(idx, epochs=3)
    a.save(str(tmp_path / "ck"), step=3, wait=False)
    want = a.fit(idx, epochs=3)["losses"]
    b.fit(idx, epochs=2)  # its graph recorded, and a state of its own
    ptrs = [t.data_ptr() for t in b._state()]
    assert b.restore(str(tmp_path / "ck")) == 3
    assert [t.data_ptr() for t in b._state()] == ptrs
    np.testing.assert_array_equal(b.fit(idx, epochs=3)["losses"], want)


@pytest.mark.parametrize("compiled", [False, True])
def test_epoch_device_time_keeps_the_state_on_the_card(cuda, compiled):
    from hypergef_tpu_torch.train.trainer import Trainer

    tcfg, hg, x, y, idx, plan = _compiled_problem("cumsum", "sum")
    tr = Trainer(tcfg, hg, x, y, nclass=4, device="cuda", compiled=compiled)
    tr.fit(idx, epochs=2)
    before = [t.clone() for t in tr._state()], tr.generator.get_state()
    st = tr.epoch_device_time_stats(idx, iters=4, windows=3, repeats=2)
    assert st["timer"] == "cuda_events" and st["windows"] == 3 and st["median_s"] > 0
    assert tr.epoch_device_time(idx, iters=4) > 0
    for a, b in zip(tr._state(), before[0]):
        assert torch.equal(a, b)
    assert torch.equal(tr.generator.get_state(), before[1])


def test_autotune_sweep_on_the_card_takes_the_aligned_kernel_form(cuda, tmp_path):
    """The sweep on the card times every candidate, the kernel-form
    ``aligned`` one among them (a community-sorted graph), and its pick
    runs."""
    from hypergef_tpu_torch.sparse import autotune

    hg = sorted_community_graph(2000, 1600, 25, 5, 0.02, 3)
    cands = autotune.default_candidates(hg)
    assert ("aligned", {}) in cands
    plan = autotune._build_plan(hg, "aligned", {}, cuda)
    assert plan.form == "pallas_auto"
    before = aligned_band.launches
    res = autotune.sweep(hg, feature_size=32, iters=4, device=cuda)
    assert aligned_band.launches > before  # the band kernel was timed
    assert sorted(r.backend for r in res) == sorted(b for b, _ in cands)
    assert res == sorted(res, key=lambda r: r.per_iter_s)
    tuned = autotune.autotune_plan(hg, feature_size=32, cache_dir=str(tmp_path), device=cuda)
    rec = autotune.load_cached(autotune.graph_key(hg, 32, cuda), str(tmp_path))
    assert rec["device"] == torch.cuda.get_device_name(cuda)
    assert tuned.preferred_backend == rec["backend"]
    x = torch.randn(hg.num_nodes, 32, device=cuda, generator=torch.Generator(cuda).manual_seed(0))
    hgd = hg.device_data(cuda)
    got = fused.hgnn_aggregate(hgd, x, None, "sum", plan=tuned, backend="auto")
    want = fused.hgnn_aggregate(hgd, x, None, "sum", backend="xla")
    torch.testing.assert_close(got, want, rtol=3e-2, atol=3e-2 * float(want.abs().max()))


def test_plan_cache_round_trip_onto_the_card(cuda, tmp_path):
    """A kernel-form aligned plan and the ladder's plan saved and loaded onto
    the card: the same host tables, tensors on the card, the same output
    bitwise; a Trainer with ``plan_cache`` builds, then loads, and trains to
    the same losses bitwise."""
    from hypergef_tpu_torch.sparse import plancache
    from hypergef_tpu_torch.train.trainer import TrainConfig, Trainer

    hg = sorted_community_graph(2000, 1600, 25, 5, 0.02, 3)

    def build():
        return planner.AggregationPlan(aligned=dataclasses.replace(
            planner.plan_aligned(hg), form="pallas_auto"), preferred_backend="aligned")

    plan = plancache.cached_plan(hg, build, cache_dir=str(tmp_path), device=cuda, route="k")
    assert plan.aligned.form == "pallas_auto"
    back = plancache.cached_plan(hg, build, cache_dir=str(tmp_path), device=cuda, route="k")
    assert back is not plan and back.aligned.form == "pallas_auto" and back.aligned._device == {}
    for st, bst in ((plan.aligned.edge_stage, back.aligned.edge_stage),
                    (plan.aligned.vertex_stage, back.aligned.vertex_stage)):
        for b, bb in zip(st.buckets, bst.buckets):
            np.testing.assert_array_equal(b.b_dense, bb.b_dense)
    small = planner.plan_aggregation(Hypergraph.from_coo(
        np.arange(40) % 30, np.arange(40) // 2, num_nodes=30, num_edges=20), cuda)
    loaded = plancache.load_plan(plancache.save_plan(small, str(tmp_path / "s.npz")), cuda)
    assert loaded.precomp.a.device.type == "cuda" and loaded.precomp.a.dtype == torch.bfloat16
    assert torch.equal(loaded.precomp.a, small.precomp.a)
    x = torch.randn(hg.num_nodes, 32, device=cuda, generator=torch.Generator(cuda).manual_seed(1))
    hgd = hg.device_data(cuda)
    before = aligned_band.launches
    a = fused.hgnn_aggregate(hgd, x, None, "sum", plan=plan, backend="auto")
    b = fused.hgnn_aggregate(hgd, x, None, "sum", plan=back, backend="auto")
    assert aligned_band.launches == before + 4 and torch.equal(a, b)
    rng = np.random.default_rng(2)
    feats = rng.normal(size=(hg.num_nodes, 16)).astype(np.float32)
    y = rng.integers(0, 4, size=hg.num_nodes)
    idx = np.arange(hg.num_nodes // 2)
    losses = [Trainer(TrainConfig(epochs=3, warmup=0, plan_cache=str(tmp_path / "tr")), hg,
                      feats, y, device=cuda).fit(idx)["losses"] for _ in range(2)]
    assert len(os.listdir(tmp_path / "tr")) == 1
    np.testing.assert_array_equal(losses[0], losses[1])


def test_cli_platform_on_the_card(cuda, tmp_path, capsys):
    """``--platform cpu`` trains on the CPU, anything else on the card; a
    run writes the CSV row, ``--profile`` reports the device's memory."""
    from hypergef_tpu_torch.train import cli

    small = ["--synthetic", "powerlaw", "--n", "500", "--e", "300", "--feat", "8",
             "--classes", "3", "--nhid", "8", "--epochs", "4"]
    on_cpu = cli.main(small + ["--platform", "cpu"])
    assert on_cpu["timer"] == "host_clock" and on_cpu["step"] == "eager"
    out = str(tmp_path / "res.csv")
    for platform in ([], ["--platform", "cuda"], ["--platform", "gpu"]):
        res = cli.main(small + platform + ["--output", out])
        assert res["timer"] == "cuda_events" and res["step"] == "captured"
    assert len(open(out).read().splitlines()) == 3
    res = cli.main(small + ["--profile", "1"])
    assert 0 < res["device_memory_bytes"] <= res["device_memory_peak_bytes"]
    assert "MiB peak" in capsys.readouterr().out


def test_halo_aligned_world_matches_kernel_route(cuda):
    """A 2-rank gloo world sharing the card: the halo aggregation with the
    aligned interior (band kernel forward and backward in each rank) equals
    the single-device aligned kernel route on the same graph, at the bf16
    bar of JAX's own check (``tests/test_halo.py:255``: max |Δ| within
    5e-3 of max |ref|; the gradient within 1e-2)."""
    import sys

    from hypergef_tpu_torch.parallel.halo import plan_halo
    from hypergef_tpu_torch.parallel.launch import spawn

    sys.path.insert(0, str(REPO / "tests"))
    import torch_dist_ranks

    hg, _ = community_reorder(community_hypergraph(4000, 2000, 20, 8, 0.02, 0))
    plan = plan_halo(hg, 2, local_form="aligned")
    assert plan.local_form == "aligned"
    rng = np.random.default_rng(0)
    x = rng.normal(size=(hg.num_nodes, 32)).astype(np.float32)
    cot = rng.normal(size=(hg.num_nodes, 32)).astype(np.float32)
    (got, got_dx), _ = [r["halo"] for r in spawn(
        torch_dist_ranks.run, 2, backend="gloo", platform="cuda",
        args=([("halo", "halo", dict(plan=plan, x=x, cot=cot, form="aligned"))],),
        timeout_s=300)]
    ref_plan = planner.AggregationPlan(
        aligned=dataclasses.replace(planner.plan_aligned(hg), form="pallas_auto"))
    xt = torch.tensor(x, device=cuda, requires_grad=True)
    out = fused.hgnn_aggregate(hg.device_data(cuda), xt, None, "sum", backend="aligned",
                               plan=ref_plan)
    (out * torch.as_tensor(cot, device=cuda)).sum().backward()
    want, want_dx = out.detach().cpu().numpy(), xt.grad.cpu().numpy()
    assert np.abs(got - want).max() <= 5e-3 * np.abs(want).max()
    assert np.abs(got_dx - want_dx).max() <= 1e-2 * np.abs(want_dx).max()


def _serial_plan(n_nodes: int, n_edges: int, comm: int, d: int):
    from hypergef_tpu_torch.parallel.halo import plan_halo

    hg = community_hypergraph(n_nodes, n_edges, comm, 8.0, 0.01, 3)
    hg, _ = apply_vertex_order(hg, np.arange(hg.num_nodes), sort_edges=True)
    plan = plan_halo(hg, d, local_form="aligned")
    assert plan.local_form == "aligned"
    return hg, plan


def test_uncached_shard_build_leaves_the_plan_empty(cuda):
    """``local(..., cache=False)`` and ``ShardTables`` keep nothing on the
    plan; the tables wait in pinned host memory and come back to the card
    one storage a copy, views still views, the kernel tables whole."""
    from hypergef_tpu_torch.parallel.serial_halo import ShardTables, table_bytes

    _, plan = _serial_plan(4000, 2000, 20, 2)
    loc = plan.local(0, cuda, cache=False)
    assert plan._local == {} and loc.int_fwd.band is not None
    tables = ShardTables(plan, cuda)
    assert plan._local == {}
    host = tables.host[0]
    assert host.int_fwd.band.band.device.type == "cpu" and host.int_fwd.band.band.is_pinned()
    on_card = tables.local(0)
    assert on_card.int_fwd.band.band.device == torch.device(cuda.type, 0)
    assert (on_card.int_fwd.b_dense.untyped_storage().data_ptr()
            == on_card.int_fwd.band.band.untyped_storage().data_ptr())
    assert table_bytes(on_card) == tables.nbytes[0] == table_bytes(loc)
    x = torch.randn(plan.n_own, 32, device=cuda)
    assert torch.equal(aligned_band.aligned_band(x, on_card.int_fwd),
                       aligned_band.aligned_band(x, loc.int_fwd))


def _peak_above_base(fn):
    """fn()'s result and the card's peak bytes above what was allocated
    before it."""
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    res = fn()
    torch.cuda.synchronize()
    return res, torch.cuda.max_memory_allocated() - base


def test_serialized_forward_peak_memory(cuda):
    """A serialized forward holds one shard's tables and one turn's buffers
    at a time: its peak on the card stays under ``peak_bound``, and it
    equals the forward of the same plan on the CPU within the band
    kernel's 1e-5."""
    from hypergef_tpu_torch.parallel.serial_halo import (
        ShardTables, peak_bound, serialized_halo_forward)

    hg, plan = _serial_plan(20000, 10000, 80, 4)
    tables = ShardTables(plan, cuda)
    x = np.random.default_rng(1).normal(size=(hg.num_nodes, 32)).astype(np.float32)
    got, peak = _peak_above_base(
        lambda: serialized_halo_forward(plan, x, device=cuda, tables=tables))
    assert peak <= peak_bound(tables, 32)
    want = serialized_halo_forward(plan, x, device="cpu")
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5 * np.abs(want).max())
    assert plan._local == {}


def test_serialized_step_peak_memory(cuda):
    """A serialized training step keeps no shard's tables or residuals past
    its turn: its peak on the card stays under the forward's bound at its
    widest layer."""
    from hypergef_tpu_torch.parallel.serial_halo import ShardTables, peak_bound
    from hypergef_tpu_torch.parallel.serial_halo_train import serialized_halo_train_step

    hg, plan = _serial_plan(20000, 10000, 80, 4)
    tables = ShardTables(plan, cuda)
    rng = np.random.default_rng(2)
    x = rng.normal(size=(hg.num_nodes, 16)).astype(np.float32)
    y = rng.integers(0, 4, size=hg.num_nodes)
    mask = (rng.random(hg.num_nodes) < 0.5).astype(np.float32)
    params = {"w1": (rng.normal(size=(16, 32)) / 4.0).astype(np.float32),
              "w2": (rng.normal(size=(32, 8)) / np.sqrt(32)).astype(np.float32)}
    (loss, grads), peak = _peak_above_base(lambda: serialized_halo_train_step(
        plan, params, x, y, mask, device=cuda, tables=tables))
    assert peak <= peak_bound(tables, 32)
    assert np.isfinite(loss) and all(np.isfinite(g).all() for g in grads.values())
    assert plan._local == {}


def _minibatch_problem(n: int = 3000, e: int = 1600):
    from hypergef_tpu_torch.data.synthetic import homophilic_hypergraph, random_features
    from hypergef_tpu_torch.train.splits import rand_train_test_idx

    hg, y = homophilic_hypergraph(n, e, 4, avg_edge_size=5.0, seed=11)
    x, _ = random_features(hg.num_nodes, 16, 4, seed=12)
    return hg, x, y, rand_train_test_idx(y, seed=13)["train"]


@pytest.mark.parametrize("f", [1, 3, 6, 32, 64])
def test_padded_runs_segment_sum_is_bitwise_exact(cuda, f):
    """Each batch of an epoch, both CSRs: the segment-sum kernel over the
    pad shape's tables (runs padded to ``max_warp_runs``) is bitwise equal
    to the kernel over the batch's exact runs and to the plain version (the
    same f32 adds in CSR order from 0)."""
    from hypergef_tpu_torch.data.sampling import HyperedgeSampler
    from hypergef_tpu_torch.sparse.hypergraph import StaticTables
    from hypergef_tpu_torch.ops import segment_sum

    hg, _, _, _ = _minibatch_problem()
    sampler = HyperedgeSampler(hg, 128, seed=1, device=cuda)
    pad = sampler.probe_pad_shapes()
    tables = StaticTables(*pad, cuda)
    gen = torch.Generator(device=cuda).manual_seed(f)
    for b in sampler.epoch(pad_to=pad):
        b.write(tables)
        for side in ("v2e", "e2v"):
            padded, exact = getattr(tables.data, side), getattr(b.data, side)
            assert padded.runs.shape[0] - 1 == tables.runs[side] >= exact.runs.shape[0] - 1
            x = torch.randn((exact.num_inputs, f), generator=gen, device=cuda)
            got = segment_sum.gather_segment_sum(x, padded)
            want = segment_sum.gather_segment_sum(x, exact)
            assert torch.equal(got, want)
            assert torch.equal(got, segment_sum.gather_segment_sum_plain(x, exact))


@pytest.mark.parametrize("size,batch_edges,fixed_shapes",
                         [((3000, 1600), 128, True), ((300, 160), 16, False)],
                         ids=["probed", "bucket_a_batch"])
def test_recorded_minibatch_epoch_equals_eager(cuda, size, batch_edges, fixed_shapes):
    """Two epochs with dropout: the recorded steps' losses bitwise equal the
    eager steps', every pad shape recorded once (a probed shape that holds
    every batch; a bucket shape a batch, three recordings in one shared
    pool), the weights bitwise equal after."""
    from hypergef_tpu_torch.train.minibatch import MinibatchTrainer
    from hypergef_tpu_torch.train.trainer import TrainConfig

    hg, x, y, idx = _minibatch_problem(*size)
    cfg = TrainConfig(nhid=16, seed=3)
    eager, rec = (MinibatchTrainer(cfg, hg, x, y, idx, batch_edges=batch_edges,
                                   fixed_shapes=fixed_shapes, device=cuda, compiled=c)
                  for c in (False, None))
    assert (eager.compiled, rec.compiled) == (False, True)
    rec.model.load_state_dict(eager.model.state_dict())
    for _ in range(2):
        want, got = (t.fit(epochs=1) for t in (eager, rec))
        assert (want["step"], got["step"]) == ("eager", "captured")
        np.testing.assert_array_equal(got["losses"], want["losses"])
    assert rec.compile_count == eager.compile_count == len(rec._steps) == len(rec.tables)
    assert rec.compile_count == (1 if fixed_shapes else 3)
    assert sum(g.replays for g in rec._steps.values()) == 2 * got["batches"]
    for a, b in zip(rec._state(), eager._state()):
        assert torch.equal(a, b)


def test_recorded_dist_and_dp_steps_equal_eager_in_an_nccl_world(cuda):
    """A one-rank nccl world: a recorded DistTrainer fit (HGNN sum and max,
    UniGIN, UniGCNII; collectives, tree stages, record-routed sum and Adam
    in one graph) bitwise equal to an eager fit, and recorded
    DPMinibatchTrainer steps bitwise equal to eager ones."""
    import sys

    from hypergef_tpu_torch.parallel.launch import spawn
    from hypergef_tpu_torch.train.trainer import TrainConfig

    sys.path.insert(0, str(REPO / "tests"))
    import torch_dist_ranks

    hg, x, y, idx = _minibatch_problem()
    runs = [("HGNN", "sum"), ("HGNN", "max"), ("UniGIN", "sum"), ("UniGCNII", "sum")]
    cfg = TrainConfig(nhid=16, seed=3)
    (out,) = spawn(torch_dist_ranks.recorded_fits, 1, backend="nccl", platform="cuda",
                   args=(hg, x, y, idx, runs, (cfg, 128, None)), timeout_s=300)
    for run in runs:
        (s0, eager), (s1, rec) = out[run]
        assert (s0, s1) == ("eager", "captured"), run
        np.testing.assert_array_equal(rec, eager)
    (c0, eager), (c1, rec) = out["dp"]
    assert (c0, c1) == (False, True)
    np.testing.assert_array_equal(rec, eager)


def test_fig7_9_realistic_zoo_on_the_card(cuda, tmp_path):
    """The fig7/9 driver on the card at zoo's dims: the card's comment row,
    each timed route within its bar of the xla route's output (the driver
    ends SystemExit otherwise), and the auto column JAX's pick on the same
    pipeline (chip_smoke.py's REALISTIC_PICKS, held against JAX on the
    CPU)."""
    from hypergef_tpu_torch.experiments import fig7_9_realistic

    spec = importlib.util.spec_from_file_location("chip_smoke", REPO / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    out = tmp_path / "f.csv"
    (res,) = fig7_9_realistic.main(["--configs", "zoo", "--iters", "3", "--out", str(out)])
    lines = out.read_text().splitlines()
    assert lines[0].startswith("# card: ") and "W" in lines[0]
    assert res["auto"] == smoke.REALISTIC_PICKS["zoo"]
    assert set(res["times_us"]) == set(res["errors"]) == {"xla", res["auto"]} | (
        {"aligned"} if res["plan"].aligned is not None else set())
    for backend, e in res["errors"].items():
        assert e["max_abs_err"] <= e["rel_tol"] * e["max_abs_xla"], backend
    assert any(line.startswith("SUMMARY,zoo,") for line in lines)


def test_clustered_e2e_small_on_the_card(cuda, tmp_path):
    """The clustered e2e driver on the card at a small SBM: the card's
    comment row, the aligned row in the kernel form (the band kernel
    launched), each route's test accuracy above chance, and the recorded
    steps."""
    from hypergef_tpu_torch.experiments import clustered_e2e

    out = tmp_path / "e2e.csv"
    before = aligned_band.launches
    rows = clustered_e2e.main(["--nodes", "6000", "--edges", "3000", "--comm", "24",
                               "--iters", "3", "--epochs", "20", "--out", str(out)])
    lines = out.read_text().splitlines()
    assert lines[0].startswith("# card: ") and "W" in lines[0]
    assert "aligned form=pallas_auto" in lines[2]
    assert [r["backend"] for r in rows] == list(clustered_e2e.BACKENDS)
    assert rows[0]["form"] == "pallas_auto" and aligned_band.launches > before
    for r in rows:
        assert r["step"] == "captured" and r["epoch_us"] > 0, r
        assert r["test_acc"] > 100.0 / clustered_e2e.NCLASS, r


# ------------------------------------------------ the ell, bsr and multihot routes
NEW_ROUTES = ("ell", "bsr", "multihot", "multihot_batched", "multihot_precomp")


def new_route_plan(route, hg, device):
    """The plan of one of the three routes (the multihot plan in the named
    form) and the route's name."""
    from hypergef_tpu_torch.sparse.bsr import plan_bsr

    tree = planner.plan_tree(hg)
    if route == "ell":
        return planner.AggregationPlan(tree=tree, tile=planner.plan_tiles(hg)), "ell"
    if route == "bsr":
        return planner.AggregationPlan(tree=tree, bsr=plan_bsr(hg)), "bsr"
    return planner.AggregationPlan(
        tree=tree, multihot=planner.plan_multihot(hg, tile_rows=128, form=route)), "multihot"


@pytest.mark.parametrize("aggr", ["sum", "mean", "max", "uni"])
@pytest.mark.parametrize("route", NEW_ROUTES)
def test_new_routes_match_plain_and_repeat_bitwise(cuda, route, aggr):
    """Each of the three routes on the card against the same route on CPU
    tensors (the kernels' plain twins; the products in f32 of the same bf16
    operands): outputs and dx within 1e-5·max (the same f32 terms in another
    order), 1e-2 for ``multihot_precomp``, whose nested combine rounds the
    partials to bf16 again; two card runs bitwise equal. The ``ell`` route
    launches the gather and segment-sum kernels once a stage apply."""
    from hypergef_tpu_torch.ops import segment_sum

    hg = sorted_community_graph(2000, 1600, 25, 5, 0.02, 3)
    rng = np.random.default_rng(8)
    x = rng.normal(size=(hg.num_nodes, 16)).astype(np.float32)
    cot = rng.normal(size=(hg.num_nodes, 16)).astype(np.float32)
    res = []
    for dev in (cuda, cuda, torch.device("cpu")):
        plan, backend = new_route_plan(route, hg, dev)
        hgd = hg.device_data(dev)
        xr = torch.as_tensor(x, device=dev).requires_grad_(True)
        before = (ell_gather.launches, segment_sum.launches)
        if aggr == "uni":
            out = fused.unignn_aggregate(hgd, xr, True, plan=plan, backend=backend)
        else:
            out = fused.hgnn_aggregate(hgd, xr, None, aggr, plan=plan, backend=backend)
        (out * torch.as_tensor(cot, device=dev)).sum().backward()
        if dev.type == "cuda":
            torch.cuda.synchronize()
        launched = (ell_gather.launches - before[0], segment_sum.launches - before[1])
        res.append((out.detach().cpu(), xr.grad.cpu(), launched))
    (o1, g1, n1), (o2, g2, _), (op, gp, np_) = res
    assert torch.equal(o1, o2) and torch.equal(g1, g2)
    # max takes V→E and, on ell, E→V from the tree (JAX's fused.py:244-258)
    want = (4, 4) if route == "ell" and aggr != "max" else (0, 0)
    assert (n1, np_) == (want, (0, 0))
    tol = 1e-2 if route == "multihot_precomp" else 1e-5
    for got, ref in ((o1, op), (g1, gp)):
        torch.testing.assert_close(got, ref, rtol=tol, atol=tol * float(ref.abs().max()))


@pytest.mark.parametrize("route", NEW_ROUTES)
def test_new_routes_captured_steps_equal_eager(cuda, route):
    """A Trainer on each route, captured against eager from the same seed
    with dropout on: three epochs' losses bitwise equal."""
    from hypergef_tpu_torch.data.synthetic import random_features
    from hypergef_tpu_torch.train.trainer import TrainConfig, Trainer

    hg = sorted_community_graph(2000, 1600, 25, 5, 0.02, 3)
    x, y = random_features(hg.num_nodes, 24, 4, seed=1)
    idx = np.arange(0, hg.num_nodes, 2)
    plan, backend = new_route_plan(route, hg, cuda)
    cfg = TrainConfig(nhid=16, backend=backend)
    losses = [Trainer(cfg, hg, x, y, nclass=4, plan=plan, device="cuda", compiled=c).fit(
        idx, epochs=3, warmup=0) for c in (False, True)]
    assert losses[1]["step"] == "captured"
    assert np.array_equal(losses[0]["losses"], losses[1]["losses"])


def test_clustered_bench_small_on_the_card(cuda, tmp_path):
    """clustered_bench at a small size on the card: the card's row, every
    candidate timed and within its bar of ``xla``, the ladder's pick named."""
    from hypergef_tpu_torch.experiments import clustered_bench

    out = tmp_path / "c.csv"
    rows = clustered_bench.main(["--n", "4000", "--e", "2000", "--comm", "24", "--iters", "3",
                                 "--out", str(out)])
    lines = out.read_text().splitlines()
    assert lines[0].startswith("# card: ") and lines[2] == clustered_bench.HEADER
    timed = [r for r in rows if "summary" not in r]
    assert all(r["ok"] for r in timed)
    assert {r["backend"] for r in timed if r["graph"] == "sbm"} == {
        "cumsum", "tree", "bsr", "multihot", "aligned"}
    assert [r["graph"] for r in rows if "summary" in r] == ["sbm", "random"]


# --------------------------------------------------------------------------
# Profiling: the one profiler helper, and the op-level counts

PROFILE_SESSIONS = 5
# the second session's start after the first: from about 45 s on, a session
# that kept CUPTI attached from the first lost its kernel
PROFILE_AGE_S = 60.0


def _pallas_trainers(cuda):
    """An eager and a recorded Trainer of HGNN on a 20news-shaped graph
    (the e2e graph's sizes) through the fused dense kernel."""
    from hypergef_tpu_torch.data.synthetic import random_features, random_hypergraph
    from hypergef_tpu_torch.train.splits import rand_train_test_idx
    from hypergef_tpu_torch.train.trainer import TrainConfig, Trainer

    hg = random_hypergraph(16242, 100, avg_edge_size=654.5, seed=0, name="20news")
    x, y = random_features(16242, 100, 4, seed=1)
    cfg = TrainConfig(model="HGNN", nhid=32, nlayer=2, backend="pallas")
    return ([Trainer(cfg, hg, x, y, device=cuda, compiled=c) for c in (False, True)],
            rand_train_test_idx(y, seed=2)["train"])


def test_profiler_sessions_leave_recordings_whole(cuda):
    """Five profiler sessions in one process, the second 60 s after the
    first, each followed by a Trainer's recorded fit on the pallas route
    (``tools/profiler_sessions.py``): every session sees the fused dense
    kernel, every recording replays the eager losses bitwise. Opened
    otherwise than by ``profiling.profiler`` (the tool's ``--raw``), the
    sessions kept CUPTI attached from the first on, and a session 45 s or
    more after the first lost its kernel (its stamp, from a stale clock
    correlation, out of its window): no device events."""
    from hypergef_tpu_torch.tools import profiler_sessions

    rows = profiler_sessions.run(PROFILE_SESSIONS, PROFILE_AGE_S)
    assert len(rows) == PROFILE_SESSIONS
    for row in rows:
        assert row["kernel"] and row["captured"] and row["bitwise"], rows


def test_trace_on_the_card_in_a_fifth_session(cuda, tmp_path):
    """``trace`` after four sessions in this process: its trace file holds
    the fused dense kernel as a device event."""
    import json

    from hypergef_tpu_torch.utils import profiling

    h, x, se, sv = _operands(2708, 2708, 32, 0.0015, seed=2, device=cuda)
    for _ in range(PROFILE_SESSIONS - 1):
        with profiling.profiler() as prof:
            fused_dense.fused_dense_two_stage(h, x, se, sv)
            torch.cuda.synchronize()
        assert profiling.device_events(prof)
    with profiling.trace(str(tmp_path)):
        fused_dense.fused_dense_two_stage(h, x, se, sv)
    (path,) = tmp_path.glob("trace-*.json")
    kernels = [e.get("name", "") for e in json.loads(path.read_text())["traceEvents"]
               if e.get("cat") == "kernel"]
    assert any("fused_dense_kernel" in k for k in kernels), kernels


def _count_calls(dev):
    """One call of each kernel wrapper on ``dev``, from the same seeded
    operands on either device."""
    from hypergef_tpu_torch import probes
    from hypergef_tpu_torch.data.synthetic import random_hypergraph
    from hypergef_tpu_torch.ops import segment_sum

    def t(a):
        return torch.as_tensor(a, device=dev)

    h, x, se, sv = _operands(301, 187, 17, 0.05, seed=4, device=dev)
    carrier = _packed(h)
    rng = np.random.default_rng(5)
    gidx = rng.integers(0, 90, size=(40, 8))
    mask = (rng.random((40, 8)) < 0.7).astype(np.float32)
    gather = ell_gather.GatherTable(t(gidx.astype(np.int32)), t(gidx), t(mask), 90)
    x90 = t(rng.normal(size=(90, 8)).astype(np.float32))
    hg = random_hypergraph(120, 70, avg_edge_size=4.0, seed=3)
    record = hg.device_data(dev).record
    table = segment_sum.SegmentTable.build(hg.ht_indptr, hg.ht_indices, hg.num_nodes, dev)
    xn = t(rng.normal(size=(hg.num_nodes, 5)).astype(np.float32))
    ge = t(rng.normal(size=(hg.num_edges, 5)).astype(np.float32))
    arg_e = t(rng.integers(0, hg.num_nodes, size=(hg.num_edges, 5)).astype(np.int32))
    plan = dataclasses.replace(aligned_plan("bucketed"), form="pallas_auto")
    st = plan.device(dev)[0]
    xs = t(rng.normal(size=(st.num_inputs, 7)).astype(np.float32))
    arg_s = t(rng.integers(0, st.num_segments, size=(st.num_inputs, 7)).astype(np.int32))
    pack = bitstream.BitIncidence.from_hypergraph(hg).device(dev)[0]
    xk = t(rng.normal(size=(pack.k, 4)).astype(np.float32))
    idx = t(rng.integers(0, 90, size=33).astype(np.int32))
    gidx32 = t(rng.integers(0, 90, size=(12, 5)).astype(np.int32))
    mask12 = t((rng.random((12, 5)) < 0.6).astype(np.float32))
    g3 = t(rng.normal(size=(12, 5, 8)).astype(np.float32))
    return {
        "fused_dense_two_stage": lambda: fused_dense.fused_dense_two_stage(h, x, se, sv),
        "fused_dense_two_stage_packed": lambda: fused_dense.fused_dense_two_stage(
            carrier, x, se, sv, packed=True),
        "fused_dense_v2e": lambda: fused_dense._v2e(h, x, 187, False),
        "fused_dense_v2e_packed": lambda: fused_dense._v2e(carrier, x, 187, True),
        "ell_gather_sum": lambda: ell_gather.ell_gather_sum(x90, gather),
        "gather_segment_sum": lambda: segment_sum.gather_segment_sum(xn, table),
        "record_routed_dx": lambda: segment_sum.record_routed_dx(ge, arg_e, record),
        "aligned_band": lambda: aligned_band.aligned_band(xs, st),
        "aligned_masked_argmax": lambda: aligned_max.aligned_masked_argmax(xs, st),
        "aligned_masked_argsum": lambda: aligned_max.aligned_masked_argsum(xs, arg_s, st),
        "bitmm": lambda: bitstream.bitmm(pack, xk),
        "row_gather": lambda: probes.row_gather(x90, idx),
        "chunk_masked_sum": lambda: probes.chunk_masked_sum(g3, mask12),
        "chunk_masked_sum_ring": lambda: probes.chunk_masked_sum_ring(x90, gidx32, mask12, 4),
        "scaled_copy": lambda: probes.scaled_copy(x90, 0.5),
    }


KERNEL_OPS = ["fused_dense_two_stage", "fused_dense_two_stage_packed", "fused_dense_v2e",
              "fused_dense_v2e_packed", "ell_gather_sum", "gather_segment_sum",
              "record_routed_dx", "aligned_band", "aligned_masked_argmax",
              "aligned_masked_argsum", "bitmm", "row_gather", "chunk_masked_sum",
              "chunk_masked_sum_ring", "scaled_copy"]


@pytest.mark.parametrize("kernel", KERNEL_OPS)
def test_a_kernel_op_counts_the_same_on_the_card_and_the_cpu(cuda, kernel):
    """A kernel is one op of its declared count on both devices: the card's
    count (the launch) equals the CPU's (the plain twin), and neither holds
    an aten op of its body."""
    from hypergef_tpu_torch.utils import profiling

    counts = {dev: profiling.cost_analysis(_count_calls(dev)[kernel], device=dev)
              for dev in ("cuda", "cpu")}
    for dev, got in counts.items():
        assert got["ops"] == {} and list(got["kernels"]) == [kernel], (dev, got)
        assert got["kernel_ops"] == 1, dev
    assert counts["cuda"]["kernels"] == counts["cpu"]["kernels"]
    assert counts["cuda"]["devices"] == ["cuda:0"] and counts["cpu"]["devices"] == ["cpu"]


def test_a_replay_is_refused_in_a_count(cuda):
    from hypergef_tpu_torch.utils import profiling

    (_, captured), idx = _pallas_trainers(cuda)
    captured.fit(idx, epochs=1, warmup=0)
    idx_t = torch.as_tensor(idx, device=cuda)
    with pytest.raises(RuntimeError, match="replay"):
        profiling.cost_analysis(captured.step, idx_t)
