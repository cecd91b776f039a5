"""The ELL chunk sum's host side, on the CPU: the gather kernel's schedule
and lane order, and the probes' chunk-ring launch plan.

* ``ell_gather.gather_schedule`` over the level-0 tables of the
  pubmed_real and coauthor_dblp ``plan_pallas_sparse`` plans at the widths
  their HGNN layers aggregate (the hidden 32 and the classes' width), and
  over the probes' tables: the form follows F and x's alignment, a chunk's
  lanes are a power of two that covers its quads or features (8 lanes, 4
  chunks a warp, at F = 32; 4 at F = 3), and one batch holds every slot
  up to 16.
* A NumPy emulation of the kernel (``csrc/ell_gather.cu``): each lane's
  table loads and the shuffles that hand slots out, each lane's pieces, the
  batches in slot order, f32 products and sums rounded apart. Every index a
  lane takes is its slot's, every output element is written once, and the
  result is bitwise equal to ``ell_gather_sum_plain`` (NaN where a dead
  slot names an Inf row, in the same places), and within rtol 1e-6 of JAX's
  Pallas kernel in interpret mode at ``tests/test_pallas_sparse.py:21``'s
  shapes.
* ``probes.ring_plan``, emulated as the ring kernel walks it: every chunk
  summed by exactly one consumer lane group, the one whose slot it lands
  in; shared memory within a block's 232,448 bytes and the SM's; one wave
  on the H100's 132 SMs; resident producer-consumer pairs that do not fall
  as ``n_buf`` grows; a producer never waits on a slot whose last chunk it
  has still to issue.
* The C entries' ctypes argument types and the constants the host shares
  with the kernels, against the sources.
"""

import functools
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hypergef_tpu.ops.pallas_sparse import ell_gather_sum as jell_gather_sum

from hypergef_tpu_torch import probes
from hypergef_tpu_torch.data.synthetic import random_hypergraph
from hypergef_tpu_torch.ops import _build, ell_gather
from hypergef_tpu_torch.sparse.planner import plan_pallas_sparse

# (n, e, avg edge size) of the graphs whose plans the kernel runs, and the
# widths their HGNN layers aggregate: nhid 32 and the classes'
GRAPHS = {"pubmed_real": ((19717, 7963, 10.8), (32, 3)),
          "coauthor_dblp": ((41302, 22363, 4.5), (32, 6))}
# the probes' gather tables: (ngs, F) of probe_r2_gather's scales, the k5
# pair and probe_r2b_bisect's k7-k10
PROBE_TABLES = [(8, 32), (8, 64), (2, 128), (8, 128)]
MAX_STAGING = 32 * 1024  # the kernel's staging a block at most: 16 slots x 128 lanes x 16 B


@functools.lru_cache(maxsize=None)
def _level0(name):
    (n, e, avg), _ = GRAPHS[name]
    hg = random_hypergraph(n, e, avg_edge_size=avg, seed=0, name=name)
    return [tuple(st.gather0.gidx.shape) for st in plan_pallas_sparse(hg).device("cpu")]


def _check_schedule(f, ngs, aligned):
    sched = ell_gather.gather_schedule(f, ngs, aligned)
    lanes, batch, form = sched
    assert lanes in (1, 2, 4, 8, 16, 32) and form in ell_gather.FORMS
    assert (form == "quad") == (f % 4 == 0 and aligned)
    assert batch == min(ngs, ell_gather.MAX_BATCH)
    pieces = f // 4 if form == "quad" else f
    # the lanes cover a row's pieces in one pass, or are a full warp
    assert lanes >= pieces or lanes == 32
    assert lanes < 2 * pieces
    assert form == "wide" or batch * 128 * 16 <= MAX_STAGING  # quads are staged
    return sched


@pytest.mark.parametrize("name", list(GRAPHS))
def test_schedule_of_the_main_path_tables(name):
    """pubmed_real's and coauthor_dblp's level-0 tables at the widths their
    layers aggregate; at F = 32 a warp serves 4 chunks, a float4 a lane."""
    _, widths = GRAPHS[name]
    for c, ngs in _level0(name):
        for f in widths:
            sched = _check_schedule(f, ngs, True)
            if f == 32:
                assert sched == (8, min(ngs, 16), "quad")
            else:  # the classes' width: a feature a lane, 4 or 8 lanes a chunk
                assert sched == (4 if f == 3 else 8, min(ngs, 16), "wide")
    if name == "pubmed_real":  # the issue's tables: [8366, 16] and [20162, 8]
        assert _level0(name) == [(8366, 16), (20162, 8)]


@pytest.mark.parametrize("ngs,f", PROBE_TABLES)
@pytest.mark.parametrize("aligned", [True, False])
def test_schedule_of_the_probe_tables(ngs, f, aligned):
    sched = _check_schedule(f, ngs, aligned)
    assert sched.batch == ngs  # every probe chunk is one batch
    if aligned:
        assert sched.lanes_per_chunk == min(f // 4, 32)


def emulate_gather(x, gidx, mask, sched):
    """The kernel's arithmetic and data movement, group by group: returns the
    output and how often each element was written. The tables are taken
    16-byte aligned, as a table on the card is."""
    c, ngs = gidx.shape
    f = x.shape[1]
    lanes, batch, form = sched
    mb = 8 if batch <= 8 else ell_gather.MAX_BATCH  # the kernel's unrolled batch, B
    # slots a table load holds: quads read it as 16-byte vectors where they can
    per = 4 if form == "quad" and ngs % 4 == 0 and batch % 4 == 0 else 1
    loads = -(-(mb // per) // lanes)  # table loads a lane makes
    pieces = f // 4 if form == "quad" else f
    out = np.zeros((c, f), np.float32)
    written = np.zeros((c, f), np.int64)
    for p0 in range(0, pieces, lanes):
        for sub in range(lanes):
            piece = p0 + sub
            if piece >= pieces:
                continue
            cols = np.arange(4 * piece, 4 * piece + 4) if form == "quad" else np.array([piece])
            acc = None
            for k0 in range(0, ngs, batch):
                nk = min(batch, ngs - k0)
                # each lane of the group loads its share of the batch's table
                regs = {}
                for s in range(lanes):
                    for r in range(loads):
                        j = s + r * lanes
                        for i in range(per):
                            ok = j * per < nk
                            regs[s, r * per + i] = (gidx[:, k0 + j * per + i] if ok else 0,
                                                    mask[:, k0 + j * per + i] if ok else 0)
                for u in range(nk):  # issue, then sum, in slot order
                    holder, reg = (u // per) % lanes, (u // per // lanes) * per + u % per
                    idx, m = regs[holder, reg]
                    assert np.array_equal(idx, gidx[:, k0 + u])
                    assert np.array_equal(m, mask[:, k0 + u])
                    with np.errstate(invalid="ignore"):  # 0 x Inf is NaN, as on the card
                        p = x[idx][:, cols] * m[:, None]
                    acc = p if k0 + u == 0 else acc + p
            out[:, cols] = acc
            written[:, cols] += 1
    return out, written


def _table(n, c, ngs, f, seed, inf_row=True):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, f)).astype(np.float32)
    gidx = rng.integers(0, n, size=(c, ngs)).astype(np.int32)
    mask = (rng.random((c, ngs)) > 0.3).astype(np.float32)
    if inf_row:  # row 0 all Inf, named by dead slots only
        x[0] = np.inf
        gidx[gidx == 0] = 1
        gidx[(mask == 0) & (rng.random((c, ngs)) < 0.3)] = 0
    return x, gidx, mask


@pytest.mark.parametrize("f,ngs,aligned", [
    (32, 16, True), (32, 8, False), (3, 16, True), (6, 8, True), (33, 5, True),
    (4, 2, False), (128, 64, True), (1, 1, True), (132, 12, True), (16, 37, True),
    (64, 6, True), (4, 8, True)])
def test_emulated_kernel_is_bitwise_the_plain_loop(f, ngs, aligned):
    x, gidx, mask = _table(61, 45, ngs, f, seed=f * 100 + ngs)
    sched = ell_gather.gather_schedule(f, ngs, aligned)
    got, written = emulate_gather(x, gidx, mask, sched)
    assert (written == 1).all()
    want = ell_gather.ell_gather_sum_plain(torch.as_tensor(x), torch.as_tensor(gidx).long(),
                                           torch.as_tensor(mask)).numpy()
    assert np.isnan(want).any()
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    live = ~np.isnan(want)
    np.testing.assert_array_equal(got[live].view(np.uint32), want[live].view(np.uint32))


@pytest.mark.parametrize("impl", ["vmem", "dma"])
def test_emulated_kernel_matches_the_pallas_kernel(impl):
    """tests/test_pallas_sparse.py:21's shapes: n 300, c 700, ngs 8, F 16."""
    x, gidx, mask = _table(300, 700, 8, 16, seed=0, inf_row=False)
    want = np.asarray(jell_gather_sum(jnp.asarray(x), jnp.asarray(gidx), jnp.asarray(mask),
                                      impl=impl, interpret=True))
    got, _ = emulate_gather(x, gidx, mask, ell_gather.gather_schedule(16, 8, True))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6 * float(np.abs(want).max()))


def emulate_ring(plan, c, ngs, f, blocks=None):
    """Each pair's chunks as the ring kernel deals them: (chunk, consumer lane
    group, slot) per pair, after checking the producer's steps."""
    dealt = []
    cpw = probes.ring_chunks_a_warp(f)
    per_pass = 32 // (f // 4 if f // 4 < 32 and 32 % (f // 4) == 0 else 32)
    reach = min(32, (plan.slots - 1) * ngs + 1,  # csrc/probes.cu::ring_step
                max(per_pass, plan.slots * ngs // 4))
    step = reach // per_pass * per_pass if reach >= per_pass else reach
    for pair in range((blocks or plan.blocks) * plan.pairs):
        c0 = pair * plan.per_pair
        n = min(plan.per_pair, c - c0)
        if n <= 0:
            assert pair // plan.pairs == plan.blocks - 1, "a block with an idle pair"
            continue
        for t0 in range(0, min(n * ngs, 64 * plan.slots * ngs), step):
            # a chunk starting in this step waits for its slot's last chunk,
            # whose copies and arrivals were all issued in an earlier step
            for r in range(-(-t0 // ngs), min(n, -(-(t0 + step) // ngs))):
                if r >= plan.slots:
                    assert (r - plan.slots + 1) * ngs - 1 < t0
        dealt.append([(c0 + r, r % cpw, r % plan.slots) for r in range(n)])
    return dealt


RING_CASES = [(4096, 8, 32), (10752, 8, 64), (1_249_792, 8, 32), (2, 2, 128), (3001, 1, 4),
              (3001, 64, 128), (7, 8, 32), (500, 5, 32)]


@pytest.mark.parametrize("c,ngs,f", RING_CASES)
def test_ring_plan_deals_every_chunk_once_in_one_wave(c, ngs, f):
    """probe_r2_gather's tiny, pubmed and 2M scales, k5, and edge cases;
    the H100's 132 SMs."""
    sms = 132
    pairs = []
    for n_buf in probes.RING_DEPTHS:
        plan = probes.ring_plan(c, ngs, f, n_buf, sms)
        assert plan.smem <= probes.RING_BUDGET
        assert plan.smem + 1024 <= 233_472  # a block an SM: the SM's 228 KB
        assert plan.blocks <= sms  # one wave
        assert 1 <= plan.pairs <= probes.RING_MAX_PAIRS
        cpw = probes.ring_chunks_a_warp(f)
        assert plan.slots % cpw == 0 and 0 < plan.slots <= n_buf
        assert plan.smem == plan.pairs * (plan.slots * probes.ring_slot_bytes(ngs, f)
                                          + probes.RING_TABLE_BYTES)
        sample = emulate_ring(plan, c, ngs, f, blocks=3 if c > 100_000 else None)
        if c <= 100_000:
            owned = [chunk for dealt in sample for chunk, _, _ in dealt]
            assert sorted(owned) == list(range(c))
        for dealt in sample:
            for _, group, slot in dealt:  # a slot is always one lane group's
                assert slot % cpw == group
        assert plan.blocks * plan.pairs * plan.per_pair >= c
        pairs.append(plan.pairs)
    # the same pairs at every depth: as many as the budget holds at the
    # deepest, or as the chunks need
    assert pairs == sorted(pairs, reverse=True) and len(set(pairs)) == 1
    assert pairs[0] <= c


def test_ring_plan_fills_the_budget_at_the_2m_scale():
    """At probe_r2_gather's 2M-row scale (ngs 8, F 32) a block holds 12
    producer-consumer pairs at every depth, with 4, 8 or 16 slots each."""
    plans = [probes.ring_plan(1_249_792, 8, 32, nb, 132) for nb in probes.RING_DEPTHS]
    assert [p.pairs for p in plans] == [12, 12, 12]
    assert [p.slots for p in plans] == [4, 8, 16]
    assert plans[-1].smem > probes.RING_BUDGET * 0.9
    with pytest.raises(ValueError, match="n_buf"):
        probes.ring_plan(100, 8, 32, 5, 132)
    with pytest.raises(ValueError, match="exceeds"):
        probes.ring_plan(100, 64, 1024, 4, 132)


def test_kernel_entries_and_constants_match_the_sources():
    """The ctypes signatures hold as many arguments as the C entries take,
    and the constants the host shares with the kernels are theirs."""
    gather = (_build.CSRC / "ell_gather.cu").read_text()
    ring = (_build.CSRC / "probes.cu").read_text()
    for source, entry in ((gather, "hg_ell_gather_sum"), (ring, "hg_chunk_masked_sum"),
                          (ring, "hg_chunk_sum_ring"), (ring, "hg_row_gather")):
        m = re.search(rf'extern "C" int {entry}\(([^)]*)\)', source)
        args = m.group(1).split(",")
        assert len(args) == len(_build.ENTRIES[entry]), entry
        # pointers and the stream as c_void_p, ints as c_int
        for arg, t in zip(args, _build.ENTRIES[entry]):
            assert ("*" in arg) == (t is _build._PTR), (entry, arg)
    assert f"constexpr int kMaxBatch = {ell_gather.MAX_BATCH};" in gather
    assert "enum Form : int { kQuad = 0, kWide = 1 };" in gather
    assert ell_gather.FORMS == ("quad", "wide")
    assert "__launch_bounds__(kThreads, kMinBlocks)" in gather
    assert "constexpr int kThreads = 128;" in gather and "constexpr int kMinBlocks = 8;" in gather
    assert f"constexpr int kRingMaxPairs = {probes.RING_MAX_PAIRS};" in ring
    assert f"constexpr int kSmemBudget = {probes.RING_BUDGET};" in ring
    assert ("int lanes = 8;\n  while (lanes < f / 4 && lanes < 32) lanes *= 2;\n"
            "  return 32 / lanes;") in ring  # probes.ring_chunks_a_warp
    assert "constexpr int kRingTable = 6;" in ring
    assert probes.RING_TABLE_BYTES == 6 * 32 * 8
    # emulate_ring's step
    assert ("const int reach =\n      min(min(32, (slots - 1) * ngs + 1), max(per_pass, slots "
            "* ngs / kRingStepShare));") in ring
    assert "constexpr int kRingStepShare = 4;" in ring
    assert "return reach >= per_pass ? reach / per_pass * per_pass : reach;" in ring
