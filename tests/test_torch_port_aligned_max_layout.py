"""The max kernels' live layout (``ops/aligned_max.py::live_layout``), on the CPU.

The CUDA kernels of ``csrc/aligned_max.cu`` walk, for each group of an
aligned stage, a list of its live slots cut into chunks. Here the layout
is built on the CPU from the kernel-form stages of the small aligned
fixtures (the SBM graph of tests/test_torch_port_aligned.py, 2000 × 1600,
in the bucketed, split, uniform and 64-row-group layouts) and held against
the stage; a walk in the kernels' order over it is held against JAX
(``hypergef_tpu/ops/aligned_max.py``, its Pallas kernels in interpret
mode). Tolerances:

* the listed (segment, source) pairs: exactly ``live_pairs`` of the stage;
* the argmax walk, values and int32 ids: bitwise equal to JAX's
  ``aligned_max_with_arg`` (random and tie-heavy inputs);
* the arg-sum walk: bitwise equal to the slot-order emulation of the flat
  tables (``test_torch_port_max._emulate_argsum``: the sums of the kernel
  this layout replaced), and within rtol = atol = 1e-6 of JAX's
  ``_argsum_apply`` (the same few f32 terms summed in another order).
"""

import dataclasses
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hypergef_tpu.ops import aligned_max as jaligned_max

from hypergef_tpu_torch.ops import _build, aligned_max
from test_torch_port_aligned import _layout_plans
from test_torch_port_cuda import aligned_plan, live_entries, walk_argmax, walk_argsum
from test_torch_port_max import _emulate_argsum, _x

REPO = Path(__file__).resolve().parents[1]
LAYOUTS = ["bucketed", "split", "uniform", "group64"]
EXACT = dict(rtol=1e-6, atol=1e-6)


def _padded(t):
    """A table's host array with one more entry, so a masked-out index 0
    reads inside it even where the table is empty."""
    return np.concatenate([t.numpy(), np.zeros(1, t.numpy().dtype)])


def _kernel_stage(plan, stage):
    return dataclasses.replace(plan, form="pallas_auto").device("cpu")[stage]


@pytest.mark.parametrize("layout", LAYOUTS + ["counts", "past_n", "empty", "block200", "gap",
                                    "spill_only", "dense"])
@pytest.mark.parametrize("stage", [0, 1], ids=["edge", "vertex"])
def test_layout_lists_exactly_the_live_pairs(layout, stage):
    """The listed pairs are the stage's live pairs, each once; each
    (chunk, row) list ascends, a group's chunks follow its slots, and every
    entry's slot holds a non-zero count whose source is the entry's."""
    plan = _layout_plans(layout)[1] if layout in LAYOUTS else aligned_plan(layout)
    table = _kernel_stage(plan, stage).band
    live = aligned_max.live_layout(table)
    live.check(table)
    seg, src, slot, chunk, off = live_entries(table, live)
    want_seg, want_src = aligned_max.live_pairs(_kernel_stage(plan, stage))
    got = np.lexsort((src, seg))
    want = np.lexsort((want_src.numpy(), want_seg.numpy()))
    np.testing.assert_array_equal(seg[got], want_seg.numpy()[want])
    np.testing.assert_array_equal(src[got], want_src.numpy()[want])
    same = (chunk[1:] == chunk[:-1]) & (seg[1:] == seg[:-1])
    assert (off[1:][same] > off[:-1][same]).all()  # each list ascends
    c = live.chunks.numpy().astype(np.int64)
    gc = live.group_chunks.numpy()
    for g in range(table.num_groups):  # chunks of a group: disjoint, in slot order
        mine = c[gc[g]:gc[g + 1]]
        assert (mine[1:, 3] >= mine[:-1, 3] + mine[:-1, 1]).all()
    g_rows, b_rows = table.group_rows, table.block_rows
    d = table.groups.numpy()[seg // g_rows]
    row = seg % g_rows
    window = slot < d[:, 2] * b_rows
    counts = np.where(window, _padded(table.band)[np.where(window, d[:, 0] + row * d[:, 2] * b_rows
                                                           + slot, 0)],
                      _padded(table.spill)[np.where(window, 0, d[:, 3] + row * d[:, 5]
                                                    + slot - d[:, 2] * b_rows)])
    assert (counts != 0).all()
    blocks = _padded(table.win)[np.where(window, d[:, 1] + slot // b_rows, 0)]
    spill_src = _padded(table.src)[np.where(window, 0, d[:, 4] + slot - d[:, 2] * b_rows)]
    np.testing.assert_array_equal(
        src, np.where(window, blocks * b_rows + slot % b_rows, spill_src))


@pytest.mark.parametrize("case", ["bucketed", "uniform", "block200", "dense", "group200"])
def test_layout_fits_the_kernels(case):
    """Chunks of at most CHUNK rows of one window block or of the spill and
    at most CHUNK_LIVE entries; offsets in uint16 and inside their chunk;
    a dense graph's chunks cut by their entries, not only by CHUNK."""
    plan = aligned_plan(case)
    for stage in (0, 1):
        table = _kernel_stage(plan, stage).band
        live = aligned_max.live_layout(table)
        c = live.chunks.numpy().astype(np.int64)
        rp = live.row_ptr.numpy().astype(np.int64)
        per_chunk = np.diff(rp[:len(c) * table.group_rows + 1:table.group_rows])
        assert live.slots.dtype == torch.uint16 and live.row_ptr.dtype == torch.int32
        assert (c[:, 1] >= 1).all() and (c[:, 1] <= aligned_max.CHUNK).all()
        assert (per_chunk >= 1).all() and (per_chunk <= aligned_max.CHUNK_LIVE).all()
        assert (live.slots.numpy()[:rp[-1]] < np.repeat(c[:, 1], per_chunk)).all()
        b_rows = table.block_rows
        window = c[:, 2] == 0
        wb = table.groups.numpy()[:, 2].max() * b_rows
        assert (c[window, 3] // b_rows == (c[window, 3] + c[window, 1] - 1) // b_rows).all()
        assert (c[window, 3] < wb).all() and (c[window, 0] + c[window, 1] <= table.num_inputs).all()
        # read in 16-byte pieces: the tables reach the next 16 bytes past their end
        assert len(rp) == -(-(len(c) * table.group_rows + 1) // 4) * 4
        assert live.slots.numel() == -(-int(rp[-1]) // 8) * 8
        # the work items (a group's CTA of rows each), costliest first
        g_rows, cta = table.group_rows, aligned_max.ROWS_PER_CTA
        row_ctas = -(-g_rows // cta)
        items = live.items.numpy()
        assert sorted(items.tolist()) == list(range(table.num_groups * row_ctas))
        chunks = np.diff(live.group_chunks.numpy())[items // row_ctas]
        assert (np.diff(chunks) <= 0).all()
        if case == "dense":
            assert per_chunk.max() > aligned_max.CHUNK_LIVE // 2
            assert (c[:, 1] < aligned_max.CHUNK).sum() > len(c) // 2


@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("stage", [0, 1], ids=["edge", "vertex"])
@pytest.mark.parametrize("ties", [False, True])
def test_argmax_walk_is_bitwise_jax(layout, stage, ties):
    jplan, tplan = _layout_plans(layout)
    table = _kernel_stage(tplan, stage).band
    x = _x(table.num_inputs, 5, seed=20 + stage, ties=ties)
    want_val, want_arg = jaligned_max.aligned_max_with_arg(jnp.asarray(x), jplan.device()[stage])
    val, arg = walk_argmax(x, table, aligned_max.live_layout(table))
    np.testing.assert_array_equal(val, np.asarray(want_val))
    np.testing.assert_array_equal(arg, np.asarray(want_arg))


@pytest.mark.parametrize("layout", LAYOUTS)
def test_argsum_walk_sums_as_the_flat_tables_did(layout):
    """Over the vertex stage, with the twin's ids of the edge stage: bitwise
    the slot-order sums of the flat tables; on the uniform stage also JAX's
    ``_argsum_apply`` within 1e-6."""
    jplan, tplan = _layout_plans(layout)
    e_st, v_st = (_kernel_stage(tplan, s) for s in (0, 1))
    _, arg = aligned_max.aligned_max_plain(torch.as_tensor(_x(e_st.num_inputs, 5, seed=31)), e_st)
    g = _x(v_st.num_inputs, 5, seed=32)
    got = walk_argsum(g, arg.numpy(), v_st.band, aligned_max.live_layout(v_st.band))
    flat = _emulate_argsum(torch.as_tensor(g), arg, v_st.band)
    assert torch.equal(torch.as_tensor(got), flat)
    torch.testing.assert_close(torch.as_tensor(got),
                               aligned_max.aligned_argsum_plain(torch.as_tensor(g), arg, v_st),
                               **EXACT)
    if layout == "uniform":
        want = jaligned_max._argsum_apply(jnp.asarray(g), jnp.asarray(arg.numpy()),
                                          jplan.device()[1])
        np.testing.assert_allclose(got, np.asarray(want), **EXACT)


@pytest.mark.parametrize("case", ["gap", "spill_only", "uniform_spill_only", "dense", "block200"])
def test_walks_hold_the_twins_on_the_cards_edge_cases(case):
    """The stages the card tests add for the max kernels: the argmax walk
    bitwise equal to the twin (tie-heavy inputs), the arg-sum walk within
    1e-6 of it and bitwise equal to the flat tables' slot-order sums."""
    plan = aligned_plan(case)
    e_st, v_st = (_kernel_stage(plan, s) for s in (0, 1))
    for st in (e_st, v_st):
        x = _x(st.num_inputs, 4, seed=41, ties=True)
        want_val, want_arg = aligned_max.aligned_max_plain(torch.as_tensor(x), st)
        val, arg = walk_argmax(x, st.band, aligned_max.live_layout(st.band))
        assert torch.equal(torch.as_tensor(val), want_val)
        assert torch.equal(torch.as_tensor(arg), want_arg)
    _, arg = aligned_max.aligned_max_plain(torch.as_tensor(_x(e_st.num_inputs, 4, seed=42)), e_st)
    g = _x(v_st.num_inputs, 4, seed=43)
    got = torch.as_tensor(walk_argsum(g, arg.numpy(), v_st.band, aligned_max.live_layout(v_st.band)))
    assert torch.equal(got, _emulate_argsum(torch.as_tensor(g), arg, v_st.band))
    torch.testing.assert_close(got, aligned_max.aligned_argsum_plain(torch.as_tensor(g), arg, v_st),
                               **EXACT)


def test_layout_constants_match_the_kernel_source():
    """The wrapper's CHUNK, CHUNK_LIVE, ROWS_PER_CTA and RING are the
    kernels' constants, and the ctypes entries take the sources' arguments."""
    source = (REPO / "hypergef_tpu_torch" / "csrc" / "aligned_max.cu").read_text()
    for name, value in (("kChunk", aligned_max.CHUNK), ("kChunkLive", aligned_max.CHUNK_LIVE),
                        ("kRowsPerCta", aligned_max.ROWS_PER_CTA),
                        ("kStagesMax", aligned_max.RING[0]), ("kStagesSum", aligned_max.RING[1])):
        assert re.search(rf"constexpr int {name} = {value};", source), name
    for name in ("hg_aligned_masked_argmax", "hg_aligned_masked_argsum", "hg_aligned_max_layout"):
        m = re.search(rf'extern "C" int {name}\(([^)]*)\)', source)
        assert m and len(m.group(1).split(",")) == len(_build.ENTRIES[name]), name


def test_live_layout_is_checked_with_its_table():
    """A table on the CPU holds no layout; one laid out is checked: chunks
    past x or wider than CHUNK, lists longer than CHUNK_LIVE, offsets past
    their chunk and a work item listed twice are refused."""
    st = _kernel_stage(aligned_plan("bucketed"), 0)
    assert st.band.live is None  # laid out only on a CUDA device
    table = st.band.with_kernel_layout()
    live = table.live
    assert live is not None and live.nbytes() > 0
    wide = live.chunks.clone()
    wide[0, 1] = aligned_max.CHUNK + 1
    past = live.chunks.clone()
    past[0, 0] = table.num_inputs
    long_list = live.row_ptr.clone()
    long_list[table.group_rows:] += aligned_max.CHUNK_LIVE
    bad_off = live.slots.clone()
    bad_off[0] = aligned_max.CHUNK
    twice = live.items.clone()
    twice[1] = twice[0]
    for change, match in (({"chunks": wide}, "spans"), ({"chunks": past}, "spans"),
                          ({"row_ptr": long_list}, "past the slots|more than"),
                          ({"slots": bad_off}, "past its chunk"),
                          ({"slots": live.slots.to(torch.int16)}, "uint16"),
                          ({"items": twice}, "work items")):
        with pytest.raises(ValueError, match=match):
            dataclasses.replace(table, live=dataclasses.replace(live, **change))
