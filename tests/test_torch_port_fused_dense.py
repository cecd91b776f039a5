"""The fused dense kernel's host side, on the CPU: the work split that the
wrapper computes for its one cooperative launch, and the tile constants it
shares with ``csrc/fused_dense.cu``. The kernel itself runs on the card
(``tests/test_torch_port_cuda.py``)."""

import re

import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from hypergef_tpu_torch.ops import _build, fused_dense


def _covered(ws, items):
    """Every (row, edge) cell of the items of all CTAs, with its count."""
    seen = {}
    for cta in range(ws.grid):
        for rows, edges in items(cta):
            assert len(rows) > 0 and len(edges) > 0
            key = (rows.start, rows.stop, edges.start, edges.stop)
            seen[key] = seen.get(key, 0) + 1
    return seen


def _assert_tiles_once(ws, n, e, items):
    seen = _covered(ws, items)
    assert all(c == 1 for c in seen.values()), "an item is done twice"
    # the items tile [0, n) x [0, e): disjoint boxes whose areas add up
    assert sum((r1 - r0) * (e1 - e0) for r0, r1, e0, e1 in seen) == n * e
    rows = sorted({(r0, r1) for r0, r1, _, _ in seen})
    edges = sorted({(e0, e1) for _, _, e0, e1 in seen})
    for cuts in (rows, edges):
        assert all(a[1] == b[0] for a, b in zip(cuts, cuts[1:]))
    assert rows[0][0] == 0 and rows[-1][1] == n and edges[0][0] == 0 and edges[-1][1] == e
    assert len(seen) == len(rows) * len(edges)


def _check_split(n, e, f, sms, ctas):
    ws = fused_dense.work_split(n, e, f, sms, ctas)
    assert 1 <= ws.grid <= sms * ctas
    assert ws.fp % 8 == 0 and f <= ws.fp < f + 8
    # phase A: (row split, edge tile) pairs; phase C: (row tile, edge split)
    _assert_tiles_once(ws, n, e, ws.v2e_items)
    _assert_tiles_once(ws, n, e, ws.e2v_items)
    for k, splits, per, step in ((n, ws.splits_a, ws.k_a, fused_dense.K_STEP),
                                 (e, ws.splits_c, ws.k_c, fused_dense.K_STEP_C)):
        # what the C entry checks: every split holds at least one row or edge
        assert splits * per >= k > (splits - 1) * per
        assert per % step == 0
    for ways, splits in ((ws.ways_a, ws.splits_a), (ws.ways_c, ws.splits_c)):
        assert ways in (1, 2, 4, 8, 16, 32) and (ways == 1 or ways < 2 * splits)
    # the splits keep the CTAs at least as busy over their waves as no split
    cap = sms * ctas

    def busy(items):
        return items / (-(-items // cap) * cap)

    for tiles, splits in ((ws.edge_tiles, ws.splits_a), (ws.row_tiles, ws.splits_c)):
        assert busy(tiles * splits) >= busy(tiles)
    return ws


@settings(max_examples=60, deadline=None)
@given(n=st.integers(1, 40000), e=st.integers(1, 9000), f=st.integers(1, 200),
       sms=st.integers(1, 132), ctas=st.integers(1, 4))
def test_work_split_covers_every_row_and_edge_once(n, e, f, sms, ctas):
    _check_split(n, e, f, sms, ctas)


@pytest.mark.parametrize("n,e,f", [
    (16242, 100, 32),  # 20news: E = 100, one edge tile, rows split 127 ways
    (19717, 7963, 32),  # pubmed_real: odd E
    (2708, 2708, 7),  # cora: few row tiles, so the edges are split too
    (5, 3, 1),  # fewer rows than one CTA's
    (100, 1, 65),  # one edge, two feature passes
])
def test_work_split_at_the_main_paths_shapes(n, e, f):
    ws = _check_split(n, e, f, 132, fused_dense.CTAS_PER_SM)
    if (n, e) == (2708, 2708):
        assert ws.splits_c > 1  # phase D runs
    if n <= fused_dense.ROWS_PER_CTA:
        assert ws.splits_a == ws.row_tiles == 1


def test_v2e_split_has_no_phase_c():
    ws = fused_dense.work_split(2708, 2708, 32, 132, 2, two_stage=False)
    assert ws.row_tiles == 0 and ws.splits_c == 1 and list(ws.e2v_items(0)) == []
    assert ws.grid <= 264


def test_kernel_source_matches_the_wrapper():
    """The tile constants of csrc/fused_dense.cu are the wrapper's, the
    kernel is one cooperative launch on the tensor cores, and the ctypes
    signatures hold as many arguments as the C entries take."""
    source = (_build.CSRC / "fused_dense.cu").read_text()
    consts = {k: int(v) for k, v in re.findall(r"constexpr int (k\w+) = (\d+);", source)}
    warps = consts["kWarps"]
    assert (16 * warps, 8 * warps, consts["kKStep"], consts["kKStepC"], consts["kFChunk"],
            32 * warps, consts["kCtasPerSm"]) == (
        fused_dense.EDGE_TILE, fused_dense.ROWS_PER_CTA, fused_dense.K_STEP,
        fused_dense.K_STEP_C, fused_dense.F_CHUNK, fused_dense.THREADS,
        fused_dense.CTAS_PER_SM)
    assert "__launch_bounds__(kThreads, kCtasPerSm)" in source
    assert "cudaLaunchCooperativeKernel" in source and "grid.sync()" in source
    assert "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32" in source
    assert source.count("<<<") == 0  # no other launch
    for name in ("hg_fused_dense_two_stage", "hg_dense_v2e", "hg_fused_dense_layout"):
        m = re.search(rf'extern "C" int {name}\(([^)]*)\)', source)
        assert m, name
        assert len(m.group(1).split(",")) == len(_build.ENTRIES[name]), name
