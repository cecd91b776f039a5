"""The probes' row gather and scaled copy, host side, on the CPU.

* ``probes.row_plan`` at every depth over the probes' shapes (R = 8, 64,
  4,096, 85,024 and 9,998,336; F = 32 and 128) on the H100's 132 SMs:
  every row in exactly one warp's range, one wave, shared memory within a
  block's 232,448 bytes, the same warps a block at every ring depth, and
  stages of a power of two rows whose 16-byte pieces fit the 32 lanes;
  the ring's copies, walked lane by lane as the kernel walks them: every
  piece of every row copied and stored once, by one lane, each stage
  refilled only after that lane stored what it held.
* A NumPy emulation of the direct kernel (``csrc/probes.cu``): each lane's
  index loads, the shuffles that hand rows round, the pieces dealt in
  output order, loads before stores; every output element written once and
  the result bitwise equal to ``index_select``, in float4 pieces and in
  floats (an x one float off a 16-byte boundary).
* The scaled copy's float4 body and its n % 4 tail: every element once.
* The changed C entries' ctypes argument types and the constants the host
  shares with the kernels, against the source.
* The port's ``row_gather`` on the CPU bitwise against
  ``scripts/pallas_probe.py``'s own kernel bodies ``k1`` (``:41``) and
  ``k2`` (``:59``), run by ``pl.pallas_call(..., interpret=True)`` on the
  script's own data, the script loaded with importlib as it stands.
"""

import importlib.util
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from hypergef_tpu_torch import probes
from hypergef_tpu_torch.ops import _build

REPO = Path(__file__).resolve().parents[1]
SOURCE = (_build.CSRC / "probes.cu").read_text()
SMS = 132  # the H100 SXM's
SM_SHARED = 233_472  # an SM's shared memory: 228 KB, 1 KB of it kept for each block
ROW_SHAPES = [(r, f) for r in (8, 64, 4096, 85_024, 9_998_336) for f in (32, 128)]
DEPTHS = (0,) + probes.RING_DEPTHS


def _constant(name: str) -> int:
    return int(re.search(rf"constexpr int {name} = (\d+);", SOURCE).group(1))


def warp_ranges(plan, r):
    """[start, end) of every warp of the launch that has rows."""
    starts = np.arange(plan.blocks * plan.warps, dtype=np.int64) * plan.per_warp
    ends = np.minimum(starts + plan.per_warp, r)
    live = starts < r
    return starts[live], ends[live]


@pytest.mark.parametrize("r,f", ROW_SHAPES)
def test_row_plan_covers_every_row_once(r, f):
    """Every row in exactly one warp's range; a warp's rows capped, one wave
    where the capped ranges fit one; shared memory within the budget; the
    ring's warps a block from the budget at the deepest ring, the same at
    every depth; stages a power of two rows whose pieces fit the lanes."""
    budget_warps = min(probes.ROW_MAX_WARPS, probes.RING_BUDGET // (16 * f * 4))
    for n_buf in DEPTHS:
        plan = probes.row_plan(r, f, n_buf, SMS)
        starts, ends = warp_ranges(plan, r)
        # contiguous, disjoint, in order: every row in exactly one warp's range
        assert starts[0] == 0 and ends[-1] == r
        assert np.array_equal(starts[1:], ends[:-1])
        assert (ends > starts).all()
        if n_buf == 0:
            assert plan.warps == probes.ROW_DIRECT_WARPS and plan.tile == 0 and plan.smem == 0
            assert probes.ROW_DIRECT_MIN <= plan.per_warp <= probes.ROW_DIRECT_MAX
            wave = SMS * probes.ROW_DIRECT_BLOCKS
            if r <= wave * plan.warps * probes.ROW_DIRECT_MAX:
                assert plan.blocks <= wave
        else:
            assert 1 <= plan.warps <= budget_warps
            assert plan.per_warp <= probes.ROW_RING_MAX
            if r <= SMS * budget_warps * probes.ROW_RING_MAX:
                assert plan.blocks <= SMS  # a block an SM
            assert plan.smem == plan.warps * n_buf * f * 4
            assert plan.smem <= probes.RING_BUDGET and plan.smem + 1024 <= SM_SHARED
            assert n_buf % plan.tile == 0 and plan.tile & (plan.tile - 1) == 0
            assert plan.tile == 1 or plan.tile * f // 4 <= 32
            assert 2 * plan.tile > min(n_buf, 32 // (f // 4))
    if r >= 85_024:  # rows that fill the card: the same warps a block at every depth
        assert len({probes.row_plan(r, f, nb, SMS).warps for nb in probes.RING_DEPTHS}) == 1


def test_row_plan_at_the_probe_shapes():
    """The take (85,024 rows of F = 32): 21 rows a warp, 4 direct blocks an
    SM, 131 ring blocks of 31 warps; the 2M-row scale: 32 rows a direct
    warp and 64 a ring warp over many waves, 32 ring warps a block at F =
    32 and 28 at F = 128 (16 rows of 512 bytes each within the budget);
    the small probes: 4 rows a direct warp, a row a ring warp, and a warp
    a block where the rows are too few for more on every SM."""
    assert probes.row_plan(85_024, 32, 0, SMS)[:3] == (507, 8, 21)
    for nb in probes.RING_DEPTHS:
        assert probes.row_plan(85_024, 32, nb, SMS)[:4] == (131, 31, 21, 4)
    assert probes.row_plan(9_998_336, 32, 0, SMS)[:3] == (39_056, 8, 32)
    for f, w in ((32, 32), (128, 28)):
        plan = probes.row_plan(9_998_336, f, 16, SMS)
        assert (plan.warps, plan.per_warp) == (w, 64) and plan.blocks > SMS
    assert probes.row_plan(8, 128, 0, SMS)[:3] == (1, 8, 4)
    assert probes.row_plan(4096, 128, 0, SMS)[:3] == (128, 8, 4)
    assert probes.row_plan(8, 128, 4, SMS)[:3] == (8, 1, 1)
    assert probes.row_plan(64, 128, 4, SMS)[:3] == (64, 1, 1)
    assert probes.row_plan(4096, 128, 8, SMS)[:3] == (128, 16, 2)
    with pytest.raises(ValueError, match="n_buf"):
        probes.row_plan(100, 32, 5, SMS)
    with pytest.raises(ValueError, match="exceed"):
        probes.row_plan(100, 4000, 16, SMS)


def emulate_ring(x, idx, plan, n_buf):
    """The ring kernel's data movement (csrc/probes.cu), warp by warp and
    lane by lane: each lane's copies into its stages and its stores from
    them, in its order. Returns the output and each element's stores, after
    checking that a stage slot is stored by the lane that filled it before
    that lane fills it again."""
    r, f = idx.shape[0], x.shape[1]
    f4, tile = f // 4, plan.tile
    stages = n_buf // tile
    out = np.zeros((r, f4, 4), np.float32)
    stored = np.zeros((r, f4), np.int64)
    xq = x.reshape(-1, f4, 4)
    starts, ends = warp_ranges(plan, r)
    for r0, r1 in zip(starts, ends):
        n = r1 - r0
        tiles = -(-n // tile)
        for lane in range(32):
            j = lane // f4 if f4 <= 32 else 0
            qs = range(lane % f4 if f4 <= 32 else lane, f4, 32)
            ring = {}  # (stage, row, piece) -> (tile it holds, value)

            def issue(t):
                if t < tiles and j < min(tile, n - t * tile):
                    # the batch of 32 indices the warp holds, and the lane it shuffles from
                    batch, holder = t * tile // 32, (t * tile + j) & 31
                    src = idx[r0 + min(32 * batch + holder, n - 1)]
                    assert src == idx[r0 + t * tile + j]
                    for q in qs:
                        key = (t % stages, j, q)
                        assert key not in ring, "a slot refilled before it was stored"
                        ring[key] = (t, xq[src, q])

            for t in range(stages):
                issue(t)
            for t in range(tiles):
                if j < min(tile, n - t * tile):
                    for q in qs:
                        held, v = ring.pop((t % stages, j, q))
                        assert held == t
                        out[r0 + t * tile + j, q] = v
                        stored[r0 + t * tile + j, q] += 1
                issue(t + stages)
            assert not ring
    return out.reshape(r, f), stored


@pytest.mark.parametrize("f", [4, 12, 32, 64, 128, 132])
@pytest.mark.parametrize("n_buf", probes.RING_DEPTHS)
@pytest.mark.parametrize("r,sms", [(5001, 2), (21, 132), (1, 132), (700, 1)])
def test_emulated_ring_kernel_is_index_select(f, n_buf, r, sms):
    rng = np.random.default_rng(f * 10 + r + n_buf)
    x = rng.normal(size=(900, f)).astype(np.float32)
    idx = rng.integers(0, 900, size=r).astype(np.int32)
    got, stored = emulate_ring(x, idx, probes.row_plan(r, f, n_buf, sms), n_buf)
    assert (stored == 1).all()
    want = probes.row_gather_plain(torch.as_tensor(x), torch.as_tensor(idx)).numpy()
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))


def kernel_division(p, lane):
    """The direct kernel's start and step in (row, piece) for a row of p
    pieces (csrc/probes.cu): a / p by one reciprocal, (a * ceil(2^16 / p))
    >> 16, where a <= 32 and p <= 32; row 0 and piece lane past 32 pieces."""
    inv = -(-65536 // p)
    dj = 0 if p > 32 else (32 * inv) >> 16
    j0 = np.zeros_like(lane) if p > 32 else (lane * inv) >> 16
    return dj, 32 - dj * p, j0, lane - j0 * p


@pytest.mark.parametrize("p", range(1, 40))
def test_kernel_division_is_integer_division(p):
    a = np.arange(33)
    dj, dq, j0, q0 = kernel_division(p, a[:32])
    assert (dj, dq) == divmod(32, p)
    assert np.array_equal(j0, a[:32] // p) and np.array_equal(q0, a[:32] % p)


def emulate_direct(x, idx, plan, pieces: int):
    """The direct kernel's data movement (csrc/probes.cu), warp by warp, the
    32 lanes as a vector: returns the output and each element's writes. A
    piece is 4 floats (``pieces`` = F / 4) or 1 (``pieces`` = F)."""
    unroll = _constant("kRowUnroll")
    r, f = idx.shape[0], x.shape[1]
    width = f // pieces
    xp = x.reshape(-1, pieces, width)
    out = np.zeros((r, pieces, width), np.float32)
    written = np.zeros((r, pieces), np.int64)
    lane = np.arange(32)
    dj, dq, j0, q0 = kernel_division(pieces, lane)
    starts, ends = warp_ranges(plan, r)
    for r0, r1 in zip(starts, ends):
        n = r1 - r0
        ahead = idx[r0 + np.minimum(lane, n - 1)]
        for b in range(0, n, 32):
            mine = ahead
            ahead = idx[r0 + np.minimum(b + 32 + lane, n - 1)]
            nb = min(32, n - b)
            total = nb * pieces
            j, q = j0, q0
            for e0 in range(0, total, 32 * unroll):
                loaded = []
                for u in range(unroll):
                    src = mine[np.minimum(j, nb - 1)]  # __shfl_sync
                    loaded.append((xp[src, q], e0 + 32 * u + lane))
                    j, q = j + dj, q + dq
                    j, q = np.where(q >= pieces, j + 1, j), np.where(q >= pieces, q - pieces, q)
                for v, e in loaded:
                    ok = e < total
                    rows, qs = r0 + b + e[ok] // pieces, e[ok] % pieces
                    out[rows, qs] = v[ok]
                    np.add.at(written, (rows, qs), 1)
    return out.reshape(r, f), written


@pytest.mark.parametrize("f", [1, 3, 4, 32, 64, 128, 132])
@pytest.mark.parametrize("aligned", [True, False])
@pytest.mark.parametrize("r,sms", [(5001, 2), (21, 132), (1, 132), (700, 1)])
def test_emulated_direct_kernel_is_index_select(f, aligned, r, sms):
    """float4 pieces where F % 4 == 0 and x is aligned, else floats (F = 3,
    132's float form, an x one float off its boundary)."""
    rng = np.random.default_rng(f * 10 + r)
    x = rng.normal(size=(900, f)).astype(np.float32)
    idx = rng.integers(0, 900, size=r).astype(np.int32)
    pieces = f // 4 if f % 4 == 0 and aligned else f
    plan = probes.row_plan(r, f, 0, sms)
    got, written = emulate_direct(x, idx, plan, pieces)
    assert (written == 1).all()
    want = probes.row_gather_plain(torch.as_tensor(x), torch.as_tensor(idx)).numpy()
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))


@pytest.mark.parametrize("numel", [1, 3, 4, 4097, 1_048_576 * 4 + 7])
def test_scaled_copy_covers_every_element_once(numel):
    """The kernel's indexing (csrc/probes.cu): thread i of the grid of
    ceil(n / 4 / 256) blocks (at least one) copies float4 i and, for i < n %
    4, the tail's element i."""
    n4 = numel // 4
    i = np.arange(max(1, -(-n4 // 256)) * 256)
    hits = np.zeros(numel, np.int64)
    for k in range(4):
        np.add.at(hits, 4 * i[i < n4] + k, 1)
    np.add.at(hits, 4 * n4 + i[i < numel - 4 * n4], 1)
    assert (hits == 1).all()


def test_entries_and_constants_match_the_source():
    for entry in ("hg_row_gather", "hg_scaled_copy"):
        args = re.search(rf'extern "C" int {entry}\(([^)]*)\)', SOURCE).group(1).split(",")
        assert len(args) == len(_build.ENTRIES[entry]), entry
        for arg, t in zip(args, _build.ENTRIES[entry]):
            assert ("*" in arg) == (t is _build._PTR), (entry, arg)
    assert _constant("kThreads") == probes.ROW_DIRECT_WARPS * 32 == 256
    assert _constant("kDirectBlocks") == probes.ROW_DIRECT_BLOCKS
    assert _constant("kRowMaxWarps") == probes.ROW_MAX_WARPS
    assert _constant("kSmemBudget") == probes.RING_BUDGET
    assert "__launch_bounds__(kThreads, kDirectBlocks)" in SOURCE
    # test_scaled_copy_covers_every_element_once's grid and indexing
    assert "const long long blocks = (n / 4 + kThreads - 1) / kThreads;" in SOURCE
    assert "if (i < n - n4 * 4) out[n4 * 4 + i] = __fmul_rn(__ldg(x + n4 * 4 + i), s);" in SOURCE
    assert "cp_async_wait_upto(stages - 1);" in SOURCE  # emulate_ring's order
    # kernel_division's
    assert "const int inv = (65536 + p - 1) / p;" in SOURCE
    assert "const int dj = p > 32 ? 0 : (32 * inv) >> 16, dq = 32 - dj * p;" in SOURCE
    assert "const int j0 = p > 32 ? 0 : (lane * inv) >> 16, q0 = lane - j0 * p;" in SOURCE
    assert "kMaxRingWarps" not in SOURCE and not hasattr(probes, "_WARPS_TARGET")


@pytest.fixture(scope="module")
def pallas_probe():
    """scripts/pallas_probe.py, loaded as it stands (its main() does not run)."""
    spec = importlib.util.spec_from_file_location("pallas_probe_k", REPO / "scripts" /
                                                  "pallas_probe.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("body", ["k1", "k2"])
def test_row_gather_is_the_scripts_kernel_body(pallas_probe, body):
    """K1 (jnp.take in the kernel) and K2 (a fori_loop of dynamic-slice row
    copies) in interpret mode, on the script's x [4096, 128] and idx [4096]."""
    m = pallas_probe
    want = np.asarray(pl.pallas_call(
        getattr(m, body), out_shape=jax.ShapeDtypeStruct((m.R, m.F), jnp.float32),
        interpret=True)(m.x, m.idx))
    x = torch.as_tensor(np.array(m.x))
    idx = torch.as_tensor(np.array(m.idx))
    for n_buf in DEPTHS:
        got = probes.row_gather(x, idx, n_buf).numpy()
        np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))
