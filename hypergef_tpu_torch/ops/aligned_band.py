"""The aligned stage apply: CUDA band kernel and its plain twins.

Counterpart of ``hypergef_tpu/ops/aligned_pallas.py`` (Pallas kernel
``_band_kernel`` ``:40-78``, ``pallas_call`` in ``_band_bucket_call``
``:126``, entry ``apply_aligned_b_pallas`` ``:145-206``) and of the XLA forms
it replaces, ``hypergef_tpu/ops/tree.py::_apply_aligned_b`` (``:413-460``)
and ``::_apply_aligned`` (``:376-400``). One function: for every output
group g of G segments,

    out[g] = Σ_k band_g[:, kB:(k+1)B] @ bf16(x[win_block[g, k]])
             + b_spill[g] @ bf16(x[spill_src[g]])

with int8 counts, x f32 [N, F] rounded to bf16, exact products and f32
sums, in two forms:

* :func:`aligned_band` runs the hand-written CUDA kernel
  (``csrc/aligned_band.cu``) on a CUDA tensor and the plain twin on a CPU
  tensor. On a CUDA tensor it launches the kernel, once for the whole
  stage, or raises; it never falls back.
* :func:`apply_aligned_b_plain` (bucketed stages) and
  :func:`apply_aligned_plain` (uniform stages) are the JAX package's XLA
  chains in plain torch: block gather, an f32 ``bmm`` of the counts and the
  bf16-rounded rows (the rule of ``fused_dense.dense_dot``: never a bf16
  ``bmm``, which would round its output), spill gather and ``bmm``, slot
  assembly.

A :class:`BandTable` holds one stage's kernel tables on one device, built
and checked once when a plan is put on the device, so a call checks only
``x``. ``launches`` counts the kernel's launches.

The band kernel streams each group's band and spill tables as tiles: a
tile is one slab of ``SLAB`` band columns for all G rows of the group,
``[G, SLAB]`` int8, contiguous, so one bulk copy brings it into shared
memory. :func:`band_tiles` lays them out from the flat tables, only for a
table on a CUDA device (:meth:`BandTable.with_kernel_layout`), beside the
max kernels' list of each group's live slots
(:func:`.aligned_max.live_layout`). No kernel on the card reads the flat
tables; the plain twins do.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
from typing import TYPE_CHECKING, Optional

import numpy as np
import torch

from hypergef_tpu_torch.ops.fused_dense import bf16_round

if TYPE_CHECKING:
    from hypergef_tpu_torch.ops.aligned_max import LiveLayout

launches = 0

_INT32_MAX = 2**31 - 1
# columns of BandTable.groups, one row per output group
_BAND_OFF, _WIN_OFF, _WIDTH, _SPILL_OFF, _SRC_OFF, _SW = range(6)
# the kernel's layout (kSlab, kRowsPerCta, kCtasPerSm in csrc/aligned_band.cu,
# checked against the built kernel before its first launch)
SLAB = 64  # band columns a tile holds: the kernel's slab of source rows
ROWS_PER_CTA = 128  # rows of a group one CTA of the kernel sums
CTAS_PER_SM = 2  # the kernel's CTAs an SM holds at once (its launch bounds)
_CHUNK = 16  # bytes of a tile row that move together (one shared-memory word quad)


def _swizzle(t):
    """Tiles [..., G, SLAB] with the 16-byte chunks of row r stored in the
    order c ^ ((r >> 1) & 3): the kernel's fragment loads of 8 rows then hit
    32 banks (the same map undoes it)."""
    g_rows = t.shape[-2]
    r = torch.arange(g_rows, device=t.device)
    perm = torch.arange(SLAB // _CHUNK, device=t.device)[None, :] ^ ((r[:, None] >> 1) & 3)
    chunks = t.reshape(*t.shape[:-1], SLAB // _CHUNK, _CHUNK)
    idx = perm.view(*([1] * (t.dim() - 2)), g_rows, SLAB // _CHUNK, 1)
    return torch.take_along_dim(chunks, idx, dim=-2).reshape(t.shape)


def band_tiles(band, spill, groups, group_rows, block_rows):
    """The kernel's tiles of a stage, read from its flat tables through its
    directory ``groups`` (int64 [n_groups, 6], on the host), and their own
    directory: int8 tiles, and int64 [n_groups, 2], the offset of each
    group's first window tile and of its first spill tile. A group's window
    tiles are its blocks cut into slabs of ``SLAB`` columns (a block of B
    rows is ceil(B / SLAB) tiles, zeros past B), its spill tiles its spill
    slots in slabs (zeros past sw); each tile [G, SLAB] row-major, swizzled
    (:func:`_swizzle`). The groups of one width are laid out together."""
    d = np.asarray(groups)
    g_rows, spb = group_rows, -(-block_rows // SLAB)
    tile = g_rows * SLAB
    offs = np.zeros((len(d), 2), np.int64)
    parts, off = [], 0
    for kind, flat, col_off, col_w in ((0, band, _BAND_OFF, _WIDTH), (1, spill, _SPILL_OFF, _SW)):
        for cols in np.unique(d[:, col_w][d[:, col_w] > 0]).tolist():
            gids = np.flatnonzero(d[:, col_w] == cols)
            row = cols * block_rows if kind == 0 else cols  # a group row's bytes in `flat`
            starts = torch.as_tensor(d[gids, col_off], device=flat.device)
            t = flat[starts[:, None] + torch.arange(g_rows * row, device=flat.device)[None, :]]
            if kind == 0:  # cols = window blocks
                t = torch.nn.functional.pad(t.view(len(gids), g_rows, cols, block_rows),
                                            (0, spb * SLAB - block_rows))
                slabs = cols * spb
            else:  # cols = spill slots
                slabs = -(-cols // SLAB)
                t = torch.nn.functional.pad(t.view(len(gids), g_rows, cols),
                                            (0, slabs * SLAB - cols))
            t = t.reshape(len(gids), g_rows, slabs, SLAB).permute(0, 2, 1, 3)
            parts.append(_swizzle(t).reshape(-1))
            offs[gids, kind] = off + np.arange(len(gids)) * slabs * tile
            off += len(gids) * slabs * tile
    tiles = torch.cat(parts) if parts else band.new_zeros(0)
    return tiles, torch.as_tensor(offs, device=band.device)


def band_work(width, sw, block_rows, group_rows, ctas=None):
    """The band kernel's work items, one a CTA (times the group's row CTAs),
    the longest first: int32 [items, 4] of (group, first slab, end slab,
    slot), and the number of slots. A group of more than 1.5x the median
    slab count is cut into two items that share a slot: each writes its
    partial sums to the slot's scratch and the second to finish adds the
    two, first half first; slot -1 is a whole group. The stage then ends
    with its typical groups, not with its widest ones. Only while every
    item's CTAs fit on the card at once (``ctas``: SMs times
    ``CTAS_PER_SM``; None: no limit) are groups cut, the widest first: in a
    stage of more CTAs the next wave takes up the slack, and a cut would
    only add CTAs to it."""
    slabs = np.asarray(width) * -(-block_rows // SLAB) + -(-np.asarray(sw) // SLAB)
    limit = max(2, int(np.ceil(1.5 * np.median(slabs)))) if len(slabs) else 0
    row_ctas = -(-group_rows // ROWS_PER_CTA)
    cuts = int((slabs > limit).sum())
    if ctas is not None:
        cuts = max(0, min(cuts, ctas // row_ctas - len(slabs)))
    cut = set(np.argsort(-slabs, kind="stable")[:cuts].tolist())
    items, slot = [], 0
    for g, k in enumerate(slabs.tolist()):
        if g in cut:
            mid = (k + 1) // 2
            items += [(g, 0, mid, slot), (g, mid, k, slot)]
            slot += 1
        else:
            items.append((g, 0, k, -1))
    items = np.asarray(items, np.int32).reshape(-1, 4)
    return items[np.argsort(items[:, 1] - items[:, 2], kind="stable")], slot


@dataclasses.dataclass(frozen=True)
class BandTable:
    """One aligned stage's tables for the band kernel, on one device.

    The band tables of every width bucket lie in one flat int8 array (the
    plain form's per-bucket tables are views of it), the spill tables in
    another; ``groups`` is the per-group directory into them: band offset,
    window offset, width in blocks, spill offset, spill-source offset and
    spill width (0: the group does not spill).
    """

    band: torch.Tensor  # int8 [*]: [G, width·block_rows] per group, row-major
    win: torch.Tensor  # int32 [*]: width source block ids per group
    spill: torch.Tensor  # int8 [*]: [G, sw] per spilling group, row-major
    src: torch.Tensor  # int32 [*]: sw source rows per spilling group (N = zero row)
    groups: torch.Tensor  # int64 [n_groups, 6], the directory
    num_inputs: int  # N, the rows of x
    num_segments: int  # S, the rows of the output
    group_rows: int  # G
    block_rows: int  # B
    # the band kernel's tiles (:func:`band_tiles`) and their directory,
    # int64 [n_groups, 2], its work items (:func:`band_work`) and their
    # count of split groups; None (and 0) in a table on the CPU, which no
    # kernel reads
    tiles: Optional[torch.Tensor] = None
    tile_off: Optional[torch.Tensor] = None
    work: Optional[torch.Tensor] = None
    slots: int = 0
    # the max kernels' list of each group's live slots
    # (:func:`.aligned_max.live_layout`); None in a table on the CPU
    live: Optional["LiveLayout"] = None

    @classmethod
    def build(cls, band, spill, windows, sources, num_inputs, num_segments, group_rows,
              block_rows) -> "BandTable":
        """Directory and int32 index tables for flat ``band``/``spill``
        tables on a device, and on a CUDA device the kernels' layouts.
        ``windows`` lists (win_block [ng_b, w] int32, group ids) per band
        bucket and ``sources`` (spill_src [m_b, sw] int32, group ids) per
        spill bucket, in the order of the flat tables."""
        n_groups = max(-(-num_segments // group_rows), 1)
        d = np.zeros((n_groups, 6), np.int64)
        band_off = win_off = 0
        for win_block, gids in windows:
            ng, w = win_block.shape
            d[gids, _BAND_OFF] = band_off + np.arange(ng) * group_rows * w * block_rows
            d[gids, _WIN_OFF] = win_off + np.arange(ng) * w
            d[gids, _WIDTH] = w
            band_off += ng * group_rows * w * block_rows
            win_off += win_block.size
        spill_off = src_off = 0
        for spill_src, gids in sources:
            m, sw = spill_src.shape
            d[gids, _SPILL_OFF] = spill_off + np.arange(m) * group_rows * sw
            d[gids, _SRC_OFF] = src_off + np.arange(m) * sw
            d[gids, _SW] = sw
            spill_off += m * group_rows * sw
            src_off += spill_src.size

        def flat32(tables):
            a = (np.concatenate([t.reshape(-1) for t, _ in tables]) if tables
                 else np.zeros(0, np.int32))
            return torch.as_tensor(a.astype(np.int32), device=band.device)

        table = cls(band=band, win=flat32(windows), spill=spill, src=flat32(sources),
                    groups=torch.as_tensor(d, device=band.device), num_inputs=num_inputs,
                    num_segments=num_segments, group_rows=group_rows, block_rows=block_rows)
        if band.device.type != "cuda":
            return table
        return table.with_kernel_layout(
            torch.cuda.get_device_properties(band.device).multi_processor_count * CTAS_PER_SM)

    def with_kernel_layout(self, ctas=None) -> "BandTable":
        """This table with the band kernel's tiles and work items, for a card
        that holds ``ctas`` of its CTAs at once (None: no limit), and the
        max kernels' live layout."""
        from hypergef_tpu_torch.ops.aligned_max import live_layout

        d = self.groups.cpu().numpy()
        tiles, tile_off = band_tiles(self.band, self.spill, d, self.group_rows, self.block_rows)
        work, slots = band_work(d[:, _WIDTH], d[:, _SW], self.block_rows, self.group_rows, ctas)
        return dataclasses.replace(self, tiles=tiles, tile_off=tile_off,
                                   work=torch.as_tensor(work, device=self.device), slots=slots,
                                   live=live_layout(self))

    def __post_init__(self):
        kinds = (("band", torch.int8), ("win", torch.int32), ("spill", torch.int8),
                 ("src", torch.int32), ("groups", torch.int64))
        kernel = (self.tiles, self.tile_off, self.work)
        if any(t is None for t in kernel) != all(t is None for t in kernel):
            raise ValueError("tiles, tile_off and work come together")
        if self.tiles is not None:
            kinds += (("tiles", torch.int8), ("tile_off", torch.int64), ("work", torch.int32))
        for name, dtype in kinds:
            t = getattr(self, name)
            if t.dtype != dtype:
                raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
            if t.device != self.band.device:
                raise ValueError(f"{name} is on {t.device}, band on {self.band.device}")
            if not t.is_contiguous():
                raise ValueError(f"{name} must be contiguous")
        for name in ("band", "win", "spill", "src") + (("tiles",) if self.tiles is not None else ()):
            if getattr(self, name).dim() != 1:
                raise ValueError(f"{name} must be flat")
        g_rows, b_rows, n, s = self.group_rows, self.block_rows, self.num_inputs, self.num_segments
        n_groups = max(-(-s // g_rows), 1)
        if self.groups.shape != (n_groups, 6):
            raise ValueError(f"groups must be [{n_groups}, 6], got {tuple(self.groups.shape)}")
        if min(g_rows, b_rows) <= 0 or min(n, s) < 0 or max(n, n_groups * g_rows) > _INT32_MAX:
            raise ValueError(f"unsupported stage: G={g_rows}, B={b_rows}, N={n}, S={s}")
        d = self.groups.cpu()
        width, sw = d[:, _WIDTH], d[:, _SW]
        if int(width.min()) < 1 or int(sw.min()) < 0:
            raise ValueError("every group needs a window of at least one block")
        ends = (
            ("band", d[:, _BAND_OFF], g_rows * width * b_rows),
            ("win", d[:, _WIN_OFF], width),
            ("spill", d[:, _SPILL_OFF], g_rows * sw),
            ("src", d[:, _SRC_OFF], sw),
        )
        for name, off, size in ends:
            if int(off.min()) < 0 or int((off + size).max()) > getattr(self, name).numel():
                raise ValueError(f"the directory reaches past the {name} table")
        # windows may reach past the last block that holds rows of x (the
        # uniform form's nb = max(ceil(N/B), wb)): the kernel reads no row
        # past N, and those rows count as zeros
        blocks = max(-(-n // b_rows), int(width.max()))
        if self.win.numel() and (int(self.win.min()) < 0 or int(self.win.max()) >= blocks):
            raise ValueError(f"window block ids must lie in [0, {blocks})")
        if self.src.numel() and (int(self.src.min()) < 0 or int(self.src.max()) > n):
            raise ValueError(f"spill sources must lie in [0, {n}] ({n}: the zero row)")
        if self.tiles is not None:
            if self.tile_off.shape != (n_groups, 2):
                raise ValueError(f"tile_off must be [{n_groups}, 2]")
            t = self.tile_off.cpu()
            tile = g_rows * SLAB
            for off, slabs in ((t[:, 0], width * -(-b_rows // SLAB)), (t[:, 1], (sw + SLAB - 1) // SLAB)):
                live = slabs > 0
                if live.any() and (int(off[live].min()) < 0 or int(
                        (off + slabs * tile)[live].max()) > self.tiles.numel()):
                    raise ValueError("the tile directory reaches past the tiles")
            self._check_work(width * -(-b_rows // SLAB) + (sw + SLAB - 1) // SLAB)
        if self.live is not None:
            self.live.check(self)

    def _check_work(self, slabs) -> None:
        """Every slab of every group in exactly one work item; a slot's two
        items are the halves of one group; ``slots`` counts the slots."""
        w = self.work.cpu().numpy()
        if w.ndim != 2 or w.shape[1] != 4:
            raise ValueError("work must be int32 [items, 4]")
        g, first, end, slot = w.T.astype(np.int64)
        n_groups = len(slabs)
        if len(g) and (g.min() < 0 or g.max() >= n_groups or (first < 0).any() or
                       (end > slabs.numpy()[g]).any() or (first >= end).any()):
            raise ValueError("a work item lies outside its group's slabs")
        covered = np.zeros(n_groups, np.int64)
        np.add.at(covered, g, end - first)
        if not np.array_equal(covered, slabs.numpy()):
            raise ValueError("the work items must cover every slab of every group once")
        pairs = np.bincount(slot[slot >= 0], minlength=self.slots)
        if len(pairs) != self.slots or (pairs != 2).any():
            raise ValueError("a slot must hold the two halves of one group")

    @property
    def device(self) -> torch.device:
        return self.band.device

    @property
    def num_groups(self) -> int:
        return int(self.groups.shape[0])


def _blocks(x, num_blocks: int, block_rows: int):
    """bf16(x), zero-padded to ``num_blocks`` blocks: [num_blocks, B, F]."""
    n, f = x.shape
    xb = bf16_round(x)
    pad = num_blocks * block_rows - n
    if pad > 0:
        xb = torch.cat([xb, xb.new_zeros((pad, f))])
    return xb.reshape(num_blocks, block_rows, f)


def _with_zero_row(x):
    """bf16(x) with the zero row at index N that spill sources use."""
    return torch.cat([bf16_round(x), x.new_zeros((1, x.shape[1]))])


def _band_dot(table_i8, rows):
    """``table @ rows`` per group: the int8 counts and the bf16 values are
    exact in f32, so an f32 ``bmm`` gives exact products, f32 sums."""
    return torch.bmm(table_i8.to(torch.float32), rows)


def apply_aligned_b_plain(x, st):
    """Bucketed aligned apply (``hypergef_tpu/ops/tree.py:413-460``): one
    band product per width bucket, one per spill bucket, assembled by the
    slot maps (skipped where they are the identity)."""
    f = x.shape[1]
    blk = st.block_rows
    xb = _blocks(x, st.num_blocks, blk)
    outs = []
    for bk in st.buckets:
        ng_b, wb = bk.win_block.shape
        win = xb.index_select(0, bk.win_block.reshape(-1)).reshape(ng_b, wb * blk, f)
        outs.append(_band_dot(bk.b_dense, win))  # [ng_b, G, F]
    cat = torch.cat(outs) if len(outs) > 1 else outs[0]
    base = cat if st.base_identity else cat.index_select(0, st.base_slot)
    if st.spills:
        xz = _with_zero_row(x)
        souts = []
        for sp in st.spills:
            m_b, sw = sp.spill_src.shape
            rows = xz.index_select(0, sp.spill_src.reshape(-1)).reshape(m_b, sw, f)
            souts.append(_band_dot(sp.b_spill, rows))
        if st.spill_identity:
            base = base + souts[0]  # every group spills, one bucket, in order
        else:
            souts.append(x.new_zeros((1, st.group_rows, f)))
            base = base + torch.cat(souts).index_select(0, st.spill_slot)
    return base.reshape(-1, f)[: st.num_segments]


def apply_aligned_plain(x, st):
    """Uniform aligned apply (``hypergef_tpu/ops/tree.py:376-400``): one
    band product over every group's window plus one spill product."""
    f = x.shape[1]
    n_groups, wb = st.win_block.shape
    blk = st.b_dense.shape[2] // wb
    xb = _blocks(x, st.num_blocks, blk)
    win = xb.index_select(0, st.win_block.reshape(-1)).reshape(n_groups, wb * blk, f)
    out = _band_dot(st.b_dense, win)  # [n_groups, G, F]
    spill_w = st.spill_src.shape[1]
    if spill_w:
        rows = _with_zero_row(x).index_select(0, st.spill_src.reshape(-1))
        out = out + _band_dot(st.b_spill, rows.reshape(n_groups, spill_w, f))
    return out.reshape(n_groups * st.group_rows, f)[: st.num_segments]


def aligned_band_plain(x, st):
    """The plain twin of either stage form."""
    if hasattr(st, "buckets"):
        return apply_aligned_b_plain(x, st)
    return apply_aligned_plain(x, st)


def kernel_table(st, dev) -> BandTable:
    """The :class:`BandTable` of stage ``st`` for a kernel launch on
    ``dev``. Raises unless ``dev`` is a Hopper card and ``st`` holds kernel
    tables (a plan of a ``pallas_*`` form); every kernel that walks an
    aligned stage (this module's and :mod:`.aligned_max`'s) reads it."""
    if dev.type != "cuda":
        raise ValueError(f"the CUDA kernel takes CUDA tensors, got {dev}")
    if st.band is None:
        raise ValueError(
            "the stage holds no kernel tables: it was put on the device in the plain "
            "form; use a plan of a pallas_* form (dataclasses.replace(plan, "
            "form='pallas_auto'))")
    if torch.cuda.get_device_capability(dev) != (9, 0):
        raise RuntimeError(
            f"the kernel is built for sm_90a (Hopper); {torch.cuda.get_device_name(dev)} "
            f"is sm_{''.join(map(str, torch.cuda.get_device_capability(dev)))}"
        )
    return st.band


def check_operand(t, dtype, table: BandTable, name: str) -> None:
    """``t`` must be a contiguous ``dtype`` [N, F] beside ``table``, N the
    stage's inputs."""
    n = table.num_inputs
    if t.dtype != dtype or t.dim() != 2 or t.shape[0] != n:
        raise TypeError(f"{name} must be {dtype} [{n}, F], got {t.dtype} {tuple(t.shape)}")
    if t.device != table.device:
        raise ValueError(f"the table is on {table.device}, {name} on {t.device}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if t.shape[1] <= 0 or t.shape[1] > _INT32_MAX:
        raise ValueError(f"unsupported width F={t.shape[1]}")


def raise_on_error(err: int, lib, kernel: str) -> None:
    """Raise on a non-zero ``cudaError_t`` returned by a launch entry."""
    if err != 0:
        raise RuntimeError(f"{kernel} launch failed: {lib.hg_error_string(err).decode()}")


def check_layout(lib) -> None:
    """Raise unless ``lib``'s band kernel reads the layout this module builds."""
    got = (ctypes.c_int * 3)()
    lib.hg_aligned_band_layout(got)
    if tuple(got) != (SLAB, ROWS_PER_CTA, CTAS_PER_SM):
        raise RuntimeError(f"the band kernel takes (slab, rows a CTA, CTAs an SM) = {tuple(got)}, "
                           f"the wrapper lays out {(SLAB, ROWS_PER_CTA, CTAS_PER_SM)}")


@functools.lru_cache(maxsize=None)
def _library():
    from hypergef_tpu_torch.ops import _build

    lib = _build.load_library()
    check_layout(lib)
    return lib


def launch_band(lib, x, table: BandTable, work, slots: int):
    """One launch of ``lib``'s band kernel over the work items ``work`` (int32
    [items, 4] on the card, ``slots`` of them split groups) on the current
    stream: f32 [S, F]. The split groups' scratch and counters are this
    call's own, so calls on other streams never meet. No checks: callers
    check ``x`` and the table."""
    from hypergef_tpu_torch.ops import _build

    f = x.shape[1]
    out = torch.empty((table.num_segments, f), dtype=torch.float32, device=x.device)
    # a split group's two partial sums, [slot][half][G][F], and an arrival
    # counter a slot and CTA row (zeroed by the entry on the stream)
    scratch = torch.empty(slots * 2 * table.group_rows * f, dtype=torch.float32,
                          device=x.device)
    counters = torch.empty(slots * -(-table.group_rows // ROWS_PER_CTA), dtype=torch.int32,
                           device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.hg_aligned_band(
            x.data_ptr(), table.tiles.data_ptr(), table.tile_off.data_ptr(),
            table.win.data_ptr(), table.src.data_ptr(), table.groups.data_ptr(),
            work.data_ptr(), counters.data_ptr(), scratch.data_ptr(), out.data_ptr(),
            int(work.shape[0]), slots, table.group_rows, table.block_rows, table.num_inputs,
            table.num_segments, f, stream,
        )
    raise_on_error(err, _build.load_library(), "aligned_band")
    return out


def _launch(x, table: BandTable):
    global launches
    check_operand(x, torch.float32, table, "x")
    if table.tiles is None:
        raise ValueError("the table holds no band tiles: build it on a CUDA device")
    out = launch_band(_library(), x, table, table.work, table.slots)
    launches += 1
    return out


def aligned_band(x, st):
    """One aligned stage applied to x f32 [N, F]: f32 [S, F].

    ``st`` is a device stage of an aligned plan
    (``planner.AlignedStageBDev`` or ``planner.AlignedStageDev``). On CUDA
    tensors this launches the kernel once, with the stage's
    :class:`BandTable` (a plan of a ``pallas_*`` form); on CPU tensors it
    runs :func:`aligned_band_plain`. It carries no autograd rule of its own,
    so it refuses an ``x`` that requires grad: the tree op's backward
    applies the transposed stage (:mod:`hypergef_tpu_torch.ops.tree`).
    """
    if x.requires_grad and torch.is_grad_enabled():
        raise RuntimeError(
            "aligned_band has no autograd rule: differentiate through "
            "ops.tree.tree_matvec, whose backward is the transposed stage")
    if x.device.type == "cpu":
        if st.counts.device.type != "cpu":
            raise ValueError(f"x is on the CPU but the stage is on {st.counts.device}")
        return aligned_band_plain(x, st)
    return _launch(x, kernel_table(st, x.device))
