"""Max first aggregation over an aligned stage: CUDA kernels, plain twins.

Port of ``hypergef_tpu/ops/aligned_max.py``. Two functions over the
aligned stages of :mod:`.aligned_band`, each with a hand-written CUDA
kernel (``csrc/aligned_max.cu``) and a plain PyTorch twin:

* the masked argmax (Pallas kernel ``_masked_argmax_kernel`` ``:44-95``,
  ``pallas_call`` in ``_masked_argmax_call`` ``:107``, with the slot → id map
  and the band/spill ``_combine`` ``:128-150``; entry
  ``aligned_max_with_arg`` ``:188-244``): for every segment s and feature f,
  ``val[s, f]`` is the max of ``x[v, f]`` over the live sources v of s (a
  non-zero band or spill count) and ``arg[s, f]`` the lowest v reaching it;
  a segment with no live source gives 0 and -1. x f32 [N, F] → (val f32
  [S, F], arg int32 [S, F]); the values are compared as they are, in f32.
  Inputs are taken as finite and above -3e38, JAX's sentinel.
* the masked arg-sum (``_masked_argsum_kernel`` ``:247-276``,
  ``pallas_call`` in ``_masked_argsum_call`` ``:285``, entry
  ``_argsum_apply`` ``:303-346``): over the TRANSPOSE stage (rows r are the
  forward's sources), ``dx[r, f] = Σ g[e, f]`` over the live sources e of r
  with ``arg[e, f] == r``.

:func:`aligned_masked_argmax` and :func:`aligned_masked_argsum` launch the
kernels on CUDA tensors, once a stage apply, with the stage's
:class:`~.aligned_band.BandTable` (a plan of a ``pallas_*`` form) and its
:class:`LiveLayout`, or raise; they never fall back. The kernels read the
layout (each group's live slots, listed chunk by chunk; :func:`live_layout`,
host NumPy), not the flat band and spill tables. ``BandTable.build`` lays
it out when a plan is put on a CUDA device; a table without one raises,
naming that builder. On CPU tensors they run the twins. The twins
(:func:`aligned_max_plain`, :func:`aligned_argsum_plain`) take the stage's
live (segment, source) pairs from its band and spill tables and reduce over
them with ``scatter_reduce``, so no [groups, G, W, F] intermediate is made.
``argmax_launches`` and ``argsum_launches`` count the kernels' launches.

The autograd ops: :func:`v2e_max_aligned` (``:371-394``), whose backward is
the record-routed CSR segment sum (:func:`.segment_sum.record_routed_dx`,
the masked segment-sum kernel on the card), and
:func:`aligned_max_matvec` (``:349-368``), whose backward is the arg-sum over
a uniform transpose stage (any other stage type raises ``TypeError``, as in
JAX, ``:311-313``).
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import time

import numpy as np
import torch

from hypergef_tpu_torch.ops.aligned_band import check_operand, kernel_table, raise_on_error
from hypergef_tpu_torch.ops.maxops import NEG
from hypergef_tpu_torch.ops.segment_sum import SegmentTable, record_routed_dx
from hypergef_tpu_torch.sparse.planner import AlignedStageBDev, AlignedStageDev

argmax_launches = 0
argsum_launches = 0

_INT32_MAX = 2**31 - 1
# the kernels' layout (kChunk, kChunkLive, kRowsPerCta, kStagesMax and
# kStagesSum in csrc/aligned_max.cu, checked against the built kernels
# before their first launch)
CHUNK = 128  # source slots a chunk spans at most: the x rows a ring stage holds
CHUNK_LIVE = 2048  # live (row, slot) entries a chunk lists at most
ROWS_PER_CTA = 128  # rows of a group a work item (a CTA at a time) owns
RING = (3, 2)  # ring stages of the argmax kernel and of the arg-sum kernel
_ROW_ALIGN, _SLOT_ALIGN = 4, 8  # row_ptr and slots are read in 16-byte pieces


@dataclasses.dataclass(frozen=True)
class LiveLayout:
    """Each group's live slots of an aligned stage, the list the two
    kernels walk in place of the flat band and spill tables.

    A group's slots (window slots ``k·B + j``, then spill slots) are cut
    into chunks of at most ``CHUNK`` consecutive slots of one window block
    or of the spill, and at most ``CHUNK_LIVE`` live entries; a chunk is
    trimmed to its first and last live slot, and a chunk with none is left
    out. For each (chunk, row of the group) the live slots are listed in
    ascending order as offsets within the chunk. Sources at or past N
    (window padding, the spill zero row) and rows past S are never listed.
    A work item is ``ROWS_PER_CTA`` rows of a group with the group's
    chunks; ``items`` lists them costliest first, so the kernels' CTAs,
    each taking items in turn, end together.
    """

    # int32 [n_chunks, 4]: first source (window: a row of x; spill: an offset
    # into BandTable.src), rows the chunk spans, 1 for a spill chunk, and the
    # group's slot of its first row
    chunks: torch.Tensor
    group_chunks: torch.Tensor  # int32 [n_groups + 1]: group g's chunks, in slot order
    # int32 [n_chunks·G + 1, padded]: the list of (chunk i, row r) is
    # slots[row_ptr[i·G + r] : row_ptr[i·G + r + 1]]
    row_ptr: torch.Tensor
    slots: torch.Tensor  # uint16 [live, padded]: offsets within the chunk
    # int32 [n_groups·ceil(G / ROWS_PER_CTA)]: the work items (group ·
    # row CTAs + row CTA), by falling cost (chunks, then listed entries)
    items: torch.Tensor
    build_s: float = 0.0  # host seconds to lay it out

    def nbytes(self) -> int:
        return sum(t.numel() * t.element_size()
                   for t in (self.chunks, self.group_chunks, self.row_ptr, self.slots, self.items))

    def check(self, table) -> None:
        """Raise unless the layout fits ``table`` and the kernels' shared
        memory: every chunk within x or the spill sources, at most CHUNK
        rows and CHUNK_LIVE entries, every offset inside its chunk."""
        kinds = (("chunks", torch.int32), ("group_chunks", torch.int32),
                 ("row_ptr", torch.int32), ("slots", torch.uint16), ("items", torch.int32))
        for name, dtype in kinds:
            t = getattr(self, name)
            if t.dtype != dtype or t.device != table.device or not t.is_contiguous():
                raise ValueError(f"live.{name} must be contiguous {dtype} on {table.device}")
        c = self.chunks.cpu().numpy().astype(np.int64)
        gc = self.group_chunks.cpu().numpy().astype(np.int64)
        rp = self.row_ptr.cpu().numpy().astype(np.int64)
        n_chunks, g_rows = len(c), table.group_rows
        if c.shape != (n_chunks, 4) or gc.shape != (table.num_groups + 1,):
            raise ValueError("live.chunks must be [n, 4] and live.group_chunks [groups + 1]")
        if gc[0] != 0 or gc[-1] != n_chunks or (np.diff(gc) < 0).any():
            raise ValueError("live.group_chunks must rise from 0 to the chunk count")
        first, rows, spill = c[:, 0], c[:, 1], c[:, 2]
        end = np.where(spill == 1, table.src.numel(), table.num_inputs)
        if n_chunks and ((rows < 1).any() or (rows > CHUNK).any() or (first < 0).any()
                         or ((spill != 0) & (spill != 1)).any() or (first + rows > end).any()):
            raise ValueError(f"a live chunk spans past its sources or more than {CHUNK} rows")
        n_ptr = n_chunks * g_rows + 1
        if (len(rp) < _round_up(n_ptr, _ROW_ALIGN) or rp[0] != 0
                or (np.diff(rp[:n_ptr]) < 0).any()):
            raise ValueError("live.row_ptr must rise from 0, one pointer a chunk and row")
        if _round_up(int(rp[n_ptr - 1]), _SLOT_ALIGN) > self.slots.numel():
            raise ValueError("live.row_ptr reaches past the slots")
        per_chunk = np.diff(rp[0:n_ptr:g_rows])
        if (per_chunk > CHUNK_LIVE).any():
            raise ValueError(f"a live chunk lists more than {CHUNK_LIVE} entries")
        offs = self.slots[:rp[n_ptr - 1]].cpu().numpy().astype(np.int64)
        if (offs >= np.repeat(rows, per_chunk)).any():
            raise ValueError("a live offset lies past its chunk")
        n_items = table.num_groups * -(-g_rows // ROWS_PER_CTA)
        if not np.array_equal(np.sort(self.items.cpu().numpy()), np.arange(n_items)):
            raise ValueError(f"live.items must list the {n_items} work items once each")


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def _cut(live, width, base, first, out):
    """Append the chunks of slot columns ``live`` (bool [rows, width], the
    rows of one group that are segments) to ``out``: pieces of at most
    CHUNK columns and CHUNK_LIVE entries, each trimmed to its live columns.
    ``base`` is the group's slot of column 0, ``first`` its source."""
    cols = live.sum(axis=0)
    j = 0
    while j < width:
        end = min(j + CHUNK, width)
        cum = np.cumsum(cols[j:end])
        if cum[-1] > CHUNK_LIVE:  # at least one column, which holds at most G entries
            end = j + max(1, int(np.searchsorted(cum, CHUNK_LIVE, side="right")))
        nz = np.flatnonzero(cols[j:end])
        if len(nz):
            lo, hi = j + nz[0], j + nz[-1] + 1
            r, off = np.nonzero(live[:, lo:hi])  # by row, then slot
            out.append((first + lo, hi - lo, base + lo, r, off))
        j = end


def live_layout(table) -> LiveLayout:
    """The :class:`LiveLayout` of a :class:`~.aligned_band.BandTable`, read
    from its directory and flat tables on the host, put on its device."""
    t0 = time.perf_counter()
    g_rows, b_rows, n, s = table.group_rows, table.block_rows, table.num_inputs, table.num_segments
    if g_rows > CHUNK_LIVE:
        raise ValueError(f"groups of more than {CHUNK_LIVE} rows are not laid out")
    d = table.groups.cpu().numpy()
    band, spill = table.band.cpu().numpy(), table.spill.cpu().numpy()
    win, src = table.win.cpu().numpy().astype(np.int64), table.src.cpu().numpy()
    chunks, rows_of, offs, group_chunks = [], [], [], [0]
    for g, (bo, wo, w, so, ro, sw) in enumerate(d.tolist()):
        rows = min(g_rows, s - g * g_rows)  # the group's rows that are segments
        pieces = []
        if rows > 0:
            tab = band[bo:bo + g_rows * w * b_rows].reshape(g_rows, w * b_rows)[:rows]
            for k in range(w):
                r0 = int(win[wo + k]) * b_rows
                valid = min(b_rows, n - r0)  # window slots past N are padding
                if valid > 0:
                    _cut(tab[:, k * b_rows:k * b_rows + valid] != 0, valid, k * b_rows, r0,
                         pieces)
            if sw:
                sp = (spill[so:so + g_rows * sw].reshape(g_rows, sw)[:rows] != 0) & (
                    src[ro:ro + sw] < n)[None, :]
                _cut(sp, sw, w * b_rows, ro, pieces)
        for first, span, slot, r, off in pieces:
            chunks.append((first, span, int(slot >= w * b_rows), slot))
            rows_of.append(np.bincount(r, minlength=g_rows))
            offs.append(off)
        group_chunks.append(len(chunks))
    counts = np.concatenate(rows_of) if rows_of else np.zeros(0, np.int64)
    # padded so the kernels' 16-byte reads past the last pointer and entry
    # stay inside
    row_ptr = np.zeros(_round_up(len(counts) + 1, _ROW_ALIGN), np.int64)
    np.cumsum(counts, out=row_ptr[1:len(counts) + 1])
    row_ptr[len(counts) + 1:] = row_ptr[len(counts)]
    live = int(row_ptr[len(counts)])
    slots = np.zeros(_round_up(live, _SLOT_ALIGN), np.uint16)
    if offs:
        slots[:live] = np.concatenate(offs)
    # work items: each group's CTAs of rows, costliest first
    row_ctas = -(-g_rows // ROWS_PER_CTA)
    n_chunks = np.diff(group_chunks)
    entries = np.zeros((len(d), row_ctas), np.int64)
    per_row = counts.reshape(-1, g_rows)
    for g in range(len(d)):
        rows_g = per_row[group_chunks[g]:group_chunks[g + 1]].sum(axis=0)
        entries[g] = np.add.reduceat(rows_g, np.arange(0, g_rows, ROWS_PER_CTA))
    cost = np.repeat(n_chunks, row_ctas), entries.reshape(-1)
    items = np.lexsort((-cost[1], -cost[0]))
    if live > _INT32_MAX - _SLOT_ALIGN:
        raise ValueError(f"{live} live entries do not fit int32 pointers")
    dev = table.device

    def put(a, dtype=np.int32):
        return torch.as_tensor(np.ascontiguousarray(a, dtype=dtype), device=dev)

    return LiveLayout(chunks=put(np.asarray(chunks, np.int64).reshape(-1, 4)),
                      group_chunks=put(group_chunks), row_ptr=put(row_ptr),
                      slots=put(slots, np.uint16), items=put(items),
                      build_s=time.perf_counter() - t0)


def _window_pairs(b_dense, win_block, groups, block_rows):
    """Live (group, row, source) of band tables [m, G, W] whose table i
    belongs to group ``groups[i]``; sources are window slots."""
    i, r, w = (b_dense != 0).nonzero(as_tuple=True)
    src = win_block[i, w // block_rows] * block_rows + w % block_rows
    return groups[i], r, src


def _spill_pairs(b_spill, spill_src, groups):
    i, r, j = (b_spill != 0).nonzero(as_tuple=True)
    return groups[i], r, spill_src[i, j]


def _inverse(slot, n_slots):
    """The group of each slot of a slot map (-1 where no group maps)."""
    inv = torch.full((n_slots + 1,), -1, dtype=torch.int64, device=slot.device)
    inv[slot] = torch.arange(len(slot), device=slot.device)
    return inv[:n_slots]


def live_pairs(st):
    """(segment, source) int64 [P] of every live entry of an aligned stage,
    window then spill; sources at or past N (padding, the zero row) are
    left out."""
    g_rows = st.group_rows
    pieces = []
    if isinstance(st, AlignedStageDev):
        n_groups, wb = st.win_block.shape
        every = torch.arange(n_groups, device=st.b_dense.device)
        pieces.append(_window_pairs(st.b_dense, st.win_block, every,
                                    st.b_dense.shape[2] // max(wb, 1)))
        if st.spill_src.shape[1]:
            pieces.append(_spill_pairs(st.b_spill, st.spill_src, every))
    elif isinstance(st, AlignedStageBDev):
        n_groups = len(st.base_slot)
        group_of = _inverse(st.base_slot, n_groups)
        off = 0
        for bk in st.buckets:
            m = bk.b_dense.shape[0]
            pieces.append(_window_pairs(bk.b_dense, bk.win_block, group_of[off:off + m],
                                        st.block_rows))
            off += m
        m_total = sum(sp.b_spill.shape[0] for sp in st.spills)
        spill_of = _inverse(st.spill_slot.clamp(max=m_total), m_total)
        off = 0
        for sp in st.spills:
            m = sp.b_spill.shape[0]
            pieces.append(_spill_pairs(sp.b_spill, sp.spill_src, spill_of[off:off + m]))
            off += m
    else:
        raise TypeError(f"an aligned stage is needed, got {type(st).__name__}")
    seg = torch.cat([g * g_rows + r for g, r, _ in pieces])
    src = torch.cat([s for _, _, s in pieces])
    keep = (src < st.num_inputs) & (seg < st.num_segments)
    return seg[keep], src[keep]


def aligned_max_plain(x, st):
    """The plain twin of the masked argmax: (val f32 [S, F], arg int32
    [S, F]). ``amax`` and ``amin`` do not depend on the order of the pairs."""
    seg, src = live_pairs(st)
    s, f = st.num_segments, x.shape[1]
    vals = x.index_select(0, src)  # [P, F]
    idx = seg[:, None].expand(-1, f)
    best = x.new_full((s, f), NEG).scatter_reduce(0, idx, vals, "amax")
    hit = vals == best.index_select(0, seg)
    ids = torch.where(hit, src[:, None], _INT32_MAX)
    arg = torch.full((s, f), _INT32_MAX, dtype=torch.int64, device=x.device)
    arg = arg.scatter_reduce(0, idx, ids, "amin")
    alive = arg != _INT32_MAX
    return torch.where(alive, best, 0.0), torch.where(alive, arg, -1).to(torch.int32)


def aligned_argsum_plain(g, arg, st):
    """The plain twin of the masked arg-sum over the transpose stage ``st``:
    ``dx[r, f] = Σ g[e, f]·[arg[e, f] == r]`` over its live pairs (r, e)."""
    rows, src = live_pairs(st)
    hit = arg.index_select(0, src) == rows[:, None]
    contrib = torch.where(hit, g.index_select(0, src), 0.0)
    return g.new_zeros((st.num_segments, g.shape[1])).index_add_(0, rows, contrib)


def check_layout(lib) -> None:
    """Raise unless ``lib``'s max kernels read the layout this module builds."""
    got = (ctypes.c_int * 5)()
    lib.hg_aligned_max_layout(got)
    want = (CHUNK, CHUNK_LIVE, ROWS_PER_CTA) + RING
    if tuple(got) != want:
        raise RuntimeError(f"the max kernels take (chunk, chunk live, rows a CTA, rings) = "
                           f"{tuple(got)}, the wrapper lays out {want}")


@functools.lru_cache(maxsize=None)
def _library():
    from hypergef_tpu_torch.ops import _build

    lib = _build.load_library()
    check_layout(lib)
    return lib


def _live(table):
    """The live layout of a stage's kernel table, or raise."""
    if table.live is None:
        raise ValueError("the stage's table holds no live layout: BandTable.build lays it out "
                         "on a CUDA device (BandTable.with_kernel_layout)")
    return table.live


def aligned_masked_argmax(x, st):
    """(val, arg) of the masked argmax over stage ``st``: one kernel launch
    on a CUDA ``x`` (a ``pallas_*``-form stage), the twin on a CPU one."""
    global argmax_launches
    if x.device.type == "cpu":
        if st.counts.device.type != "cpu":
            raise ValueError(f"x is on the CPU but the stage is on {st.counts.device}")
        return aligned_max_plain(x, st)
    table = kernel_table(st, x.device)
    check_operand(x, torch.float32, table, "x")
    live = _live(table)
    f = x.shape[1]
    lib = _library()
    val = torch.empty((table.num_segments, f), dtype=torch.float32, device=x.device)
    arg = torch.empty((table.num_segments, f), dtype=torch.int32, device=x.device)
    with torch.cuda.device(x.device):
        err = lib.hg_aligned_masked_argmax(
            x.data_ptr(), live.chunks.data_ptr(), live.group_chunks.data_ptr(),
            live.row_ptr.data_ptr(), live.slots.data_ptr(), live.items.data_ptr(),
            table.src.data_ptr(), val.data_ptr(), arg.data_ptr(), table.num_groups, table.group_rows,
            table.num_inputs, table.num_segments, f,
            torch.cuda.current_stream(x.device).cuda_stream)
    raise_on_error(err, lib, "aligned_masked_argmax")
    argmax_launches += 1
    return val, arg


def aligned_masked_argsum(g, arg, st):
    """dx of the masked arg-sum over the transpose stage ``st``: one kernel
    launch on CUDA tensors (a ``pallas_*``-form stage), the twin on CPU ones."""
    global argsum_launches
    if g.device.type == "cpu":
        if st.counts.device.type != "cpu":
            raise ValueError(f"g is on the CPU but the stage is on {st.counts.device}")
        return aligned_argsum_plain(g, arg, st)
    table = kernel_table(st, g.device)
    check_operand(g, torch.float32, table, "g")
    check_operand(arg, torch.int32, table, "arg")
    if arg.shape != g.shape:
        raise TypeError(f"arg {tuple(arg.shape)} and g {tuple(g.shape)} differ")
    live = _live(table)
    f = g.shape[1]
    lib = _library()
    out = torch.empty((table.num_segments, f), dtype=torch.float32, device=g.device)
    with torch.cuda.device(g.device):
        err = lib.hg_aligned_masked_argsum(
            g.data_ptr(), arg.data_ptr(), live.chunks.data_ptr(), live.group_chunks.data_ptr(),
            live.row_ptr.data_ptr(), live.slots.data_ptr(), live.items.data_ptr(),
            table.src.data_ptr(), out.data_ptr(), table.num_groups, table.group_rows, table.num_inputs,
            table.num_segments, f, torch.cuda.current_stream(g.device).cuda_stream)
    raise_on_error(err, lib, "aligned_masked_argsum")
    argsum_launches += 1
    return out


def aligned_max_with_arg(x, st):
    """(y [S, F], arg [S, F] int32) over an aligned stage, record-table
    semantics (``:188-244``): the kernel for a stage of a ``pallas_*``-form
    plan, the plain twin for an ``xla``-form one."""
    if st.band is not None:
        return aligned_masked_argmax(x.contiguous(), st)
    return aligned_max_plain(x, st)


def aligned_argsum(g, arg, st):
    """``_argsum_apply`` (``:303-346``): the record-routed cotangents over a
    uniform transpose stage."""
    if not isinstance(st, AlignedStageDev):
        raise TypeError("aligned max transpose backward needs a uniform "
                        "AlignedStageDev (halo interiors)")
    if st.band is not None:
        return aligned_masked_argsum(g.contiguous(), arg, st)
    return aligned_argsum_plain(g, arg, st)


class _V2EMaxAligned(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, e_stage, e2v):
        y, arg = aligned_max_with_arg(x, e_stage)
        ctx.save_for_backward(arg)
        ctx.e2v = e2v
        return y

    @staticmethod
    def backward(ctx, g):
        (arg,) = ctx.saved_tensors
        return record_routed_dx(g.contiguous(), arg, ctx.e2v), None, None


def v2e_max_aligned(x, e_stage, e2v: SegmentTable):
    """``y[e, f] = max_{v ∈ e} x[v, f]`` over an aligned edge stage, with the
    record-table backward over the vertex-major CSR ``e2v``
    (``HypergraphData.e2v``), as :func:`.maxops.v2e_max_tree`."""
    return _V2EMaxAligned.apply(x, e_stage, e2v)


class _AlignedMaxMatvec(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, fwd_stage, bwd_stage):
        y, arg = aligned_max_with_arg(x, fwd_stage)
        ctx.save_for_backward(arg)
        ctx.bwd_stage = bwd_stage
        return y

    @staticmethod
    def backward(ctx, g):
        (arg,) = ctx.saved_tensors
        return aligned_argsum(g, arg, ctx.bwd_stage), None, None


def aligned_max_matvec(x, fwd_stage, bwd_stage):
    """``y[s, f] = max`` over the forward aligned stage, with the exact
    record-routed backward over the TRANSPOSE stage ``bwd_stage`` (a uniform
    :class:`AlignedStageDev`): no CSR arrays needed."""
    return _AlignedMaxMatvec.apply(x, fwd_stage, bwd_stage)
