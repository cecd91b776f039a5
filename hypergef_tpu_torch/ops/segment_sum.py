"""Gather + sorted segment sum over a CSR: CUDA kernel, plain twins.

The kernel of the ``cumsum`` route. One function,

    out[s, :] = Σ_{k ∈ [indptr[s], indptr[s+1])} x[gather[k], :]

(without ``gather``, the row is k itself), with x f32 [N, F] and int32
tables, in two forms:

* :func:`gather_segment_sum` runs the hand-written CUDA kernel
  (``csrc/segment_sum.cu``) on a CUDA tensor and the plain version on a
  CPU tensor. On a CUDA tensor it launches the kernel or raises; it never
  falls back.
* :func:`gather_segment_sum_plain` is ``index_select`` and the direct
  sorted segment sum of :mod:`.segments`.

The kernel replaces the Pallas one-hot segment sums of the probe scripts
(``scripts/pallas_probe.py:98``, ``pallas_probe2.py:184``,
``pallas_probe3.py:108``) and computes what the JAX package's
``ops/segments.py::incidence_gather_sum`` computes, with each segment
summed directly in CSR order (no prefix difference), so repeats are
bitwise equal and the error does not grow with nnz.

The max backward's record-routed sum (:func:`record_routed_dx`, JAX's
``ops/maxops.py::_v2e_max_bwd`` ``:106-112``),
``dx[v, f] = Σ_{k ∈ seg v} g[e_k, f]·[arg[e_k, f] == v]`` over the
vertex-major CSR, with int32 or int64 ids, runs on the same walk: on the
card in two passes over a :class:`RecordTable` (the CSR and a host-built
:class:`RecordLayout`), so each cotangent and each id is read once.

A :class:`SegmentTable` holds one CSR on one device, checked once (types,
shapes, device, every index against N), so a call checks only ``x``. It
refers to int64 tensors the caller may already hold (the incidence CSRs of
:class:`~hypergef_tpu_torch.sparse.hypergraph.HypergraphData`) and adds only
the kernel's int32 copies and, on a CUDA device, its warp runs
(:func:`warp_runs`). A fixed graph's table keeps its exact runs; a
minibatch's tables, rewritten in place each batch under a recorded step
(:class:`~hypergef_tpu_torch.sparse.hypergraph.StaticTables`), pad theirs
with empty runs to :func:`max_warp_runs` of the pad shape, the count the
recorded launch is frozen at. ``launches`` counts the sum's launches,
``record_launches`` the record-routed sum's (one a call: its two passes).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Optional

import numpy as np
import torch

from hypergef_tpu_torch.ops import library
from hypergef_tpu_torch.utils import profiling

launches = 0
record_launches = 0

_INT32_MAX = 2**31 - 1
# entries + segments a warp run aims at (csrc/segment_sum.cu): a run of
# several segments then holds at most 2·RUN_SHARE - 2 entries and RUN_SHARE
# segments, within the kernel's kMaxEntries (64) and kMaxSegs (32)
RUN_SHARE = 32
# the record-routed sum's pass B walks runs of one of these shares (its runs
# load few rows, so the runs' chains of round trips, not bytes, set its time):
# the largest that still gives the card RECORD_FILL warps an SM
# (record_run_share). A run of several segments then holds at most 126
# entries and 64 segments, within kRecordEntries (128) and kRecordSegs (64).
RECORD_RUN_SHARES = (32, 64)
RECORD_FILL = 32  # pass B's warps an SM at the least (at 48 registers an SM holds 40)


def record_run_share(cost: int, sms: int) -> int:
    """Pass B's share for a CSR whose entries + segments are ``cost`` on a
    card of ``sms`` SMs: the largest of RECORD_RUN_SHARES that still cuts it
    into RECORD_FILL warps an SM, else the smallest."""
    return next((s for s in sorted(RECORD_RUN_SHARES, reverse=True)
                 if cost // s >= RECORD_FILL * sms), RECORD_RUN_SHARES[0])


def warp_runs(indptr, share: int = RUN_SHARE, alone: Optional[int] = None,
              pad_to: Optional[int] = None) -> np.ndarray:
    """The kernel's warp runs over a row pointer ``indptr`` [S+1]: int32
    [W+1, 2], each run's first segment and first entry, the last row
    (S, nnz).

    Merge-path style: a segment goes to the run of the ``share``-wide
    bucket in which its start falls, counting nnz + segments (each segment
    costs its length plus one); a segment that costs more than ``alone``
    (by default ``share``) gets a run of its own. So every run holds whole
    consecutive segments, the runs cover [0, S) in order, and a run of
    several segments costs less than ``share`` plus ``alone``.

    ``pad_to=P`` appends terminal rows (S, nnz) up to P + 1 rows: P runs,
    those past the W real ones empty, which the kernel leaves at once. A
    table that needs more than P runs raises ``ValueError``; it is never
    cut short. :func:`max_warp_runs` is the P that no CSR of a shape can
    pass."""
    indptr = np.asarray(indptr, dtype=np.int64)
    s = indptr.size - 1
    cost = np.diff(indptr) + 1
    start = indptr[:-1] + np.arange(s)  # nnz + segments before each segment
    long = cost > (share if alone is None else alone)
    cut = np.zeros(s + 1, dtype=bool)
    cut[[0, s]] = True
    bucket = start // share
    cut[1:s] |= bucket[1:] != bucket[:-1]
    cut[:s] |= long
    cut[1:] |= long
    first = np.flatnonzero(cut)
    if pad_to is not None:
        if first.size - 1 > pad_to:
            raise ValueError(f"the table needs {first.size - 1} warp runs, more than the "
                             f"{pad_to} it is padded to")
        first = np.concatenate([first, np.full(pad_to + 1 - first.size, s, dtype=first.dtype)])
    return np.ascontiguousarray(np.stack([first, indptr[first]], axis=1), dtype=np.int32)


def max_warp_runs(num_segments: int, nnz: int, share: int = RUN_SHARE) -> int:
    """The most runs :func:`warp_runs` (default ``alone``) makes of any CSR
    of ``num_segments`` segments and ``nnz`` entries: the run count a pad
    shape's launch is frozen at.

    A run starts at each cut i < S, and i is cut where i = 0, where its
    start's ``share``-bucket differs from segment i-1's, where segment i is
    long, or where segment i-1 is. A long segment costs more than
    ``share``, so the start after it lies in another bucket: its second cut
    is a bucket cut already. The starts lie in [0, nnz + S), so the cut at 0
    and the bucket cuts number at most ceil((nnz + S) / share); a long
    segment holds at least ``share`` entries, so there are at most
    nnz // share of them. Hence W ≤ min(S, ceil((nnz + S) / share) +
    nnz // share)."""
    s, z = int(num_segments), int(nnz)
    if s <= 0:
        return 0
    return min(s, -(-(z + s) // share) + z // share)


def check_host_csr(indptr, gather, num_inputs: int):
    """The checks of a host CSR that a table is built over: (indptr int64
    [S+1], gather [nnz]) as arrays, or ``ValueError``."""
    ip = np.asarray(indptr, dtype=np.int64)
    g = np.asarray(gather)
    if ip.ndim != 1 or ip.size < 1 or ip[0] != 0 or (np.diff(ip) < 0).any():
        raise ValueError("indptr must be a non-decreasing [S+1] row pointer from 0")
    nnz = int(ip[-1])
    if max(nnz, ip.size, num_inputs) > _INT32_MAX:
        raise ValueError(f"unsupported CSR: S={ip.size - 1}, nnz={nnz}, N={num_inputs}")
    if g.shape != (nnz,):
        raise ValueError(f"gather must be [{nnz}], got {g.shape}")
    if nnz and (g.min() < 0 or g.max() >= num_inputs):
        raise ValueError(f"gather indices must lie in [0, {num_inputs})")
    return ip, g


@dataclasses.dataclass(frozen=True)
class SegmentTable:
    """One CSR (segments over gathered rows) on one device, checked once."""

    indptr: torch.Tensor  # int32 [S+1], the kernel's row pointer
    indptr_long: torch.Tensor  # int64 [S+1], the same for the plain form
    gather: Optional[torch.Tensor]  # int32 [nnz] rows of x, or None: row k itself
    gather_long: Optional[torch.Tensor]  # int64 [nnz]
    num_inputs: int  # N, the rows of x
    nnz: int  # indptr[S], the gathered rows
    runs: Optional[torch.Tensor] = None  # int32 [W+1, 2] warp runs, on a CUDA device

    @classmethod
    def build(cls, indptr, gather, num_inputs: int, device) -> "SegmentTable":
        """Put a host CSR (``indptr`` [S+1], ``gather`` [nnz] or None) on
        ``device`` and check it."""
        def long(a):
            return torch.as_tensor(np.asarray(a, dtype=np.int64), device=device)

        return cls.from_long(long(indptr), None if gather is None else long(gather), num_inputs)

    @classmethod
    def from_host(cls, indptr, gather, num_inputs: int, indptr_long: torch.Tensor,
                  gather_long: torch.Tensor) -> "SegmentTable":
        """A table over a host CSR (``indptr`` [S+1], ``gather`` [nnz],
        NumPy) that the caller has already put on a device as the int64
        ``indptr_long`` and ``gather_long`` (kept, not copied). The checks
        and, on a CUDA device, the warp runs are computed from the host
        arrays, so nothing is read back from the device (:meth:`from_long`
        reads it once); the kernel's int32 copies are made from the host."""
        ip, g = check_host_csr(indptr, gather, num_inputs)
        nnz = int(ip[-1])
        if tuple(indptr_long.shape) != ip.shape or tuple(gather_long.shape) != g.shape:
            raise ValueError("the device tensors must be the host CSR's shapes")
        dev = indptr_long.device

        def int32(a):
            return torch.as_tensor(np.ascontiguousarray(a, dtype=np.int32), device=dev)

        runs = int32(warp_runs(ip)) if dev.type == "cuda" else None
        return cls(indptr=int32(ip), indptr_long=indptr_long, gather=int32(g),
                   gather_long=gather_long, num_inputs=int(num_inputs), nnz=nnz, runs=runs)

    @classmethod
    def from_long(cls, indptr_long: torch.Tensor, gather_long: Optional[torch.Tensor],
                  num_inputs: int) -> "SegmentTable":
        """A table over int64 device tensors the caller already holds (they
        are kept, not copied); only the kernel's int32 copies are new."""
        ip, gl = indptr_long, gather_long
        if ip.dtype != torch.int64 or ip.dim() != 1 or ip.numel() < 1:
            raise ValueError("indptr must be an int64 [S+1] row pointer")
        if gl is not None and (gl.dtype != torch.int64 or gl.dim() != 1 or gl.device != ip.device):
            raise ValueError("gather must be an int64 [nnz] tensor on the row pointer's device")
        # one read-back for every check: first, last, descents, gather range
        g = gl if gl is not None and gl.numel() else ip[:1]
        first, nnz, descents, lo, hi = torch.stack(
            [ip[0], ip[-1], (ip[1:] < ip[:-1]).sum(), g.min(), g.max()]).tolist()
        if first != 0 or descents:
            raise ValueError("indptr must be a non-decreasing [S+1] row pointer from 0")
        if max(nnz, ip.numel(), num_inputs) > _INT32_MAX:
            raise ValueError(f"unsupported CSR: S={ip.numel() - 1}, nnz={nnz}, N={num_inputs}")
        if gl is None:
            if nnz > num_inputs:
                raise ValueError(f"an identity gather reads rows [0, {nnz}) of {num_inputs}")
        elif gl.numel() != nnz:
            raise ValueError(f"gather must be [{nnz}], got {tuple(gl.shape)}")
        elif nnz and (lo < 0 or hi >= num_inputs):
            raise ValueError(f"gather indices must lie in [0, {num_inputs})")
        runs = None
        if ip.device.type == "cuda":  # the kernel's partition, built once
            runs = torch.as_tensor(warp_runs(ip.cpu().numpy()), device=ip.device)
        return cls(indptr=ip.to(torch.int32), indptr_long=ip,
                   gather=None if gl is None else gl.to(torch.int32), gather_long=gl,
                   num_inputs=int(num_inputs), nnz=int(nnz), runs=runs)

    @property
    def device(self) -> torch.device:
        return self.indptr.device

    @property
    def num_segments(self) -> int:
        return int(self.indptr.shape[0]) - 1


def gather_segment_sum_plain(x, table: SegmentTable):
    """``index_select`` of the gathered rows, then the direct sorted
    segment sum (any device)."""
    return segment_sum_plain(x, table.indptr_long, table.gather_long, table.nnz)


def segment_sum_plain(x, indptr_long, gather_long, nnz: int):
    """:func:`gather_segment_sum_plain` over the CSR's int64 tensors
    (``gather_long`` None: the row is the entry itself, of ``nnz``)."""
    from hypergef_tpu_torch.ops.segments import gather_segment_sum_sorted, segment_sum_sorted

    if gather_long is None:
        return segment_sum_sorted(x[:nnz], indptr_long)
    return gather_segment_sum_sorted(x, gather_long, indptr_long)


def record_layout(h_indptr, h_indices):
    """The record-routed sum's host layout over a vertex-major CSR (``h_indptr``
    [V+1], ``h_indices`` [nnz] the edge of each entry): (edge, members,
    perm), int32 [nnz] each, a member slot each.

    The slots run edge by edge, each edge's members ascending and, among
    duplicates of one member, in CSR order; ``edge`` and ``members`` name
    each slot's edge and member, ``perm`` its entry in the vertex-major CSR.
    For a graph of :meth:`Hypergraph.from_coo` the slots are the Hᵀ CSR's
    entries (``members`` is its member table) and ``perm`` maps each Hᵀ
    entry (e, v) to its H entry (v, e), the k-th duplicate of a member to
    its k-th."""
    h_indptr = np.asarray(h_indptr, dtype=np.int64)
    edge = np.asarray(h_indices, dtype=np.int64)
    vertex = np.repeat(np.arange(h_indptr.size - 1, dtype=np.int64), np.diff(h_indptr))
    perm = np.lexsort((vertex, edge))  # stable: duplicates keep CSR order
    return tuple(a.astype(np.int32) for a in (edge[perm], vertex[perm], perm))


@dataclasses.dataclass(frozen=True)
class RecordLayout:
    """:func:`record_layout` on the card (what the kernel's pass A reads, a
    thread a slot) and pass B's warp runs over the vertex-major CSR."""

    edge: torch.Tensor  # int32 [nnz], each slot's edge
    members: torch.Tensor  # int32 [nnz], each slot's member
    slot: torch.Tensor  # int32 [nnz], each vertex-major entry's slot (perm's inverse)
    runs: torch.Tensor  # int32 [W+1, 2], pass B's warp_runs (share: record_run_share)
    build_s: float  # host seconds to build it (copies back to the host included)

    @property
    def nbytes(self) -> int:
        return sum(t.numel() * t.element_size()
                   for t in (self.edge, self.members, self.slot, self.runs))


@dataclasses.dataclass(frozen=True)
class RecordTable:
    """The vertex-major CSR of a max V→E (``e2v``: segments are vertices,
    the gather names each entry's edge) and, on a CUDA device, the kernel's
    layout of its edges (None on the CPU)."""

    e2v: SegmentTable
    layout: Optional[RecordLayout] = None

    @classmethod
    def over(cls, e2v: SegmentTable) -> "RecordTable":
        """The table over ``e2v``; on a CUDA device the layout is built from
        a host copy of it, once."""
        if e2v.device.type != "cuda":
            return cls(e2v)
        if e2v.gather_long is None:
            raise ValueError("the record-routed sum needs the CSR's edges (a gather)")
        t0 = time.perf_counter()
        indptr = e2v.indptr_long.cpu().numpy()
        sms = torch.cuda.get_device_properties(e2v.device).multi_processor_count
        share = record_run_share(e2v.nnz + e2v.num_segments, sms)
        edge, members, perm = record_layout(indptr, e2v.gather_long.cpu().numpy())
        slot = np.empty_like(perm)
        slot[perm] = np.arange(perm.size, dtype=np.int32)
        edge, members, slot, runs = (torch.as_tensor(a, device=e2v.device)
                                     for a in (edge, members, slot, warp_runs(indptr, share)))
        torch.cuda.synchronize(e2v.device)
        return cls(e2v, RecordLayout(edge=edge, members=members, slot=slot, runs=runs,
                                     build_s=time.perf_counter() - t0))

    @property
    def device(self) -> torch.device:
        return self.e2v.device


def record_routed_dx_plain(g, arg, record: RecordTable):
    """The record-routed sum in plain torch (any device): two row gathers by
    the CSR's entries, the compare with each entry's segment, the direct
    sorted segment sum (``_v2e_max_bwd``, ``maxops.py:106-112``)."""
    from hypergef_tpu_torch.ops.segments import segment_sum_sorted

    table = record.e2v
    ip = table.indptr_long
    seg = torch.repeat_interleave(torch.arange(table.num_segments, device=ip.device),
                                  ip[1:] - ip[:-1], output_size=table.nnz)
    rows = table.gather_long
    if rows is None:
        rows = torch.arange(table.nnz, device=ip.device)
    gg = g.index_select(0, rows)  # [nnz, F] cotangents of the owning edges
    ga = arg.index_select(0, rows)  # [nnz, F] winning vertex per (e, f)
    return segment_sum_sorted(torch.where(ga == seg[:, None], gg, 0.0), ip)


def record_routed_dx_sequential(g, arg, record: RecordTable):
    """The record-routed sum in the kernel's order (any device): each
    vertex's sum from +0.0, one f32 add an entry in CSR order where the
    entry's edge was won by the vertex, nothing where it was lost. A check
    of the kernel's bits, not a fast form: one step for each position of
    the longest segment."""
    table = record.e2v
    ip = table.indptr_long
    deg = ip[1:] - ip[:-1]
    rows = table.gather_long
    out = torch.zeros((table.num_segments, g.shape[1]), dtype=torch.float32, device=g.device)
    for r in range(int(deg.max()) if deg.numel() else 0):
        v = torch.nonzero(deg > r).squeeze(1)
        k = ip[v] + r
        e = k if rows is None else rows[k]
        acc = out[v]
        out[v] = torch.where(arg[e] == v[:, None], acc + g[e], acc)
    return out


def layout(f: int, tensors) -> tuple:
    """The kernel's layout for width F over ``tensors`` (x and out):
    (width, lanes). A load reads ``width`` columns, 4 or 2 where F and every
    tensor's alignment allow, else 1; a segment's lane group has ``lanes``
    lanes, its loads a row rounded up to a power of two, at most 32."""
    width = next(w for w in (4, 2, 1)
                 if f % w == 0 and all(t.data_ptr() % min(16, t.element_size() * w) == 0
                                       for t in tensors))
    lanes = 1
    while lanes < min(f // width, 32):
        lanes *= 2
    return width, lanes


def _check_rows(x, table_device, n: int, name: str):
    """The kernel's checks of a row operand of ``n`` rows over a table on
    ``table_device``: its width F."""
    dev = x.device
    if dev.type != "cuda":
        raise ValueError(f"the CUDA kernel takes CUDA tensors, got {dev}")
    if table_device != dev:
        raise ValueError(f"the table is on {table_device}, {name} on {dev}")
    if x.dtype != torch.float32 or x.dim() != 2 or x.shape[0] != n:
        raise TypeError(f"{name} must be f32 [{n}, F], got {x.dtype} {tuple(x.shape)}")
    if not x.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    f = x.shape[1]
    if f <= 0 or f > _INT32_MAX:
        raise ValueError(f"unsupported width F={f}")
    if torch.cuda.get_device_capability(dev) != (9, 0):
        raise RuntimeError(
            f"the kernel is built for sm_90a (Hopper); {torch.cuda.get_device_name(dev)} "
            f"is sm_{''.join(map(str, torch.cuda.get_device_capability(dev)))}")
    return f


def _raise_on(err, lib, name):
    if err != 0:
        raise RuntimeError(f"{name} launch failed: {lib.hg_error_string(err).decode()}")


def _launch(x, indptr, gather, runs, num_inputs: int):
    """The kernel over a :class:`SegmentTable`'s int32 ``indptr``,
    ``gather`` (or None) and warp ``runs``: the CUDA implementation of the
    ``gather_segment_sum`` op (:mod:`.library`)."""
    global launches
    from hypergef_tpu_torch.ops import _build

    f = _check_rows(x, indptr.device, num_inputs, "x")
    if runs is None:
        raise ValueError("the segment-sum kernel reads the table's warp runs: build the "
                         "table on a CUDA device")
    s = int(indptr.shape[0]) - 1
    out = torch.empty((s, f), dtype=torch.float32, device=x.device)
    if s == 0:
        return out
    width, lanes = layout(f, [x, out])
    lib = _build.load_library()
    with torch.cuda.device(x.device):
        err = lib.hg_gather_segment_sum(
            x.data_ptr(), 0 if gather is None else gather.data_ptr(),
            indptr.data_ptr(), runs.data_ptr(), out.data_ptr(),
            runs.shape[0] - 1, f, lanes, width,
            torch.cuda.current_stream(x.device).cuda_stream)
    _raise_on(err, lib, "gather_segment_sum")
    launches += 1
    return out


def _launch_record(g, arg, record: RecordTable):
    global record_launches
    from hypergef_tpu_torch.ops import _build

    table, lay = record.e2v, record.layout
    f = _check_rows(g, table.device, table.num_inputs, "g")
    if arg.dtype not in (torch.int32, torch.int64) or arg.shape != g.shape:
        raise TypeError(f"arg must be int32 or int64 {tuple(g.shape)}, got {arg.dtype} "
                        f"{tuple(arg.shape)}")
    if arg.device != g.device or not arg.is_contiguous():
        raise ValueError(f"arg must be a contiguous tensor on {g.device}")
    if lay is None:
        raise ValueError("the record table has no kernel layout: build it on the card "
                         "(RecordTable.over a CUDA table, HypergraphData.record)")
    s = table.num_segments
    out = torch.empty((s, f), dtype=torch.float32, device=g.device)
    if s == 0:
        return out
    # pass A writes every slot's won words, zeros too: no memset
    words = torch.empty((table.nnz, -(-f // 32)), dtype=torch.int32, device=g.device)
    width, lanes = layout(f, [g, out])
    lib = _build.load_library()
    with torch.cuda.device(g.device):
        err = lib.hg_record_routed_dx(
            g.data_ptr(), arg.data_ptr(), arg.element_size(), lay.edge.data_ptr(),
            lay.members.data_ptr(), lay.slot.data_ptr(), table.nnz, words.data_ptr(),
            table.gather.data_ptr(), table.indptr.data_ptr(), lay.runs.data_ptr(),
            out.data_ptr(), lay.runs.shape[0] - 1, f, lanes, width,
            torch.cuda.current_stream(g.device).cuda_stream)
    _raise_on(err, lib, "record_routed_dx")
    record_launches += 1
    return out


def _sum_cost(x, table: SegmentTable):
    """The gathered rows summed, one an entry and feature."""
    operands = (x, table.indptr) if table.gather is None else (x, table.indptr, table.gather)
    return "gather_segment_sum", operands, table.nnz * x.shape[1]


def _record_cost(g, arg, record: RecordTable):
    """Each entry's compare with its segment, the select and the sum: three
    an entry and feature, as :func:`record_routed_dx_plain` counts them."""
    table = record.e2v
    return ("record_routed_dx", (g, arg, table.indptr, table.gather),
            3 * table.nnz * g.shape[1])


@profiling.kernel(_sum_cost)
def gather_segment_sum(x, table: SegmentTable):
    """``out[s] = Σ_{k ∈ seg s} x[gather[k]]``: x f32 [N, F] → f32 [S, F].

    On CUDA tensors this launches the kernel, through the
    ``gather_segment_sum`` op (:mod:`.library`); on CPU tensors it runs
    :func:`gather_segment_sum_plain`. It carries no autograd rule of its
    own, so it refuses an ``x`` that requires grad: differentiate through
    :func:`hypergef_tpu_torch.ops.segments.incidence_gather_sum`, whose
    backward is the same op over the transposed CSR.
    """
    if x.requires_grad and torch.is_grad_enabled():
        raise RuntimeError(
            "gather_segment_sum has no autograd rule: differentiate through "
            "ops.segments.incidence_gather_sum, whose backward is the transposed CSR")
    if x.device.type == "cpu":
        if table.device.type != "cpu":
            raise ValueError(f"x is on the CPU but the table is on {table.device}")
        return gather_segment_sum_plain(x, table)
    return library.OPS["gather_segment_sum"](x, table.indptr, table.gather, table.runs,
                                      table.num_inputs)


@profiling.kernel(_record_cost)
def record_routed_dx(g, arg, record: RecordTable):
    """``dx[v, f] = Σ_{k ∈ seg v} g[gather[k], f]·[arg[gather[k], f] == v]``
    over ``record.e2v`` (the vertex-major CSR; ``HypergraphData.record``):
    g f32 [E, F], arg int32 or int64 [E, F] → f32 [V, F]. The max backward:
    on CUDA tensors one call of the kernel's two passes (pass A, a thread a
    member slot of the layout, writes the words of the features its member
    won; pass B sums the won values over the CSR, reading each entry's words
    through its slot), :func:`record_routed_dx_plain` on CPU tensors."""
    if g.device.type == "cpu":
        if record.device.type != "cpu":
            raise ValueError(f"g is on the CPU but the table is on {record.device}")
        return record_routed_dx_plain(g, arg, record)
    return _launch_record(g, arg, record)
