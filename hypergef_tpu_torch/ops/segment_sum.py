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

The same kernel, masked, carries the max backward's record-routed sum
(:func:`record_routed_dx`, JAX's ``ops/maxops.py::_v2e_max_bwd``
``:106-112``): ``dx[v, f] = Σ_{k ∈ seg v} g[e_k, f]·[arg[e_k, f] == v]`` over
the vertex-major CSR, with int32 (aligned argmax) or int64 (tree) ids.

A :class:`SegmentTable` holds one CSR on one device, checked once (types,
shapes, device, every index against N), so a call checks only ``x``. It
refers to int64 tensors the caller may already hold (the incidence CSRs of
:class:`~hypergef_tpu_torch.sparse.hypergraph.HypergraphData`) and adds only
the kernel's int32 copies and, on a CUDA device, its warp runs
(:func:`warp_runs`). ``launches`` counts the plain sum's launches,
``record_launches`` the masked one's.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

launches = 0
record_launches = 0

_INT32_MAX = 2**31 - 1
# entries + segments a warp run aims at (csrc/segment_sum.cu): a run of
# several segments then holds at most 2·RUN_SHARE - 2 entries and RUN_SHARE
# segments, within the kernel's kMaxEntries (64) and kMaxSegs (32)
RUN_SHARE = 32


def warp_runs(indptr, share: int = RUN_SHARE, alone: Optional[int] = None) -> np.ndarray:
    """The kernel's warp runs over a row pointer ``indptr`` [S+1]: int32
    [W+1, 2], each run's first segment and first entry, the last row
    (S, nnz).

    Merge-path style: a segment goes to the run of the ``share``-wide
    bucket in which its start falls, counting nnz + segments (each segment
    costs its length plus one); a segment that costs more than ``alone``
    (by default ``share``) gets a run of its own. So every run holds whole
    consecutive segments, the runs cover [0, S) in order, and a run of
    several segments costs less than ``share`` plus ``alone``."""
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
    return np.ascontiguousarray(np.stack([first, indptr[first]], axis=1), dtype=np.int32)


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
    from hypergef_tpu_torch.ops.segments import gather_segment_sum_sorted, segment_sum_sorted

    if table.gather_long is None:
        return segment_sum_sorted(x[: table.nnz], table.indptr_long)
    return gather_segment_sum_sorted(x, table.gather_long, table.indptr_long)


def record_routed_dx_plain(g, arg, table: SegmentTable):
    """The record-routed sum in plain torch (any device): two row gathers by
    the CSR's entries, the compare with each entry's segment, the direct
    sorted segment sum (``_v2e_max_bwd``, ``maxops.py:106-112``)."""
    from hypergef_tpu_torch.ops.segments import segment_sum_sorted

    ip = table.indptr_long
    seg = torch.repeat_interleave(torch.arange(table.num_segments, device=ip.device),
                                  ip[1:] - ip[:-1], output_size=table.nnz)
    rows = table.gather_long
    if rows is None:
        rows = torch.arange(table.nnz, device=ip.device)
    gg = g.index_select(0, rows)  # [nnz, F] cotangents of the owning edges
    ga = arg.index_select(0, rows)  # [nnz, F] winning vertex per (e, f)
    return segment_sum_sorted(torch.where(ga == seg[:, None], gg, 0.0), ip)


def layout(f: int, tensors) -> tuple:
    """The kernel's layout for width F over ``tensors`` (x, out and arg):
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


def _launch(x, table: SegmentTable, arg=None):
    global launches, record_launches
    from hypergef_tpu_torch.ops import _build

    dev = x.device
    if dev.type != "cuda":
        raise ValueError(f"the CUDA kernel takes CUDA tensors, got {dev}")
    if table.device != dev:
        raise ValueError(f"the table is on {table.device}, x on {dev}")
    n = table.num_inputs
    if x.dtype != torch.float32 or x.dim() != 2 or x.shape[0] != n:
        raise TypeError(f"x must be f32 [{n}, F], got {x.dtype} {tuple(x.shape)}")
    if not x.is_contiguous():
        raise ValueError("x must be contiguous")
    f = x.shape[1]
    if f <= 0 or f > _INT32_MAX:
        raise ValueError(f"unsupported width F={f}")
    if arg is not None:
        if arg.dtype not in (torch.int32, torch.int64) or arg.shape != x.shape:
            raise TypeError(f"arg must be int32 or int64 {tuple(x.shape)}, got {arg.dtype} "
                            f"{tuple(arg.shape)}")
        if arg.device != dev or not arg.is_contiguous():
            raise ValueError(f"arg must be a contiguous tensor on {dev}")
    if torch.cuda.get_device_capability(dev) != (9, 0):
        raise RuntimeError(
            f"the kernel is built for sm_90a (Hopper); {torch.cuda.get_device_name(dev)} "
            f"is sm_{''.join(map(str, torch.cuda.get_device_capability(dev)))}")
    s = table.num_segments
    out = torch.empty((s, f), dtype=torch.float32, device=dev)
    if s == 0:
        return out
    width, lanes = layout(f, [x, out] + ([] if arg is None else [arg]))
    lib = _build.load_library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.hg_gather_segment_sum(
            x.data_ptr(), 0 if arg is None else arg.data_ptr(),
            0 if arg is None else arg.element_size(),
            0 if table.gather is None else table.gather.data_ptr(), table.indptr.data_ptr(),
            table.runs.data_ptr(), out.data_ptr(), table.runs.shape[0] - 1, f, lanes, width,
            stream)
    if err != 0:
        name = "gather_segment_sum" if arg is None else "record_routed_dx"
        raise RuntimeError(f"{name} launch failed: {lib.hg_error_string(err).decode()}")
    if arg is None:
        launches += 1
    else:
        record_launches += 1
    return out


def gather_segment_sum(x, table: SegmentTable):
    """``out[s] = Σ_{k ∈ seg s} x[gather[k]]``: x f32 [N, F] → f32 [S, F].

    On CUDA tensors this launches the kernel; on CPU tensors it runs
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
    return _launch(x, table)


def record_routed_dx(g, arg, table: SegmentTable):
    """``dx[v, f] = Σ_{k ∈ seg v} g[gather[k], f]·[arg[gather[k], f] == v]``
    over ``table`` (the vertex-major CSR ``HypergraphData.e2v``): g f32
    [E, F], arg int32 or int64 [E, F] → f32 [V, F]. The max backward: one
    launch of the masked kernel on CUDA tensors,
    :func:`record_routed_dx_plain` on CPU tensors."""
    if g.device.type == "cpu":
        if table.device.type != "cpu":
            raise ValueError(f"g is on the CPU but the table is on {table.device}")
        return record_routed_dx_plain(g, arg, table)
    return _launch(g, table, arg)
