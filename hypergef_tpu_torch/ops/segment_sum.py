"""Gather + sorted segment sum over a CSR: CUDA kernel, plain twin.

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

A :class:`SegmentTable` holds one CSR on one device, checked once (types,
shapes, device, every index against N), so a call checks only ``x``. It
refers to int64 tensors the caller may already hold (the incidence CSRs of
:class:`~hypergef_tpu_torch.sparse.hypergraph.HypergraphData`) and adds only
the kernel's int32 copies.
``launches`` counts the kernel's launches.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from hypergef_tpu_torch.ops.ell_gather import _lanes_per_chunk

launches = 0

_INT32_MAX = 2**31 - 1


@dataclasses.dataclass(frozen=True)
class SegmentTable:
    """One CSR (segments over gathered rows) on one device, checked once."""

    indptr: torch.Tensor  # int32 [S+1], the kernel's row pointer
    indptr_long: torch.Tensor  # int64 [S+1], the same for the plain form
    gather: Optional[torch.Tensor]  # int32 [nnz] rows of x, or None: row k itself
    gather_long: Optional[torch.Tensor]  # int64 [nnz]
    num_inputs: int  # N, the rows of x
    nnz: int  # indptr[S], the gathered rows

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
        return cls(indptr=ip.to(torch.int32), indptr_long=ip,
                   gather=None if gl is None else gl.to(torch.int32), gather_long=gl,
                   num_inputs=int(num_inputs), nnz=int(nnz))

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


def _launch(x, table: SegmentTable):
    global launches
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
    if torch.cuda.get_device_capability(dev) != (9, 0):
        raise RuntimeError(
            f"the kernel is built for sm_90a (Hopper); {torch.cuda.get_device_name(dev)} "
            f"is sm_{''.join(map(str, torch.cuda.get_device_capability(dev)))}")
    s = table.num_segments
    out = torch.empty((s, f), dtype=torch.float32, device=dev)
    if s == 0:
        return out
    lib = _build.load_library()
    gather = 0 if table.gather is None else table.gather.data_ptr()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.hg_gather_segment_sum(
            x.data_ptr(), gather, table.indptr.data_ptr(), out.data_ptr(),
            s, f, _lanes_per_chunk(f), stream)
    if err != 0:
        raise RuntimeError(
            f"gather_segment_sum launch failed: {lib.hg_error_string(err).decode()}")
    launches += 1
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
