"""The ELL gather-sum of a tree stage's level 0: CUDA kernel, plain twin.

Counterpart of ``hypergef_tpu/ops/pallas_sparse.py::ell_gather_sum``
(``:97-148``; Pallas kernels at ``:111`` "vmem" and ``:127`` "dma"). One
function,

    out[c, :] = Σ_k x[gidx[c, k], :] · mask[c, k]

summed over k in order, with x f32 [N, F], gidx int32 [C, ngs] and mask
f32 [C, ngs], in two forms:

* :func:`ell_gather_sum` runs the hand-written CUDA kernel
  (``csrc/ell_gather.cu``) on a CUDA tensor and the plain version on a
  CPU tensor. On a CUDA tensor it launches the kernel or raises; it never
  falls back. The kernel's form follows from F and x's alignment
  (:func:`gather_schedule`): a float4 of features a lane where F % 4 == 0
  and x is 16-byte aligned, else a feature a lane; any contiguous x is
  taken.
* :func:`ell_gather_sum_plain` is the same sequential loop in plain torch.
  The kernel rounds each product and each sum as the loop does, so the
  two are bitwise equal.

A :class:`GatherTable` holds one table on one device, checked once (types,
shapes, device, every index against N) when a plan is put on the device,
so a call checks only ``x``. ``launches`` counts the kernel's launches.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from hypergef_tpu_torch.ops import library
from hypergef_tpu_torch.utils import profiling

launches = 0

_INT32_MAX = 2**31 - 1


@dataclasses.dataclass(frozen=True)
class GatherTable:
    """One ELL table on one device, checked once for the kernel."""

    gidx: torch.Tensor  # int32 [C, ngs], the kernel's indices
    gidx_long: torch.Tensor  # int64 [C, ngs], the same indices for the plain form
    mask: torch.Tensor  # f32 [C, ngs]
    num_inputs: int  # N, the rows of x

    def __post_init__(self):
        g, gl, m = self.gidx, self.gidx_long, self.mask
        if g.dtype != torch.int32 or gl.dtype != torch.int64 or m.dtype != torch.float32:
            raise TypeError(
                f"gidx must be int32, gidx_long int64 and mask f32; got {g.dtype}, "
                f"{gl.dtype}, {m.dtype}")
        if g.dim() != 2 or g.shape != gl.shape or g.shape != m.shape:
            raise ValueError(
                f"gidx, gidx_long and mask must be one [C, ngs] shape, got "
                f"{tuple(g.shape)}, {tuple(gl.shape)}, {tuple(m.shape)}")
        c, ngs = g.shape
        if min(c, ngs) <= 0 or max(c, ngs, self.num_inputs) > _INT32_MAX:
            raise ValueError(f"unsupported table: C={c}, ngs={ngs}, N={self.num_inputs}")
        if not (g.device == gl.device == m.device):
            raise ValueError(f"tables on {g.device}, {gl.device}, {m.device}")
        if not (g.is_contiguous() and m.is_contiguous()):
            raise ValueError("gidx and mask must be contiguous")
        lo, hi = int(gl.min()), int(gl.max())
        if lo < 0 or hi >= self.num_inputs or not torch.equal(g.to(torch.int64), gl):
            raise ValueError(
                f"gather indices must lie in [0, {self.num_inputs}) and agree in "
                f"both tables; got [{lo}, {hi}]")

    @property
    def device(self) -> torch.device:
        return self.gidx.device


def ell_gather_sum_plain(x, gidx, mask):
    """The sequential loop in plain torch (any device): ``acc = x[g0]·m0``,
    then ``acc = acc + x[gk]·mk`` for k = 1..ngs-1. ``gidx`` is int64."""
    acc = x.index_select(0, gidx[:, 0]) * mask[:, 0:1]
    for k in range(1, gidx.shape[1]):
        acc = acc + x.index_select(0, gidx[:, k]) * mask[:, k : k + 1]
    return acc


# slots a lane keeps in flight (the kernel's kMaxBatch): a chunk of ngs <= 16
# is one batch
MAX_BATCH = 16
# the kernel's forms, by the code its entry takes
FORMS = ("quad", "wide")


class GatherSchedule(NamedTuple):
    """How the kernel lays a chunk on lanes: ``lanes_per_chunk`` lanes own a
    chunk, each issuing ``batch`` slots' row loads before its first add, in
    one of two ``form``s: ``quad`` (a float4 of features a lane) or ``wide``
    (a feature a lane)."""

    lanes_per_chunk: int
    batch: int
    form: str


def _pow2_at_least(n: int) -> int:
    return 1 << max(n - 1, 0).bit_length()


def gather_schedule(f: int, ngs: int, x_aligned: bool) -> GatherSchedule:
    """The kernel's schedule for width ``f``, ``ngs`` slots a chunk and an x
    that is (or is not) 16-byte aligned. F % 4 == 0 with an aligned x takes
    quads on F/4 lanes, otherwise features on F lanes, rounded up to a power
    of two (at most 32: wider rows take passes). A batch is every slot up to
    ``MAX_BATCH``."""
    if f <= 0 or ngs <= 0:
        raise ValueError(f"unsupported table: F={f}, ngs={ngs}")
    batch = min(ngs, MAX_BATCH)
    if f % 4 == 0 and x_aligned:
        return GatherSchedule(min(_pow2_at_least(f // 4), 32), batch, "quad")
    return GatherSchedule(min(_pow2_at_least(f), 32), batch, "wide")


def _launch(x, gidx, mask, num_inputs: int):
    """The kernel over a :class:`GatherTable`'s int32 ``gidx`` and ``mask``:
    the CUDA implementation of the ``ell_gather_sum`` op (:mod:`.library`)."""
    global launches
    from hypergef_tpu_torch.ops import _build

    dev = x.device
    if dev.type != "cuda":
        raise ValueError(f"the CUDA kernel takes CUDA tensors, got {dev}")
    if gidx.device != dev or mask.device != dev:
        raise ValueError(f"the table is on {gidx.device}, x on {dev}")
    n = num_inputs
    if x.dtype != torch.float32 or x.dim() != 2 or x.shape[0] != n:
        raise TypeError(f"x must be f32 [{n}, F], got {x.dtype} {tuple(x.shape)}")
    if not x.is_contiguous():
        raise ValueError("x must be contiguous")
    c, ngs = gidx.shape
    f = x.shape[1]
    if f <= 0 or f > _INT32_MAX:
        raise ValueError(f"unsupported width F={f}")
    if torch.cuda.get_device_capability(dev) != (9, 0):
        raise RuntimeError(
            f"the kernel is built for sm_90a (Hopper); {torch.cuda.get_device_name(dev)} "
            f"is sm_{''.join(map(str, torch.cuda.get_device_capability(dev)))}"
        )
    lib = _build.load_library()
    out = torch.empty((c, f), dtype=torch.float32, device=dev)
    sched = gather_schedule(f, ngs, x.data_ptr() % 16 == 0)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.hg_ell_gather_sum(
            x.data_ptr(), gidx.data_ptr(), mask.data_ptr(), out.data_ptr(),
            c, ngs, f, FORMS.index(sched.form), sched.lanes_per_chunk, sched.batch, stream,
        )
    if err != 0:
        raise RuntimeError(f"ell_gather_sum launch failed: {lib.hg_error_string(err).decode()}")
    launches += 1
    return out


def _cost(x, table: GatherTable):
    """The masked products over the [C, ngs] table and their sums over k."""
    c, ngs = table.gidx.shape
    return "ell_gather_sum", (x, table.gidx, table.mask), 2 * c * ngs * x.shape[1]


@profiling.kernel(_cost)
def ell_gather_sum(x, table: GatherTable):
    """``out[c] = Σ_k x[gidx[c,k]]·mask[c,k]``: x f32 [N, F] → f32 [C, F].

    On CUDA tensors this launches the kernel, through the ``ell_gather_sum``
    op (:mod:`.library`); on CPU tensors it runs :func:`ell_gather_sum_plain`.
    It carries no autograd rule of its own, so it refuses an ``x`` that
    requires grad: the tree op's backward applies the transposed stage
    (:mod:`hypergef_tpu_torch.ops.tree`).
    """
    if x.requires_grad and torch.is_grad_enabled():
        raise RuntimeError(
            "ell_gather_sum has no autograd rule: differentiate through "
            "ops.tree.tree_matvec, whose backward is the transposed stage")
    if x.device.type == "cpu":
        if table.device.type != "cpu":
            raise ValueError(f"x is on the CPU but the table is on {table.device}")
        return ell_gather_sum_plain(x, table.gidx_long, table.mask)
    return library.OPS["ell_gather_sum"](x, table.gidx, table.mask, table.num_inputs)
