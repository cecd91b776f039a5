"""Ports of the TPU probe scripts in ``scripts/`` onto one-construct CUDA kernels.

The JAX package's probes time and bisect the pieces of the gather route on
a TPU, each in a Pallas kernel that carries one construct. Here each
construct runs in a kernel of ``csrc/probes.cu`` (or in the port's gather
kernels), with a plain torch version beside it:

* :func:`row_gather` — ``out[r] = x[idx[r]]``, on the launch plan of
  :func:`row_plan` (each warp a contiguous range of rows): ``direct``
  (each lane several rows' pieces loaded into registers before it stores
  them) or a ring of ``n_buf`` rows a warp in flight in shared memory,
  copied in by ``cp.async`` and stored by the lane that copied each piece
  (the card's form of a ring of row DMAs);
* :func:`chunk_masked_sum` — ``out[c] = Σ_k g[c, k] · mask[c, k]`` from a
  gathered ``[C, ngs, F]`` tensor, and :func:`chunk_masked_sum_ring`, the
  same from ``x`` and a gather table through rings of chunk slots in
  shared memory, each filled by a producer warp's asynchronous copies for
  its consumer warp, on the launch plan of :func:`ring_plan`;
* :func:`scaled_copy` — ``out = x · s``, a float4 a thread.

The ELL level-0 probes whose x is resident run on
:func:`hypergef_tpu_torch.ops.ell_gather.ell_gather_sum`, which computes
exactly that function, and the one-hot segment sums on
:func:`hypergef_tpu_torch.ops.segment_sum.gather_segment_sum`.

One function per script (:func:`probe_r2_gather`, :func:`probe_r2b_bisect`,
:func:`pallas_probe`, :func:`pallas_probe2`, :func:`pallas_probe3`) builds
the script's inputs at the script's shapes (smaller ones on request), runs
each case once and holds it against the script's NumPy oracle, copied
here: bitwise for gathers and copies, rtol 1e-5 and atol 1e-5·max|oracle|
for sums. Each returns rows of ``{case, kernel, ok, max_abs_err, ms,
library_ms, launches}``; ``ms`` (the kernel) and ``library_ms`` (one
PyTorch call computing the same function: ``index_select``,
``torch.einsum``, ``torch.sparse.mm``, ``torch.segment_reduce`` or
``torch.mul``) are CUDA-event times with ``timed=True`` on the card, else
None. ``launches`` counts the kernel launches of the checked call only.

On a CUDA tensor each wrapper launches its kernel or raises; on a CPU
tensor it runs the plain version. Indices are checked against N when the
probe builds its tables, not on every call.
"""

from __future__ import annotations

from typing import Callable, Dict, List, NamedTuple, Optional

import numpy as np
import torch

from hypergef_tpu_torch.ops import ell_gather, segment_sum
from hypergef_tpu_torch.ops.ell_gather import GatherTable
from hypergef_tpu_torch.utils import profiling

row_gather_launches = 0
chunk_sum_launches = 0
scaled_copy_launches = 0

RING_DEPTHS = (4, 8, 16)
NGS = 8
# the row gather (csrc/probes.cu): threads of a direct block and direct
# blocks an SM (kThreads, kDirectBlocks), warps of a ring block at most
# (kRowMaxWarps)
ROW_DIRECT_WARPS = 256 // 32
ROW_DIRECT_BLOCKS = 4
ROW_MAX_WARPS = 32
# the most rows a warp takes in each form: more rows go to more waves of
# blocks, which keep the grid's reads and writes in one moving window; and
# the least a direct warp takes, so a small gather is not all warp set-up
ROW_DIRECT_MAX = 32
ROW_RING_MAX = 64
ROW_DIRECT_MIN = 4
# the chunk ring (csrc/probes.cu): a block's shared memory on sm_90 (all an
# SM holds, less the 1 KB the runtime keeps for the block), the
# producer-consumer warp pairs a block holds at most (kSmemBudget,
# kRingMaxPairs), and a pair's table ring: 6 steps of 32 (index, mask) pairs
# (kRingTableBytes)
RING_BUDGET = 232_448
RING_MAX_PAIRS = 16
RING_TABLE_BYTES = 6 * 32 * 8


class RingPlan(NamedTuple):
    """The chunk ring's launch: ``blocks`` blocks of ``pairs`` pairs of a
    producer and a consumer warp, each pair ``per_pair`` consecutive chunks
    through ``slots`` chunk slots; ``smem`` bytes of shared memory a block
    (the pairs' slots and table rings)."""

    blocks: int
    pairs: int
    slots: int
    per_pair: int
    smem: int


def ring_chunks_a_warp(f: int) -> int:
    """The chunks a consumer warp sums at once: F / 4 lanes a chunk, rounded
    up to a power of two in [8, 32] (the kernel's ``ring_chunks_a_warp``)."""
    lanes = 8
    while lanes < f // 4 and lanes < 32:
        lanes *= 2
    return 32 // lanes


def ring_slot_bytes(ngs: int, f: int) -> int:
    """A slot's shared memory: ngs rows of F floats, the mask row padded to
    16 bytes, and the slot's full and empty barriers."""
    return ngs * f * 4 + -(-ngs * 4 // 16) * 16 + 16


def ring_plan(c: int, ngs: int, f: int, n_buf: int, sms: int) -> RingPlan:
    """One wave: a block an SM at most, each pair a contiguous range of
    chunks. The pairs a block holds follow from its budget at the
    deepest ring (``max(RING_DEPTHS)`` slots a pair), so they are the same at
    every depth; ``n_buf`` slots a pair, fewer only where the budget holds
    fewer. Slots come in multiples of the chunks a consumer warp sums at
    once, so that each slot has one lane group; chunks too large for that
    raise."""
    if n_buf not in RING_DEPTHS:
        raise ValueError(f"n_buf must be one of {RING_DEPTHS}, got {n_buf}")
    if min(c, ngs, f, sms) <= 0:
        raise ValueError(f"unsupported ring: C={c}, ngs={ngs}, F={f}, SMs={sms}")
    slot = ring_slot_bytes(ngs, f)
    pairs = max(1, min(RING_MAX_PAIRS,
                       RING_BUDGET // (max(RING_DEPTHS) * slot + RING_TABLE_BYTES)))
    cpw = ring_chunks_a_warp(f)
    slots = min(n_buf, (RING_BUDGET // pairs - RING_TABLE_BYTES) // slot) // cpw * cpw
    if slots <= 0:
        raise ValueError(f"a chunk of {ngs} rows of F={f} exceeds the block's "
                         f"{RING_BUDGET} bytes")
    per_pair = -(-c // (sms * pairs))
    n_pairs = -(-c // per_pair)
    pairs = min(pairs, n_pairs)  # a block no larger than the chunks need
    return RingPlan(-(-n_pairs // pairs), pairs, slots, per_pair,
                    pairs * (slots * slot + RING_TABLE_BYTES))


class RowPlan(NamedTuple):
    """The row gather's launch: ``blocks`` blocks of ``warps`` warps, each
    warp ``per_warp`` consecutive rows; in the ring, stages of ``tile``
    rows and ``smem`` bytes of shared memory a block (0 and 0 direct)."""

    blocks: int
    warps: int
    per_warp: int
    tile: int
    smem: int


def row_tile(f: int, n_buf: int) -> int:
    """The ring's stage: the most rows whose 16-byte pieces the 32 lanes
    copy at once, at most ``n_buf`` and a power of two (so stages divide the
    ring); 1 where a row alone has 32 pieces or more."""
    tile = 1
    while tile * 2 <= min(n_buf, 32 // (f // 4)):
        tile *= 2
    return tile


def row_plan(r: int, f: int, n_buf: int, sms: int) -> RowPlan:
    """Each warp a contiguous range of rows: the rows of one wave, at most
    ``ROW_DIRECT_MAX`` (direct) or ``ROW_RING_MAX`` (ring) a warp, more rows
    taking more waves. Direct (``n_buf`` 0): at least ``ROW_DIRECT_MIN``
    rows a warp, blocks of ``ROW_DIRECT_WARPS`` warps, ``ROW_DIRECT_BLOCKS``
    an SM. Ring: a block an SM, its warps as many as the budget holds at
    the deepest ring (``max(RING_DEPTHS)`` rows of F a warp), so the same at
    every depth, and no more than spread the rows over every SM; a row too
    wide for ``n_buf`` of them in the budget raises."""
    if n_buf != 0 and n_buf not in RING_DEPTHS:
        raise ValueError(f"n_buf must be 0 or one of {RING_DEPTHS}, got {n_buf}")
    if min(r, f, sms) <= 0:
        raise ValueError(f"unsupported row gather: R={r}, F={f}, SMs={sms}")
    if n_buf == 0:
        warps = ROW_DIRECT_WARPS
        per_warp = min(max(-(-r // (sms * ROW_DIRECT_BLOCKS * warps)), ROW_DIRECT_MIN),
                       ROW_DIRECT_MAX)
        return RowPlan(-(-r // (per_warp * warps)), warps, per_warp, 0, 0)
    if n_buf * f * 4 > RING_BUDGET:
        raise ValueError(f"{n_buf} rows of F={f} exceed the block's {RING_BUDGET} bytes")
    warps = max(1, min(ROW_MAX_WARPS, RING_BUDGET // (max(RING_DEPTHS) * f * 4)))
    per_warp = min(-(-r // (sms * warps)), ROW_RING_MAX)
    n_warps = -(-r // per_warp)
    warps = min(warps, -(-n_warps // sms))  # every SM a block before any SM more warps
    return RowPlan(-(-n_warps // warps), warps, per_warp, row_tile(f, n_buf),
                   warps * n_buf * f * 4)


# ---- the kernels' wrappers and plain versions ----------------------------


def _card(*tensors) -> None:
    """Raise unless every tensor lies on one Hopper card and is contiguous."""
    dev = tensors[0].device
    for t in tensors:
        if t.device != dev:
            raise ValueError(f"operands on {t.device} and {dev}")
        if not t.is_contiguous():
            raise ValueError("operands must be contiguous")
    if torch.cuda.get_device_capability(dev) != (9, 0):
        raise RuntimeError(
            f"the kernels are built for sm_90a (Hopper); {torch.cuda.get_device_name(dev)} "
            f"is sm_{''.join(map(str, torch.cuda.get_device_capability(dev)))}")


def _sms(dev) -> int:
    return torch.cuda.get_device_properties(dev).multi_processor_count


def _ring_ready(x, n_buf: int) -> None:
    if n_buf not in RING_DEPTHS:
        raise ValueError(f"n_buf must be one of {RING_DEPTHS}, got {n_buf}")
    if x.shape[1] % 4 or x.data_ptr() % 16:
        raise ValueError("the ring copies 16-byte pieces: F % 4 == 0 and x 16-byte aligned")


def _lanes_per_chunk(f: int) -> int:
    """The gathered chunk sum's lanes a chunk: F rounded up to a power of two
    in [4, 32], so a narrow F shares a warp."""
    for lanes in (4, 8, 16):
        if f <= lanes:
            return lanes
    return 32


def _raise(lib, err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what} launch failed: {lib.hg_error_string(err).decode()}")


def _stream(dev):
    return torch.cuda.current_stream(dev).cuda_stream


def row_gather_plain(x, idx):
    return x.index_select(0, idx.long())


@profiling.kernel(lambda x, idx, n_buf=0: ("row_gather", (x, idx), 0))
def row_gather(x, idx, n_buf: int = 0):
    """``out[r] = x[idx[r]]``: x f32 [N, F], idx int32 [R] in [0, N), on
    the plan of :func:`row_plan`. ``n_buf`` 0 loads each row directly
    (float4 pieces where F % 4 == 0 and x is 16-byte aligned, else floats);
    4, 8 or 16 keeps that many rows a warp in flight through a ring in
    shared memory (F % 4 == 0 and x 16-byte aligned, else it raises)."""
    global row_gather_launches
    if x.device.type == "cpu":
        return row_gather_plain(x, idx)
    from hypergef_tpu_torch.ops import _build

    if x.dtype != torch.float32 or x.dim() != 2 or idx.dtype != torch.int32 or idx.dim() != 1:
        raise TypeError(f"need x f32 [N, F] and idx int32 [R], got {x.dtype} "
                        f"{tuple(x.shape)} and {idx.dtype} {tuple(idx.shape)}")
    _card(x, idx)
    if n_buf:
        _ring_ready(x, n_buf)
    r, f = idx.shape[0], x.shape[1]
    out = torch.empty((r, f), dtype=torch.float32, device=x.device)
    if r == 0:
        return out
    lib = _build.load_library()
    plan = row_plan(r, f, n_buf, _sms(x.device))
    with torch.cuda.device(x.device):
        err = lib.hg_row_gather(x.data_ptr(), idx.data_ptr(), out.data_ptr(), r, f, n_buf,
                                plan.blocks, plan.warps, plan.per_warp, plan.tile,
                                _stream(x.device))
    _raise(lib, err, "row_gather")
    row_gather_launches += 1
    return out


def chunk_masked_sum_plain(g, mask):
    """``acc = g[:, 0]·m0``, then ``acc = acc + g[:, k]·mk`` in order."""
    acc = g[:, 0] * mask[:, 0:1]
    for k in range(1, g.shape[1]):
        acc = acc + g[:, k] * mask[:, k : k + 1]
    return acc


@profiling.kernel(lambda g, mask: ("chunk_masked_sum", (g, mask), 2 * g.numel()))
def chunk_masked_sum(g, mask):
    """``out[c] = Σ_k g[c, k] · mask[c, k]``: g f32 [C, ngs, F], mask f32
    [C, ngs]; summed over k in order, as :func:`chunk_masked_sum_plain`."""
    global chunk_sum_launches
    if g.device.type == "cpu":
        return chunk_masked_sum_plain(g, mask)
    from hypergef_tpu_torch.ops import _build

    if (g.dtype != torch.float32 or mask.dtype != torch.float32 or g.dim() != 3
            or tuple(mask.shape) != tuple(g.shape[:2])):
        raise TypeError(f"need g f32 [C, ngs, F] and mask f32 [C, ngs], got {g.dtype} "
                        f"{tuple(g.shape)} and {mask.dtype} {tuple(mask.shape)}")
    _card(g, mask)
    c, ngs, f = g.shape
    out = torch.empty((c, f), dtype=torch.float32, device=g.device)
    lib = _build.load_library()
    with torch.cuda.device(g.device):
        err = lib.hg_chunk_masked_sum(g.data_ptr(), mask.data_ptr(), out.data_ptr(), c, ngs, f,
                                      _lanes_per_chunk(f), _stream(g.device))
    _raise(lib, err, "chunk_masked_sum")
    chunk_sum_launches += 1
    return out


@profiling.kernel(lambda x, gidx, mask, n_buf: (
    "chunk_masked_sum_ring", (x, gidx, mask), 2 * gidx.numel() * x.shape[1]))
def chunk_masked_sum_ring(x, gidx, mask, n_buf: int):
    """``out[c] = Σ_k x[gidx[c, k]] · mask[c, k]``: x f32 [N, F], gidx int32
    [C, ngs] in [0, N), mask f32 [C, ngs], with ``n_buf`` chunk slots a
    consumer warp in flight through the ring (:func:`ring_plan`); F % 4 == 0
    and x 16-byte aligned, since the producers copy rows in 16-byte pieces.
    Bitwise equal to the plain loop
    (:func:`~hypergef_tpu_torch.ops.ell_gather.ell_gather_sum_plain`)."""
    global chunk_sum_launches
    if x.device.type == "cpu":
        return ell_gather.ell_gather_sum_plain(x, gidx.long(), mask)
    from hypergef_tpu_torch.ops import _build

    if (x.dtype != torch.float32 or gidx.dtype != torch.int32 or mask.dtype != torch.float32
            or x.dim() != 2 or gidx.dim() != 2 or mask.shape != gidx.shape):
        raise TypeError(f"need x f32 [N, F], gidx int32 [C, ngs] and mask f32 [C, ngs], got "
                        f"{x.dtype} {tuple(x.shape)}, {gidx.dtype} {tuple(gidx.shape)}, "
                        f"{mask.dtype} {tuple(mask.shape)}")
    _card(x, gidx, mask)
    _ring_ready(x, n_buf)
    (c, ngs), f = gidx.shape, x.shape[1]
    out = torch.empty((c, f), dtype=torch.float32, device=x.device)
    lib = _build.load_library()
    plan = ring_plan(c, ngs, f, n_buf, _sms(x.device))
    with torch.cuda.device(x.device):
        err = lib.hg_chunk_sum_ring(x.data_ptr(), gidx.data_ptr(), mask.data_ptr(),
                                    out.data_ptr(), c, ngs, f, plan.blocks, plan.pairs,
                                    plan.slots, plan.per_pair, _stream(x.device))
    _raise(lib, err, "chunk_masked_sum (ring)")
    chunk_sum_launches += 1
    return out


@profiling.kernel(lambda x, s: ("scaled_copy", (x,), x.numel()))
def scaled_copy(x, s: float):
    """``out = x · s`` for a contiguous f32 ``x`` of any shape."""
    global scaled_copy_launches
    if x.device.type == "cpu":
        return x * s
    from hypergef_tpu_torch.ops import _build

    if x.dtype != torch.float32:
        raise TypeError(f"x must be f32, got {x.dtype}")
    _card(x)
    out = torch.empty_like(x)
    if x.data_ptr() % 16 or out.data_ptr() % 16:
        raise ValueError("x must be 16-byte aligned")
    if x.numel() == 0:
        return out
    lib = _build.load_library()
    with torch.cuda.device(x.device):
        err = lib.hg_scaled_copy(x.data_ptr(), out.data_ptr(), x.numel(), float(s),
                                 _stream(x.device))
    _raise(lib, err, "scaled_copy")
    scaled_copy_launches += 1
    return out


# ---- the probes -----------------------------------------------------------

_COUNTERS = {
    "row_gather": lambda: row_gather_launches,
    "chunk_masked_sum": lambda: chunk_sum_launches,
    "scaled_copy": lambda: scaled_copy_launches,
    "ell_gather_sum": lambda: ell_gather.launches,
    "gather_segment_sum": lambda: segment_sum.launches,
}


class _Probe:
    """Runs the cases of one script on one device and collects the rows."""

    def __init__(self, device, timed: bool):
        self.device = torch.device(device)
        self.timed = timed
        self.rows: List[Dict] = []

    def t(self, a, dtype=None):
        return torch.as_tensor(np.ascontiguousarray(a), dtype=dtype, device=self.device)

    def index(self, a, n: int):
        """int32 indices on the device, checked against N here, once."""
        a = np.asarray(a)
        if a.size and (a.min() < 0 or a.max() >= n):
            raise ValueError(f"indices must lie in [0, {n})")
        return self.t(a.astype(np.int32))

    def moved(self, rows, f: int, *tables, out_rows: int = 0) -> Optional[int]:
        """The bytes a case must move, where it is timed: the distinct x rows
        that ``rows`` names, of ``f`` f32 features, each read once, its
        ``tables`` read once and ``out_rows`` f32 rows written once."""
        if not self.timed:
            return None
        named = int(np.unique(np.asarray(rows)).size) if rows is not None else 0
        return (named + out_rows) * f * 4 + sum(int(np.asarray(t).nbytes) for t in tables)

    def case(self, case: str, kernel: str, run: Callable, want: np.ndarray, exact: bool,
             library: Optional[Callable] = None, **extra) -> Dict:
        count = _COUNTERS[kernel]
        before = count()
        got = run()
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        launches = count() - before
        got = got.cpu().numpy()
        want = np.asarray(want, dtype=np.float32)
        if got.shape != want.shape:
            raise ValueError(f"{case}: shape {got.shape}, oracle {want.shape}")
        err = float(np.abs(got - want).max()) if got.size else 0.0
        if exact:
            ok = bool(np.array_equal(got, want))
        else:
            scale = float(np.abs(want).max()) if want.size else 0.0
            ok = bool(np.allclose(got, want, rtol=1e-5, atol=1e-5 * scale))
        ms = library_ms = None
        if self.timed:
            from hypergef_tpu_torch.utils.timing import cuda_time_ms

            ms = cuda_time_ms(run, repeats=20, iters=10)
            if library is not None:
                library_ms = cuda_time_ms(library, repeats=20, iters=10)
        row = {"case": case, "kernel": kernel, "ok": ok, "max_abs_err": err, "ms": ms,
               "library_ms": library_ms, "launches": launches, **extra}
        self.rows.append(row)
        return row

    def gathers(self, name, x, idx_np, want, depths=(0,) + RING_DEPTHS):
        """Row-gather cases: ``direct`` and each ring depth."""
        idx = self.index(idx_np, x.shape[0])
        idx_long = idx.long()
        moved = self.moved(idx_np, x.shape[1], idx.cpu(), out_rows=idx.shape[0])
        for nb in depths:
            label = "direct" if nb == 0 else f"ring n_buf={nb}"
            self.case(f"{name} {label}", "row_gather", lambda nb=nb: row_gather(x, idx, nb), want,
                      True, lambda: x.index_select(0, idx_long), moved_bytes=moved)

    def ell(self, name, x, gidx_np, mask_np, want):
        """An ELL level-0 stage with x resident: the gather kernel."""
        n = x.shape[0]
        gidx = self.index(gidx_np, n)
        table = GatherTable(gidx=gidx, gidx_long=gidx.long(), mask=self.t(mask_np, torch.float32),
                            num_inputs=n)
        csr = _chunk_csr(table.gidx_long, table.mask, n) if self.timed else None
        moved = self.moved(gidx_np, x.shape[1], gidx.cpu(), np.asarray(mask_np, np.float32),
                           out_rows=gidx.shape[0])
        self.case(name, "ell_gather_sum", lambda: ell_gather.ell_gather_sum(x, table), want,
                  False, lambda: torch.sparse.mm(csr, x), moved_bytes=moved)

    def ring_sums(self, name, x, gidx_np, mask_np, want, depths=RING_DEPTHS):
        """The chunk sum from x and a gather table through the ring."""
        n = x.shape[0]
        gidx = self.index(gidx_np, n)
        mask = self.t(mask_np, torch.float32)
        csr = _chunk_csr(gidx.long(), mask, n) if self.timed else None
        moved = self.moved(gidx_np, x.shape[1], gidx.cpu(), mask.cpu(), out_rows=gidx.shape[0])
        for nb in depths:
            self.case(f"{name} n_buf={nb}", "chunk_masked_sum",
                      lambda nb=nb: chunk_masked_sum_ring(x, gidx, mask, nb), want, False,
                      lambda: torch.sparse.mm(csr, x), moved_bytes=moved)

    def chunk_sum(self, name, g_np, mask_np, want, **extra):
        g, mask = self.t(g_np, torch.float32), self.t(mask_np, torch.float32)
        self.case(name, "chunk_masked_sum", lambda: chunk_masked_sum(g, mask), want, False,
                  lambda: torch.einsum("cgf,cg->cf", g, mask), **extra)

    def segment_sum(self, name, g_np, seg_np, ts: int):
        """A one-hot sorted segment sum into ``ts`` segments: the segment-sum
        kernel with the identity gather; oracle ``np.add.at``."""
        g = self.t(g_np, torch.float32)
        indptr = np.searchsorted(np.asarray(seg_np), np.arange(ts + 1), side="left")
        table = segment_sum.SegmentTable.build(indptr, None, g.shape[0], self.device)
        lengths = table.indptr_long[1:] - table.indptr_long[:-1]
        want = np.zeros((ts, g_np.shape[1]), np.float32)
        np.add.at(want, np.asarray(seg_np), np.asarray(g_np))
        self.case(name, "gather_segment_sum", lambda: segment_sum.gather_segment_sum(g, table),
                  want, False, lambda: torch.segment_reduce(g, "sum", lengths=lengths))


def _chunk_csr(gidx_long, mask, n: int):
    """The chunk table as a CSR matrix [C, N] of its mask (live slots only),
    for ``torch.sparse.mm``."""
    c = torch.arange(gidx_long.shape[0], device=mask.device)[:, None].expand_as(gidx_long)
    live = mask != 0
    coo = torch.sparse_coo_tensor(torch.stack([c[live], gidx_long[live]]), mask[live],
                                  (gidx_long.shape[0], n), check_invariants=True)
    return coo.coalesce().to_sparse_csr()


def _ell_oracle(x, gidx, mask):
    """``scripts/probe_r2_gather.py:295``."""
    c, ngs = gidx.shape
    return (x[gidx.reshape(-1)].reshape(c, ngs, -1) * mask[:, :, None]).sum(1)


# the scales of scripts/probe_r2_gather.py:272-282: (N, nnz, F)
R2_SCALES = {"tiny": (1024, 32_768, 32), "pubmed": (19_968, 86_016, 64),
             "big": (2_000_000, 9_998_336, 32)}


def probe_r2_gather(device, timed: bool = False, scales=None) -> List[Dict]:
    """``scripts/probe_r2_gather.py``: an ELL level-0 stage at each scale,
    ``pallas_vmem_stage`` (``:109``) on the gather kernel and
    ``pallas_dma_stage`` (``:168``, ``n_buf`` 4, 8, 16) on the chunk-sum
    ring; and the flat row gather of the nnz rows (the script's
    ``xla_gather`` case), direct and through each ring depth."""
    p = _Probe(device, timed)
    for scale, (n, nnz, f) in (scales or R2_SCALES).items():
        c = nnz // NGS
        rng = np.random.default_rng(0)  # build_case(n, nnz, f, seed=0), :218-231
        gidx = rng.integers(0, n, size=(c, NGS)).astype(np.int32)
        gmask = (rng.random((c, NGS)) > 0.1).astype(np.float32)
        xn = rng.normal(size=(n, f)).astype(np.float32)
        oracle = _ell_oracle(xn, gidx, gmask)
        x = p.t(xn)
        p.ell(f"{scale} pallas_vmem", x, gidx, gmask, oracle)
        p.ring_sums(f"{scale} pallas_dma", x, gidx, gmask, oracle)
        del oracle
        flat = gidx.reshape(-1)
        p.gathers(f"{scale} xla_gather", x, flat, xn[flat])
    return p.rows


def probe_r2b_bisect(device, timed: bool = False) -> List[Dict]:
    """``scripts/probe_r2b_bisect.py`` (F 128, N 1024, T 64, NGS 8), one row
    per construct, with the script's data (``:38-41``): k0 the blocked
    scaled copy; k1-k4 and k6 row gathers (the DMA forms through the ring);
    k5 the two-buffer sum as a chunk sum of ngs 2; k7-k10 the masked 8-row
    sum with x resident, on the gather kernel (k8-k10 tables drawn from
    seeded generators of their own: the script draws them from its shared
    generator in call order)."""
    f, n, t = 128, 1024, 64
    p = _Probe(device, timed)
    rng = np.random.default_rng(0)
    xn = rng.normal(size=(n, f)).astype(np.float32)
    idx = rng.integers(0, n, size=(t, NGS)).astype(np.int32)
    mask = (rng.random((t, NGS)) > 0.1).astype(np.float32)
    x = p.t(xn)
    p.case("k0 x*2", "scaled_copy", lambda: scaled_copy(x, 2.0), xn * np.float32(2.0), True,
           lambda: torch.mul(x, 2.0), moved_bytes=p.moved(None, f, xn, out_rows=n))
    bcast = [idx[0, 0]] * 8
    p.gathers("k1 one-row broadcast", x, bcast, xn[bcast], depths=(0,))
    p.gathers("k1b one-row broadcast", x, bcast, xn[bcast], depths=(0,))
    p.gathers("k2 static 8 rows", x, np.arange(8), xn[0:8], depths=(4,))
    r = int(idx[0, 0])
    p.gathers("k3 8 rows at a dynamic offset", x, np.arange(r, r + 8), xn[r:r + 8], depths=(4,))
    one = [idx[0, 1]] * 8
    p.gathers("k4 single-row copy", x, one, xn[one], depths=(4,))
    pair = np.stack([idx[0, :2], idx[1, :2]], axis=1)  # out[k] = x[idx[0,k]] + x[idx[1,k]]
    p.ring_sums("k5 two buffers", x, pair, np.ones((2, 2), np.float32),
                xn[idx[0, :2]] + xn[idx[1, :2]], depths=(4,))
    p.gathers("k6 one copy a chunk", x, idx[:, 0], xn[idx[:, 0]], depths=(4,))
    for name in ("k7 serial masked sum", "k7b concatenated masked sum"):
        p.ell(name, x, idx, mask, _ell_oracle(xn, idx, mask))
    for tb in (128, 256, 512):
        for mv in (False, True):
            g = np.random.default_rng(tb)
            i = g.integers(0, n, size=(tb, NGS)).astype(np.int32)
            m = (g.random((tb, NGS)) > 0.1).astype(np.float32)
            p.ell(f"k8_t{tb}_mv{int(mv)}", x, i, m, _ell_oracle(xn, i, m))
    for name, t_blk, n_grid in (("k9_g4", 64, 4), ("k9_g16_t128", 128, 16),
                                ("k11_g4_t512", 512, 4), ("k11_g4_t256", 256, 4)):
        g = np.random.default_rng(t_blk * n_grid)
        i = g.integers(0, n, size=(t_blk * n_grid, NGS)).astype(np.int32)
        m = (g.random((t_blk * n_grid, NGS)) > 0.1).astype(np.float32)
        p.ell(name, x, i, m, _ell_oracle(xn, i, m))
    for n_big in (19968, 8192):
        g = np.random.default_rng(n_big)
        xb = g.normal(size=(n_big, 64)).astype(np.float32)
        i = g.integers(0, n_big, size=(256, NGS)).astype(np.int32)
        m = (g.random((256, NGS)) > 0.1).astype(np.float32)
        p.ell(f"k10_n{n_big}", p.t(xb), i, m, _ell_oracle(xb, i, m))
    return p.rows


def pallas_probe(device, timed: bool = False) -> List[Dict]:
    """``scripts/pallas_probe.py`` (N 4096, F 128, R 4096), its data in its
    order (``:35-37``, ``:199-210``) and its oracles (``:189-214``): K1 and
    K2 row gathers direct, K4 through the ring at 8 rows in flight, K3 the
    one-hot segment sum into 256 segments, K6 the masked chunk sum."""
    n, f, r, ts = 4096, 128, 4096, 256
    p = _Probe(device, timed)
    rng = np.random.default_rng(0)
    xn = rng.normal(size=(n, f)).astype(np.float32)
    idx = rng.integers(0, n, size=r).astype(np.int32)
    x = p.t(xn)
    p.gathers("K1 take in kernel", x, idx, xn[idx], depths=(0,))
    p.gathers("K2 fori dynamic-slice", x, idx, xn[idx], depths=(0,))
    seg = np.sort(rng.integers(0, ts, size=r)).astype(np.int32)
    g = rng.normal(size=(r, f)).astype(np.float32)
    p.segment_sum("K3 one-hot segment sum", g, seg, ts)
    p.gathers("K4 DMA row pipeline", x, idx, xn[idx], depths=(8,))
    c = r // NGS
    ge = rng.normal(size=(c, NGS, f)).astype(np.float32)
    me = (rng.random((c, NGS)) > 0.3).astype(np.float32)
    p.chunk_sum("K6 ELL einsum partials", ge, me, np.einsum("cgf,cg->cf", ge, me))
    return p.rows


def pallas_probe2(device, timed: bool = False) -> List[Dict]:
    """``scripts/pallas_probe2.py`` (N 4096, F 128, R 4096), its data in its
    order (``:36-39``, ``:142``, ``:166``): B and C row gathers direct, D
    through the ring at 16 rows in flight, E the masked chunk sum of
    ``x0`` as [C, 8, F] and G the one-hot segment sum of ``x0[:R]`` into 256
    segments. The script's E (``e_call``, ``:150-157``) passes no mask to a
    kernel that reads one, so it cannot run as written; the port passes the
    mask defined at ``:142``."""
    n, f, r, ts = 4096, 128, 4096, 256
    p = _Probe(device, timed)
    rng = np.random.default_rng(0)
    xn = rng.normal(size=(n, f)).astype(np.float32)
    idx = rng.integers(0, n, size=r).astype(np.int32)
    c = r // NGS
    mask = (rng.random((c, NGS)) > 0.3).astype(np.float32)
    seg = np.sort(rng.integers(0, ts, size=r)).astype(np.int32)
    x = p.t(xn)
    p.gathers("B take_along_axis", x, idx, xn[idx], depths=(0,))
    p.gathers("C serial slice", x, idx, xn[idx], depths=(0,))
    p.gathers("D DMA pipeline", x, idx, xn[idx], depths=(16,))
    g = xn[:r].reshape(c, NGS, f)
    p.chunk_sum("E chunk masked sum", g, mask, np.einsum("cgf,cg->cf", g, mask),
                note="the script's e_call passes no mask (broken as written); the mask of "
                     ":142 is passed here")
    p.segment_sum("G one-hot segment sum", xn[:r], seg, ts)
    return p.rows


def pallas_probe3(device, timed: bool = False) -> List[Dict]:
    """``scripts/pallas_probe3.py`` at pubmed scale (NNZ 85,024, F 32, N
    19,717), its data in its order (``:37-44``, ``:53``, ``:98-99``): the
    flat take of nnz rows (a row gather, direct and through each ring
    depth), ``e_call`` the masked chunk sum of [10,628, 8, 32] and
    ``oh_call`` the one-hot segment sum at TS 8, R 64 (oracle ``:117-118``)."""
    nnz, f, n = 85_024, 32, 19_717
    c = nnz // NGS
    p = _Probe(device, timed)
    rng = np.random.default_rng(0)
    xn = rng.normal(size=(n, f)).astype(np.float32)
    idx = rng.integers(0, n, size=nnz).astype(np.int32)
    mask = (rng.random((c, NGS)) > 0.2).astype(np.float32)
    c1 = (c + 7) // 8
    rng.integers(0, c, size=(c1, 8))  # the tree tables of :43-44, drawn to keep the order
    rng.random((c1, 8))
    g0 = rng.normal(size=(nnz, f)).astype(np.float32)
    seg_s = np.sort(rng.integers(0, 8, size=64)).astype(np.int32)
    g_s = rng.normal(size=(64, f)).astype(np.float32)
    x = p.t(xn)
    p.gathers("take F=32 nnz=85k", x, idx, xn[idx])
    g = g0.reshape(c, NGS, f)
    p.chunk_sum("e_call chunk-sum", g, mask, np.einsum("cgf,cg->cf", g, mask))
    p.segment_sum("oh_call one-hot TS=8 R=64", g_s, seg_s, 8)
    return p.rows


PROBES = {"probe_r2_gather": probe_r2_gather, "probe_r2b_bisect": probe_r2b_bisect,
          "pallas_probe": pallas_probe, "pallas_probe2": pallas_probe2,
          "pallas_probe3": pallas_probe3}
